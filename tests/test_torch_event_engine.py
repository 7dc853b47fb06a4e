"""The port's event engine on the CPU.

``repro_torch.runtime.sim.simulate_run`` is a copy of the reference's and
draws from ``np.random.default_rng(cfg.seed)``, so on the same policy,
workload and config it must give the reference's ``RunStats`` field for
field: over policies x workloads x schedules, in a noisy environment, and
with several Rx queues under each dispatcher and assignment.  Then the 15
tests of ``tests/test_core_simulator.py`` (the simulator against the
paper's analytics, Fig 5 / Sec 5) through the port's copy of the
deprecated ``core.simulator`` surface, and
``test_serving.py::test_server_replay_schedules_a_nonstationary_request_stream``
through the port's ``Server.replay``."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.core.controller as ref_controller
import repro.runtime as ref_rt
import repro_torch.core.controller as port_controller
import repro_torch.runtime as port_rt
from repro_torch.core import analytics as an
from repro_torch.core.simulator import (
    HR_SLEEP_MODEL,
    NANOSLEEP_MODEL,
    PERFECT_SLEEP_MODEL,
    SimConfig,
    simulate,
    simulate_busy_poll,
)

SIDES = ((ref_rt, ref_controller), (port_rt, port_controller))


def _plain(x):
    """A structure of builtins for equality: dataclasses by field, arrays
    and reservoirs by value, NaN equal to NaN."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if hasattr(x, "_buf") and hasattr(x, "capacity"):          # Reservoir
        return ("reservoir", x.capacity, x.count, _plain(list(x._buf)))
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, _plain(x.tolist()))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def _policy(rt, ctl, kind):
    if kind == "metronome":
        return rt.MetronomePolicy(ctl.MetronomeConfig(m=3, v_target_us=10.0,
                                                      t_long_us=500.0))
    if kind == "metronome-static":
        return rt.MetronomePolicy(ctl.MetronomeConfig(m=2, v_target_us=25.0,
                                                      t_long_us=300.0), adaptive=False)
    if kind == "equal-timeouts":
        return rt.EqualTimeoutsPolicy(ctl.MetronomeConfig(m=3, v_target_us=10.0,
                                                          t_long_us=500.0))
    if kind == "fixed-period":
        return rt.FixedPeriodPolicy(period_us=20.0, threads=2)
    return rt.BusyPollPolicy()


def _workload(rt, kind):
    if kind == "poisson":
        return rt.PoissonWorkload(0.45 * 29.76)
    if kind == "cbr":
        return rt.CBRWorkload(6.0)
    return rt.OnOffBurstyWorkload(20.0)


def _schedule(rt, kind):
    if kind == "step":
        return rt.StepSchedule(times_us=(0.0, 4_000.0), scales=(0.4, 1.2))
    if kind == "sinusoid":
        return rt.SinusoidSchedule(period_us=3_000.0, amplitude=0.3, mean=0.8)
    if kind == "mmpp":
        return rt.MMPPSchedule(states=(0.3, 1.0), mean_dwell_us=1_500.0, seed=5)
    return None


def _dispatcher(rt, kind):
    return {"round-robin": rt.RoundRobinDispatch, "flow-hash": rt.FlowHashDispatch,
            "least-loaded": rt.LeastLoadedDispatch,
            "weighted": lambda: rt.WeightedDispatch((3.0, 1.0, 1.0)),
            "stale-least-loaded": lambda: rt.StaleLeastLoadedDispatch(refresh_every=8),
            }[kind]()


def _assignment(rt, kind):
    return {"shared": rt.SharedAssignment, "dedicated": rt.DedicatedAssignment,
            "stealing": rt.StealingAssignment}[kind]()


def _both(policy, workload, schedule, env=None, dispatcher=None, assignment=None):
    """(reference RunStats, port RunStats) for one case, 8 ms of traffic."""
    out = []
    for rt, ctl in SIDES:
        cfg = rt.SimRunConfig(duration_us=8_000.0, seed=3, schedule=_schedule(rt, schedule),
                              window_us=1_000.0 if schedule else 0.0, **(env or {}))
        kw = {}
        if dispatcher:
            kw["dispatcher"] = _dispatcher(rt, dispatcher)
        if assignment:
            kw["assignment"] = _assignment(rt, assignment)
        out.append(rt.simulate_run(_policy(rt, ctl, policy), _workload(rt, workload), cfg,
                                   **kw))
    return out


@pytest.mark.parametrize("schedule", [None, "step", "sinusoid", "mmpp"])
@pytest.mark.parametrize("workload", ["poisson", "cbr", "bursty"])
@pytest.mark.parametrize("policy", ["metronome", "metronome-static", "equal-timeouts",
                                    "fixed-period", "busy-poll"])
def test_simulate_run_equals_reference(policy, workload, schedule):
    ref, port = _both(policy, workload, schedule)
    assert ref.offered > 0
    assert _plain(port) == _plain(ref)


NOISY = dict(interference_prob=0.25, interference_mean_us=20.0,
             stall_rate_per_us=1.0 / 2000.0, stall_mean_us=150.0, queue_capacity=256,
             timeseries_bin_us=1_000.0)


@pytest.mark.parametrize("policy", ["metronome", "equal-timeouts", "busy-poll"])
def test_simulate_run_equals_reference_on_a_noisy_host(policy):
    ref, port = _both(policy, "poisson", "step", NOISY)
    assert ref.dropped > 0 or ref.busy_tries > 0
    assert _plain(port) == _plain(ref)


@pytest.mark.parametrize("assignment", ["shared", "dedicated", "stealing"])
@pytest.mark.parametrize("dispatcher", ["round-robin", "flow-hash", "least-loaded",
                                        "weighted", "stale-least-loaded"])
def test_simulate_run_equals_reference_with_three_queues(dispatcher, assignment):
    ref, port = _both("metronome", "poisson", "step", dict(n_queues=3), dispatcher,
                      assignment)
    assert len(ref.per_queue) == 3 and all(q.serviced > 0 for q in ref.per_queue)
    assert _plain(port) == _plain(ref)


# -- tests/test_core_simulator.py on the port ----------------------------------

def _base(**kw):
    d = dict(duration_us=300_000.0, seed=7)
    d.update(kw)
    return SimConfig(**d)


def test_decorrelation_pdf_matches_eq9():
    """Paper Fig 5: empirical vacation PDF ~= analytic Eq (9), T_L = T_S.

    Run at line rate: the paper's own justification for decorrelation is
    that "each service time, due to its random duration, de-synchronizes"
    the threads — with negligible traffic there are no service times and
    thread phases can lock (we verified the simulator shows exactly that
    synchronized regime at lambda ~ 0).
    """
    ts = 50.0
    m = 3
    cfg = _base(adaptive=False, equal_timeouts=True, v_target_us=ts,
                sleep_model=HR_SLEEP_MODEL, m=m,
                arrival_rate_mpps=14.88, duration_us=900_000.0)
    res = simulate(cfg)
    v = res.vacations_us
    v = v[(v > 0) & (v < ts)]
    assert v.size > 2000
    hist, edges = np.histogram(v, bins=20, range=(0, ts), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    pdf = an.vacation_pdf_high(centers, ts, ts, m)     # Eq (9), T_L = T_S
    err = np.abs(hist - pdf) / pdf.max()
    assert np.median(err) < 0.2


def test_mean_vacation_low_load():
    """At rho->0 all threads stay primary: E[V] ~ T_S/M (Eq 8)."""
    ts = 30.0
    cfg = _base(adaptive=False, v_target_us=ts, m=3,
                arrival_rate_mpps=0.001, sleep_model=PERFECT_SLEEP_MODEL)
    res = simulate(cfg)
    assert res.mean_vacation_us == pytest.approx(an.mean_vacation_low(ts, 3), rel=0.1)


def test_mean_vacation_high_load():
    """At high load: one primary + M-1 backups -> Eq (6)."""
    ts, tl, m = 10.0, 500.0, 3
    cfg = _base(adaptive=False, v_target_us=ts, t_long_us=tl, m=m,
                arrival_rate_mpps=14.88, service_rate_mpps=29.76,
                sleep_model=PERFECT_SLEEP_MODEL)
    res = simulate(cfg)
    assert res.mean_vacation_us == pytest.approx(
        an.mean_vacation_high(ts, tl, m), rel=0.15)


def test_rho_estimate_tracks_true_load():
    cfg = _base(adaptive=True, arrival_rate_mpps=14.88, service_rate_mpps=29.76,
                timeseries_bin_us=50_000.0)
    res = simulate(cfg)
    true_rho = 14.88 / 29.76
    assert res.rho_series[-1] == pytest.approx(true_rho, abs=0.08)


def test_adaptive_targets_constant_vacation():
    """Eq (12) keeps E[V] *flat across loads* near the target.

    The paper's own Table 2 measures V ~= 2x the target (19.55us @ 10us) —
    the idealized Eq (13) model misses sleep overshoot and role churn
    (collisions knock threads into T_L sleeps), and our simulator
    reproduces that measured 2x factor.  So we assert what the mechanism
    actually provides: the measured mean vacation stays within a narrow
    band (<= 2.5x target, like the paper's measurements) while the offered
    load varies 14x, instead of scaling with T_S (which varies 3x over the
    same range).
    """
    means = []
    for lam in (1.0, 7.0, 14.0):
        cfg = _base(adaptive=True, v_target_us=10.0, arrival_rate_mpps=lam,
                    service_rate_mpps=29.76, sleep_model=HR_SLEEP_MODEL)
        res = simulate(cfg)
        means.append(res.mean_vacation_us)
        assert 0.8 * 10.0 <= res.mean_vacation_us <= 2.5 * 10.0, (lam, means)
    assert max(means) / min(means) < 1.6, means


def test_no_loss_at_paper_operating_point():
    """Paper Table 2: V-bar=10us, 1024 descriptors, line rate -> ~0 loss."""
    cfg = _base(adaptive=True, v_target_us=10.0, arrival_rate_mpps=14.88,
                service_rate_mpps=29.76, sleep_model=HR_SLEEP_MODEL)
    res = simulate(cfg)
    assert res.loss_fraction < 1e-4
    assert res.serviced > 0.99 * res.offered * (1 - res.loss_fraction)


def test_nanosleep_causes_loss_at_line_rate():
    """Paper Table 3: same config on nanosleep loses packets (~6% in paper)."""
    cfg = _base(adaptive=True, v_target_us=10.0, arrival_rate_mpps=14.88,
                service_rate_mpps=29.76, sleep_model=NANOSLEEP_MODEL)
    res = simulate(cfg)
    assert res.loss_fraction > 0.005


def test_loss_grows_with_vacation_target():
    """Paper Table 2 trend: larger V-bar -> larger backlog N_V, more loss."""
    losses, nvs = [], []
    for v in (5.0, 10.0, 20.0, 40.0):
        cfg = _base(adaptive=True, v_target_us=v, arrival_rate_mpps=14.88,
                    service_rate_mpps=29.76, queue_capacity=1024)
        r = simulate(cfg)
        losses.append(r.loss_fraction)
        nvs.append(r.mean_nv)
    # N_V grows with the target until the queue capacity clamps it.
    uncapped = [n for n in nvs if n < 0.9 * 1024]
    assert uncapped == sorted(uncapped) and len(uncapped) >= 3
    assert losses[-1] > losses[0]
    assert losses[0] < 1e-3                     # small target: (near) no loss


def test_cpu_scales_with_load_and_beats_busy_poll():
    """Paper Fig 12b: CPU ~ load; busy-poll is pinned at 100%."""
    fracs = []
    for lam in (0.5, 7.0, 14.0):
        cfg = _base(adaptive=True, arrival_rate_mpps=lam, service_rate_mpps=29.76)
        fracs.append(simulate(cfg).cpu_fraction)
    assert fracs == sorted(fracs)
    assert fracs[-1] < 1.0                       # < one full core even at line rate
    bp = simulate_busy_poll(_base(arrival_rate_mpps=14.0))
    assert bp.cpu_fraction == 1.0
    assert fracs[0] < 0.35 * bp.cpu_fraction


def test_equal_timeouts_waste_cpu_at_high_load():
    """Paper Fig 7 motivation: T_L=T_S burns wakeups on busy tries."""
    eq = simulate(_base(equal_timeouts=True, adaptive=False, v_target_us=10.0,
                        arrival_rate_mpps=14.88, service_rate_mpps=29.76))
    dv = simulate(_base(equal_timeouts=False, adaptive=False, v_target_us=10.0,
                        arrival_rate_mpps=14.88, service_rate_mpps=29.76))
    assert eq.busy_tries > 3 * max(dv.busy_tries, 1)


def test_busy_tries_fall_with_longer_tl():
    """Paper Fig 7: busy tries decrease monotonically with T_L."""
    tries = []
    for tl in (100.0, 300.0, 500.0, 700.0):
        cfg = _base(adaptive=False, t_long_us=tl, arrival_rate_mpps=14.88,
                    service_rate_mpps=29.76)
        tries.append(simulate(cfg).busy_tries)
    assert tries == sorted(tries, reverse=True)


def test_multithread_resilience_to_interference():
    """Paper Sec 5.6: under OS interference, M=3 loses less than M=1."""
    kw = dict(adaptive=True, arrival_rate_mpps=14.88, service_rate_mpps=29.76,
              interference_prob=0.3, interference_mean_us=300.0,
              queue_capacity=512, duration_us=400_000.0)
    one = simulate(_base(m=1, **kw))
    three = simulate(_base(m=3, **kw))
    assert three.loss_fraction < one.loss_fraction


def test_uncorrelated_tails_absorbed_but_correlated_stalls_are_not():
    """The Table-3 modeling discovery: backup threads absorb uncorrelated
    per-thread delay tails (bounded loss growth with queue size), while
    correlated system-wide stalls overflow even a 4x larger ring — the
    paper's nanosleep failure mode (Sec 3.1)."""
    import dataclasses
    base = dict(adaptive=True, v_target_us=10.0, arrival_rate_mpps=14.88,
                service_rate_mpps=29.76, duration_us=800_000.0)
    tails = dataclasses.replace(HR_SLEEP_MODEL, tail_prob=0.01,
                                tail_mean_us=400.0)
    # uncorrelated tails: big ring nearly eliminates loss
    small_u = simulate(_base(sleep_model=tails, queue_capacity=1024, **base))
    big_u = simulate(_base(sleep_model=tails, queue_capacity=4096, **base))
    assert big_u.loss_fraction < 0.25 * max(small_u.loss_fraction, 1e-9) \
        or big_u.loss_fraction < 1e-4
    # correlated stalls: 4x ring barely helps
    small_c = simulate(_base(sleep_model=HR_SLEEP_MODEL, queue_capacity=1024,
                             stall_rate_per_us=3.5e-5, stall_mean_us=1200.0,
                             **base))
    big_c = simulate(_base(sleep_model=HR_SLEEP_MODEL, queue_capacity=4096,
                           stall_rate_per_us=3.5e-5, stall_mean_us=1200.0,
                           **base))
    assert big_c.loss_fraction > 0.3 * small_c.loss_fraction
    assert big_c.loss_fraction > 0.005


def test_adaptation_tracks_time_varying_load():
    """Paper Fig 11: rho and T_S follow a ramp-up/ramp-down profile."""
    peak = 14.0
    dur = 600_000.0

    def profile(t):
        x = t / dur
        return peak * (2 * x if x < 0.5 else 2 * (1 - x))

    cfg = _base(adaptive=True, arrival_profile=profile, duration_us=dur,
                service_rate_mpps=29.76, timeseries_bin_us=20_000.0)
    res = simulate(cfg)
    mid = len(res.rho_series) // 2
    # rho climbs into the peak and falls after it; T_S does the opposite.
    assert res.rho_series[mid] > res.rho_series[2] + 0.1
    assert res.rho_series[mid] > res.rho_series[-2] + 0.1
    assert res.ts_series[2] > res.ts_series[mid]
    # throughput tracks offered load (no systematic loss)
    assert res.serviced > 0.98 * (res.offered - res.dropped)


def test_paper_config_operating_point():
    """The paper's own Sec-5 configuration (configs/metronome_l3fwd.py)
    must hit its published operating point: no loss at line rate, CPU well
    below one core."""
    import dataclasses

    from repro_torch.configs.metronome_l3fwd import PAPER_SIM

    res = simulate(dataclasses.replace(PAPER_SIM, duration_us=400_000.0,
                                       seed=11))
    assert res.loss_fraction < 1e-4
    assert res.cpu_fraction < 0.75
    assert 10.0 <= res.mean_vacation_us <= 25.0   # paper measured 19.55


# -- tests/test_serving.py:207 on the port's Server ----------------------------

def test_server_replay_schedules_a_nonstationary_request_stream():
    """Server.replay drives live serving from a Workload x LoadSchedule
    pair: everything submitted is served, and the stats carry the
    schedule descriptor so live runs line up with simulated ones."""
    from repro_torch.configs import get_config
    from repro_torch.core import MetronomeConfig
    from repro_torch.models import Model
    from repro_torch.runtime import MetronomePolicy, PoissonWorkload, StepSchedule
    from repro_torch.serving import EngineConfig, InferenceEngine, Request, Server

    model = Model(get_config("gemma-2b").reduced(), device="cpu")
    eng = InferenceEngine(model, model.init(torch.Generator().manual_seed(0)),
                          EngineConfig(max_slots=4, max_len=64, prefill_buckets=(8, 16)))
    srv = Server(eng, MetronomePolicy(MetronomeConfig(
        m=2, v_target_us=1_000.0, t_long_us=20_000.0)))
    # ~60 requests over 0.3s, rate stepping up 3x halfway through
    sched = StepSchedule(times_us=(0.0, 150_000.0), scales=(0.5, 1.5))
    stats = srv.replay(
        PoissonWorkload(0.0002), duration_us=300_000.0, schedule=sched,
        make_request=lambda i: Request(prompt=[1, 2, 3], max_new_tokens=2))
    assert stats.backend == "server"
    assert stats.schedule.startswith("step[")
    assert stats.workload.startswith("poisson")
    assert stats.offered > 0
    assert stats.items == stats.offered - stats.dropped
    assert stats.dropped == 0
