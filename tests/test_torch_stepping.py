"""tests/test_stepping.py on the port: both steppings of the port's
batched engine (the plain versions of the ``slot_sweep`` and
``adaptive_sweep`` kernels on the CPU): time accounting invariants, the
event-jump sweep's far fewer steps at low load, the slot-count ladder,
nearby durations on one rung, and the refusal of an unknown mode, by the
batched engine and by the fleet engine, and the fleet's event-jump
stepping against its fixed one in the reference's quiet bands.  The
reference's compile cache has no counterpart (nothing is compiled per
shape).  The plain sweeps run ~10^4 slots (or event-jump steps) a second on
the CPU, so sweeps of 20-60 ms run 2-20 ms here (each names its cut) with
the reference's checks; the fleet's parity case keeps its 30 ms.
"""

import numpy as np
import pytest
import torch

from repro_torch.runtime import SimRunConfig, SweepGrid, simulate_batch
from repro_torch.runtime.batched import bucket_steps
from repro_torch.runtime.simcore import HR_SLEEP_MODEL

INTERFERENCE_ENV = dict(interference_prob=0.25, interference_mean_us=20.0,
                        stall_rate_per_us=1.0 / 4000.0,
                        stall_mean_us=150.0)
STEPPINGS = ("fixed", "adaptive")

# f32 accumulators drift ~1e-4 relative over 1e5 slots; the conservation
# law must hold far tighter than any physical effect but not bit-exactly
CONS_REL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain sweeps' small tensors gain nothing from intra-op threads;
    one keeps a parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed_grid(n=10, seed=3, interference=False):
    rng = np.random.default_rng(seed)
    pts = []
    for i in range(n):
        t_s = float(rng.uniform(5.0, 50.0))
        pts.append(dict(
            t_s_us=t_s,
            t_l_us=float(t_s * rng.uniform(4.0, 20.0)),
            m=int(rng.integers(1, 5)),
            n_queues=int(rng.integers(1, 4)),
            rate_mpps=float(rng.uniform(0.1, 0.8) * 29.76),
            seed=1000 + i))
    env = INTERFERENCE_ENV if interference else {}
    # 6 ms (the reference runs 30)
    cfg = SimRunConfig(duration_us=6_000.0, sleep_model=HR_SLEEP_MODEL,
                       window_us=1_000.0, **env)
    return SweepGrid.of_points(pts), cfg


def _check_invariants(bs, cfg, stepping):
    n = len(bs.offered)
    # 1. sum of dt == duration: exact for adaptive (the final live step
    # takes dt = remaining, so the carried remainder hits 0.0 in f32);
    # fixed quantizes up to one slot
    if stepping == "adaptive":
        assert np.all(bs.sim_time_us == np.float64(
            np.float32(cfg.duration_us))), bs.sim_time_us
    else:
        assert np.all(bs.sim_time_us >= cfg.duration_us - 1e-6)
        assert np.all(bs.sim_time_us < cfg.duration_us + bs.slot_us)
    # 2. packet conservation: offered = served + dropped + backlog
    resid = bs.offered - bs.serviced - bs.dropped - bs.final_backlog
    assert np.all(np.abs(resid) <= CONS_REL * np.maximum(bs.offered, 1.0)
                  + 1.0), resid
    # 3. CPU accounting cannot exceed every thread being awake always
    m = np.asarray(bs.grid.m, dtype=np.float64)
    assert np.all(bs.awake_us >= 0.0)
    assert np.all(bs.awake_us <= m * cfg.duration_us * (1.0 + 1e-6))
    # 4. windowed series sums match run totals (same accumulators,
    # binned): offered / served / lat_area / awake / energy columns
    assert bs.win.shape[0] == n and bs.win.shape[2] == 5
    for col, name in ((0, "offered"), (1, "serviced"), (2, "lat_area"),
                      (3, "awake_us"), (4, "energy_uj")):
        tot = getattr(bs, name)
        wsum = bs.win[:, :, col].sum(axis=1)
        assert np.all(np.abs(wsum - tot)
                      <= CONS_REL * np.maximum(np.abs(tot), 1.0) + 1.0), \
            (name, wsum, tot)
    # 5. ns/us unit conversion in to_run_stats rounds (never truncates):
    # converting back must land within half an ns, not a full one
    for i in (0, n - 1):
        rs = bs.to_run_stats(i)
        assert abs(rs.awake_ns / 1e3 - float(bs.awake_us[i])) <= 5.1e-4
        assert abs(rs.stopped_ns / 1e3 - cfg.duration_us) <= 5.1e-4
        assert rs.energy_uj == pytest.approx(float(bs.energy_uj[i]))
    # diagnostics are well-formed
    assert np.all(bs.n_steps >= 1)
    assert np.all(bs.n_steps <= bs.scan_len)
    assert np.all(bs.forced_steps >= 0)
    assert bs.stepping == stepping


@pytest.mark.parametrize("stepping", STEPPINGS)
@pytest.mark.parametrize("interference", (False, True),
                         ids=("quiet", "noisy"))
def test_time_accounting_invariants(stepping, interference):
    grid, cfg = _mixed_grid(interference=interference)
    bs = simulate_batch(grid, cfg, slot_us=0.5, stepping=stepping, device="cpu")
    _check_invariants(bs, cfg, stepping)


def test_adaptive_needs_far_fewer_steps_at_low_load():
    """The load-proportionality claim at test scale: a rho=0.2, T_S=50us
    point takes >= 10x fewer live scan steps than fixed (20 ms, the
    reference 60)."""
    pts = [dict(t_s_us=50.0, t_l_us=500.0, m=3, rate_mpps=0.2 * 29.76,
                seed=0)]
    cfg = SimRunConfig(duration_us=20_000.0, sleep_model=HR_SLEEP_MODEL)
    grid = SweepGrid.of_points(pts)
    bf = simulate_batch(grid, cfg, slot_us=0.5, device="cpu")
    ba = simulate_batch(grid, cfg, slot_us=0.5, stepping="adaptive", device="cpu")
    assert float(ba.n_steps[0]) * 10.0 <= float(bf.n_steps[0])
    assert ba.scan_len * 3 <= bf.scan_len
    assert float(ba.forced_steps[0]) == 0.0


def test_stepping_rejects_unknown_mode():
    grid, cfg = _mixed_grid(n=1)
    with pytest.raises(ValueError, match="stepping"):
        simulate_batch(grid, cfg, stepping="magic", device="cpu")


def test_fleet_adaptive_parity_and_steps():
    """Fleet event-jump mode: aggregate latency / cores / loss agree
    with the fixed fleet kernel within the documented quiet bands, with
    fewer live steps, exact sim time, and the LB stale refresh honored
    as a jump boundary.  The reference's 30 ms, uncut (the plain versions
    of both fleet sweeps, ~35 s on one core)."""
    from repro_torch.runtime.fleet import FleetGrid, simulate_fleet
    from repro_torch.runtime.simcore import FleetConfig

    cfg = SimRunConfig(duration_us=30_000.0, sleep_model=HR_SLEEP_MODEL)
    fg = FleetGrid.product(
        fleet=FleetConfig(n_hosts=4, lb="least-loaded", lb_stale_us=50.0),
        t_s_us=(30.0,), t_l_us=(400.0,),
        rate_mpps=(0.2 * 29.76 * 4, 0.6 * 29.76 * 4),
        m=(3,), n_queues=(2,), seeds=(0,))
    f = simulate_fleet(fg, cfg, slot_us=0.5, shard=False, device="cpu")
    a = simulate_fleet(fg, cfg, slot_us=0.5, shard=False,
                       stepping="adaptive", device="cpu")
    assert a.stepping == "adaptive" and f.stepping == "fixed"
    for i in range(len(fg)):
        lat_f, lat_a = float(f.mean_latency_us[i]), \
            float(a.mean_latency_us[i])
        assert abs(lat_a - lat_f) <= max(1.5, 0.12 * lat_f), (lat_a, lat_f)
        cores_f = float(f.total_cpu_cores[i])
        assert abs(float(a.total_cpu_cores[i]) - cores_f) \
            <= 4 * 0.02 + 0.05 * cores_f
        assert abs(float(a.loss_fraction[i])
                   - float(f.loss_fraction[i])) <= 0.03
    assert np.all(a.sim_time_us == np.float64(
        np.float32(cfg.duration_us)))
    assert np.all(a.n_steps <= 0.5 * f.n_steps)
    assert a.scan_len < f.scan_len


def test_fleet_stepping_rejects_unknown_mode():
    from repro_torch.runtime.fleet import FleetGrid, simulate_fleet
    from repro_torch.runtime.simcore import FleetConfig

    fg = FleetGrid.product(fleet=FleetConfig(n_hosts=2),
                           t_s_us=(20.0,), t_l_us=(200.0,),
                           rate_mpps=(5.0,))
    with pytest.raises(ValueError, match="stepping"):
        simulate_fleet(fg, SimRunConfig(duration_us=1_000.0),
                       stepping="magic", device="cpu")


# ---------------------------------------------------------------- caching

def test_bucket_steps_ladder():
    """Geometric ladder: idempotent on its own rungs, monotone, never
    below the request, and coarse enough that nearby sizes collide."""
    assert bucket_steps(1) == 64
    assert bucket_steps(64) == 64
    for n in (65, 100, 1000, 240_000):
        b = bucket_steps(n)
        assert b >= n
        assert bucket_steps(b) == b           # rungs are fixed points
        assert b <= int(np.ceil(n * 1.25)) + 1
    assert bucket_steps(100) == bucket_steps(99)


@pytest.mark.parametrize("stepping", STEPPINGS)
def test_nearby_durations_share_one_compile(stepping):
    """Two nearby durations land on the same slot-count rung, and each run
    still simulates its own duration (2 ms, the reference 20).  The
    reference also reads its compile cache here; the port compiles nothing
    per shape, and on the card both runs are one launch of the same
    build."""
    pts = [dict(t_s_us=20.0, t_l_us=200.0, m=2, rate_mpps=5.0, seed=0)]
    grid = SweepGrid.of_points(pts)
    r = []
    for dur in (2_000.0, 2_040.0):     # within one 1.25x bucket rung
        cfg = SimRunConfig(duration_us=dur, sleep_model=HR_SLEEP_MODEL)
        r.append(simulate_batch(grid, cfg, slot_us=0.5, stepping=stepping, device="cpu"))
    assert r[0].scan_len == r[1].scan_len
    # and the padding is inert: each run still simulates ITS duration
    assert float(r[0].sim_time_us[0]) < float(r[1].sim_time_us[0])


# ------------------------------------------------- hypothesis (optional)

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                   # pragma: no cover
    HAVE_HYPOTHESIS = False


if HAVE_HYPOTHESIS:
    point_st = st.fixed_dictionaries(dict(
        t_s_us=st.floats(min_value=4.0, max_value=60.0,
                         allow_nan=False, allow_infinity=False),
        t_l_us=st.floats(min_value=80.0, max_value=1000.0,
                         allow_nan=False, allow_infinity=False),
        m=st.integers(min_value=1, max_value=4),
        n_queues=st.integers(min_value=1, max_value=3),
        rate_mpps=st.floats(min_value=0.5, max_value=24.0,
                            allow_nan=False, allow_infinity=False),
        seed=st.integers(min_value=0, max_value=2**31 - 1),
    ))

    @settings(max_examples=10, deadline=None)
    @given(pts=st.lists(point_st, min_size=1, max_size=4),
           stepping=st.sampled_from(STEPPINGS),
           noisy=st.booleans())
    def test_invariants_hold_for_random_jump_sequences(pts, stepping,
                                                       noisy):
        env = INTERFERENCE_ENV if noisy else {}
        # the invariants don't depend on the duration: 4 ms (the
        # reference runs 20)
        cfg = SimRunConfig(duration_us=4_000.0,
                           sleep_model=HR_SLEEP_MODEL,
                           window_us=1_000.0, **env)
        bs = simulate_batch(SweepGrid.of_points(pts), cfg, slot_us=0.5,
                            stepping=stepping, device="cpu")
        _check_invariants(bs, cfg, stepping)
