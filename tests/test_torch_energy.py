"""tests/test_energy.py on the port: energy accounting on the port's event
engine and on both batched sweeps, fixed-slot and event-jump (the plain
versions of the ``slot_sweep`` and ``adaptive_sweep`` kernels on the CPU).

The exact conservation identity

    energy_uj == active_power_w * awake_us
               + ts_arms     * arm_energy(T_S)
               + busy_tries  * arm_energy(T_L)

plus: windowed energy sums (and the event engine's post-duration spill)
reproduce the totals, merge/merge_all conserve energy, and the engines
agree within the reference's pinned bands.  The fleet's case runs both its
steppings (the plain versions of the ``fleet_sweep`` and
``fleet_adaptive_sweep`` kernels).  The plain sweeps run ~10^4 slots (or
event-jump steps) a second on the CPU, so sweeps of 20-120 ms run 4-40 ms
here (each names its cut) with the reference's checks."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.core import MetronomeConfig
from repro_torch.core.hr_sleep import calibrate
from repro_torch.runtime import (
    DEEP_CSTATE_ENERGY_MODEL,
    DEFAULT_ENERGY_MODEL,
    BusyPollPolicy,
    EnergyModel,
    MetronomePolicy,
    PoissonWorkload,
    SimRunConfig,
    SweepGrid,
    simulate_batch,
    simulate_run,
)
from repro_torch.runtime.simcore import HR_SLEEP_MODEL, WindowAccum

STEPPINGS = ("fixed", "adaptive")

# Same f32-accumulator rationale as test_stepping.CONS_REL: the
# identity must hold far tighter than any physical effect, not bit-exact
CONS_REL = 2e-3

# Cross-engine energy parity bands, pinned on the same config family as
# the latency/CPU bands in test_batched_engine.py (n_queues=1,
# HR_SLEEP_MODEL, 120 ms).  Measured gap on that family is ~1%; the
# band leaves the same headroom ratio the latency bands do.
E_REL, E_ABS_UJ = 0.08, 50.0
EPP_REL, EPP_ABS_NJ = 0.08, 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain sweeps' small tensors gain nothing from intra-op threads;
    one keeps a parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _band_points(n=3, seed=11):
    """Operating points inside the pinned parity-band family."""
    rng = np.random.default_rng(seed)
    pts = []
    for i in range(n):
        t_s = float(rng.uniform(5.0, 40.0))
        pts.append(dict(
            t_s_us=t_s,
            t_l_us=float(t_s * rng.uniform(4.0, 25.0)),
            m=int(rng.integers(1, 5)),
            n_queues=1,
            rate_mpps=float(rng.uniform(0.15, 0.85) * 29.76),
            seed=500 + i))
    return pts


def _mixed_points(n=8, seed=4):
    """Wider family (multi-queue too) for the conservation identity,
    which must hold at ANY operating point, not just the parity band."""
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
            seed=2000 + i))
    return pts


def _event_run(p, cfg):
    pol = MetronomePolicy(
        MetronomeConfig(m=p["m"], v_target_us=p["t_s_us"],
                        t_long_us=p["t_l_us"],
                        ts_min_us=min(1.0, p["t_s_us"])),
        adaptive=False)
    return simulate_run(pol, PoissonWorkload(p["rate_mpps"]), cfg)


def _check_conservation(bs, em):
    """The exact identity on a BatchStats, via public counters only."""
    arm_s = np.array([em.arm_energy_uj(t) for t in np.asarray(bs.grid.t_s_us)])
    arm_l = np.array([em.arm_energy_uj(t) for t in np.asarray(bs.grid.t_l_us)])
    pred = (em.active_power_w * bs.awake_us
            + bs.ts_arms * arm_s + bs.busy_tries * arm_l)
    np.testing.assert_allclose(bs.energy_uj, pred, rtol=CONS_REL, atol=1.0)
    if bs.win.size:
        np.testing.assert_allclose(bs.win[:, :, 4].sum(axis=1), bs.energy_uj,
                                   rtol=CONS_REL, atol=1.0)
    assert np.all(bs.energy_uj > 0.0)
    assert np.all(bs.energy_per_packet_nj > 0.0)
    assert np.all(bs.mean_power_w > 0.0)


# ------------------------------------------------------------ the model

def test_energy_model_state_selection_and_costs():
    em = EnergyModel(active_power_w=8.0,
                     sleep_states=((1.0, 0.5, 0.0),
                                   (0.4, 4.0, 30.0),
                                   (0.1, 20.0, 300.0)),
                     dvfs_busy_scale=1.5)
    # deepest state whose residency floor fits the programmed target
    assert em.select(10.0) == (1.0, 0.5)
    assert em.select(30.0) == (0.4, 4.0)
    assert em.select(299.9) == (0.4, 4.0)
    assert em.select(1000.0) == (0.1, 20.0)
    assert em.arm_energy_uj(50.0) == pytest.approx(0.4 * 50.0 + 4.0)
    # 1 W x 1 us = 1 uJ; spin pins the DVFS-scaled frequency
    assert float(em.active_energy_uj(10.0)) == pytest.approx(80.0)
    assert float(em.active_energy_uj(10.0, spin=True)) == pytest.approx(120.0)
    # states normalize shallow->deep regardless of declaration order
    em2 = EnergyModel(sleep_states=((0.1, 20.0, 300.0), (1.0, 0.5, 0.0)))
    assert em2.sleep_states[0][2] == 0.0
    assert em2.params()[2][0] == (1.0, 0.5, 0.0)
    # a model with no zero-residency shallow state is rejected
    with pytest.raises(ValueError, match="shallow"):
        EnergyModel(sleep_states=((0.5, 1.0, 10.0),))


def test_energy_arm_cost_matches_model_on_a_grid_of_targets():
    """The sweep's float32 torch.where chain and the python reference
    must be the same function."""
    import torch

    from repro_torch.runtime.batched import energy_arm_cost
    em = DEEP_CSTATE_ENERGY_MODEL
    for tgt in (0.5, 5.0, 39.9, 40.0, 120.0, 399.0, 400.0, 5000.0):
        got = float(energy_arm_cost(torch.tensor([tgt], dtype=torch.float32),
                                    em.sleep_states)[0])
        assert got == pytest.approx(em.arm_energy_uj(tgt), rel=1e-6)


# ------------------------------------------- batched kernels: identity

@pytest.mark.parametrize("stepping", STEPPINGS)
@pytest.mark.parametrize("em", (DEFAULT_ENERGY_MODEL,
                                DEEP_CSTATE_ENERGY_MODEL),
                         ids=("default", "deep"))
def test_kernel_energy_obeys_conservation_identity(stepping, em):
    # 10 ms a point (the reference runs 30)
    grid = SweepGrid.of_points(_mixed_points())
    cfg = SimRunConfig(duration_us=10_000.0, sleep_model=HR_SLEEP_MODEL,
                       window_us=1_000.0, energy_model=em)
    bs = simulate_batch(grid, cfg, slot_us=0.5, stepping=stepping, device="cpu")
    _check_conservation(bs, em)


def test_energy_components_isolate():
    pts = [dict(t_s_us=20.0, t_l_us=200.0, m=2, n_queues=1,
                rate_mpps=8.0, seed=0)]
    grid = SweepGrid.of_points(pts)
    # 10 ms (the reference runs 20)
    base = dict(duration_us=10_000.0, sleep_model=HR_SLEEP_MODEL)
    # active-only model: total energy IS total awake time (1 W)
    em_a = EnergyModel(active_power_w=1.0, sleep_states=((0.0, 0.0, 0.0),))
    bs = simulate_batch(grid, SimRunConfig(energy_model=em_a, **base),
                        slot_us=0.5, device="cpu")
    assert float(bs.energy_uj[0]) == pytest.approx(float(bs.awake_us[0]),
                                                   rel=CONS_REL)
    # sleep-only model: total energy counts the armed sleeps alone
    em_s = EnergyModel(active_power_w=0.0, sleep_states=((0.5, 2.0, 0.0),))
    bs = simulate_batch(grid, SimRunConfig(energy_model=em_s, **base),
                        slot_us=0.5, device="cpu")
    want = (float(bs.ts_arms[0]) * (0.5 * 20.0 + 2.0)
            + float(bs.busy_tries[0]) * (0.5 * 200.0 + 2.0))
    assert float(bs.energy_uj[0]) == pytest.approx(want, rel=CONS_REL)


# -------------------------------------------------- event engine + spill

def test_event_engine_energy_windows_and_spill_conserve():
    p = dict(t_s_us=25.0, t_l_us=300.0, m=2, n_queues=1,
             rate_mpps=0.5 * 29.76, seed=7)
    cfg = SimRunConfig(duration_us=30_000.0, sleep_model=HR_SLEEP_MODEL,
                       window_us=1_000.0, seed=7,
                       energy_model=DEEP_CSTATE_ENERGY_MODEL)
    rs = _event_run(p, cfg)
    w = rs.windows
    assert rs.energy_uj > 0.0
    assert w.energy_uj.sum() + w.spill_energy_uj \
        == pytest.approx(rs.energy_uj, rel=1e-9)
    assert rs.energy_per_packet_nj \
        == pytest.approx(1e3 * rs.energy_uj / rs.items)
    assert rs.summary()["energy_uj"] == pytest.approx(rs.energy_uj)


def test_spin_energy_pins_dvfs_scaled_active_power():
    em = DEEP_CSTATE_ENERGY_MODEL
    cfg = SimRunConfig(duration_us=20_000.0, seed=3, energy_model=em)
    rs = simulate_run(BusyPollPolicy(), PoissonWorkload(5.0), cfg)
    # a spinning core never arms a timer: flat dvfs-scaled active power
    assert rs.energy_uj == pytest.approx(
        em.active_power_w * em.dvfs_busy_scale * rs.awake_ns / 1e3,
        rel=1e-6)


def test_window_accum_spills_post_duration_events():
    """Regression (the _idx clamp): contributions at t >= duration —
    the event engine's final-drain pass — must land in the spill
    scalars, never the last window."""
    cfg = SimRunConfig(duration_us=100.0, window_us=10.0)
    wa = WindowAccum(cfg)
    wa.add(5.0, offered=1.0, served=1.0, lat_area=2.0, awake=0.5,
           energy_uj=3.0)
    wa.add(99.9, served=2.0)
    wa.add(100.0, served=7.0, lat_area=4.0, awake=0.2, energy_uj=5.0)
    wa.add(250.0, offered=1.0)
    s = wa.series(cfg)
    assert s.served[0] == 1.0 and s.served[-1] == 2.0
    assert s.served.sum() == 3.0
    assert s.spill_served == 7.0 and s.spill_offered == 1.0
    assert s.spill_energy_uj == 5.0 and s.spill_lat_area_us == 4.0
    # post-duration controller/latency samples are skipped, not clamped
    wa.control(100.0, 0.5, 20.0)
    wa.latency_samples(101.0, [9.0])
    assert wa.rho_cnt[-1] == 0 and not wa.samples[-1]


def test_final_drain_last_window_parity_cross_engine():
    """With the drain spilled, the event engine's LAST window is a
    normal window and agrees with the batched kernel's (which never
    runs past duration) like any other window does."""
    p = dict(t_s_us=100.0, t_l_us=1_000.0, m=1, n_queues=1,
             rate_mpps=0.95 * 29.76, seed=0)
    cfg = SimRunConfig(duration_us=30_000.0, sleep_model=HR_SLEEP_MODEL,
                       window_us=1_000.0, seed=0)
    rs = _event_run(p, cfg)
    w = rs.windows
    # the drain is real at this load: the final busy period crosses the
    # run end and its serves land past duration — about half a window's
    # worth, which the old clamp would have dumped into the last bin
    assert w.spill_served > 5_000.0
    assert w.served.sum() + w.spill_served == pytest.approx(rs.items)
    assert w.energy_uj.sum() + w.spill_energy_uj \
        == pytest.approx(rs.energy_uj, rel=1e-9)
    wb = simulate_batch(SweepGrid.of_points([p]), cfg,
                        slot_us=0.5, device="cpu").windows(0)
    a, b = w.served[-1], float(wb.served[-1])
    assert abs(a - b) <= 0.25 * max(a, b) + 500.0, (a, b)


# ----------------------------------------------------- merge / rollups

def test_run_stats_merge_and_merge_all_conserve_energy():
    p = dict(t_s_us=20.0, t_l_us=300.0, m=2, n_queues=1,
             rate_mpps=8.0, seed=0)
    cfg = SimRunConfig(duration_us=20_000.0, window_us=2_000.0,
                       sleep_model=HR_SLEEP_MODEL)
    runs = [_event_run(p, replace(cfg, seed=s)) for s in (1, 2, 3)]
    singles = [r.energy_uj for r in runs]
    assert all(e > 0.0 for e in singles)
    merged = runs[0].merge(runs[1])
    assert merged.energy_uj == pytest.approx(singles[0] + singles[1])
    runs = [_event_run(p, replace(cfg, seed=s)) for s in (1, 2, 3)]
    rolled = runs[0].merge_all(runs[1:])
    assert rolled.energy_uj == pytest.approx(sum(singles))
    # windowed energy merged per bin and still sums (with spill) to total
    w = rolled.windows
    assert w.energy_uj.sum() + w.spill_energy_uj \
        == pytest.approx(rolled.energy_uj, rel=1e-9)


def test_fleet_energy_per_host_identity_and_cluster_rollup():
    """Both steppings, as the reference's test; cut from 20 ms to 4 ms."""
    from repro_torch.runtime.fleet import FleetGrid, simulate_fleet
    from repro_torch.runtime.simcore import FleetConfig

    em = DEEP_CSTATE_ENERGY_MODEL
    cfg = SimRunConfig(duration_us=4_000.0, sleep_model=HR_SLEEP_MODEL,
                       energy_model=em)
    fg = FleetGrid.product(fleet=FleetConfig(n_hosts=3),
                           t_s_us=(25.0,), t_l_us=(300.0,),
                           rate_mpps=(0.4 * 29.76 * 3,),
                           m=(2,), n_queues=(1,), seeds=(0,))
    arm_s, arm_l = em.arm_energy_uj(25.0), em.arm_energy_uj(300.0)
    for st in STEPPINGS:
        fs = simulate_fleet(fg, cfg, slot_us=0.5, shard=False, stepping=st,
                            device="cpu")
        pred = (em.active_power_w * fs.awake_us
                + fs.ts_arms * arm_s + fs.busy_tries * arm_l)
        np.testing.assert_allclose(fs.energy_uj, pred, rtol=CONS_REL,
                                   atol=1.0)
        assert float(fs.total_energy_uj[0]) \
            == pytest.approx(float(fs.energy_uj[0].sum()), rel=1e-6)
        assert np.all(fs.host_power_w > 0.0)
        assert float(fs.energy_per_packet_nj[0]) > 0.0
        # cluster rollup through RunStats.merge_all conserves energy
        hosts = fs.host_run_stats(0)
        rolled = hosts[0].merge_all(hosts[1:])
        assert rolled.energy_uj == pytest.approx(
            float(fs.total_energy_uj[0]), rel=1e-6, abs=1.0)


# ------------------------------------------------- cross-engine parity

def test_energy_parity_event_vs_both_kernels():
    # 40 ms, both engines (the reference runs 120)
    pts = _band_points()
    cfg = SimRunConfig(duration_us=40_000.0, sleep_model=HR_SLEEP_MODEL)
    ev = [_event_run(p, replace(cfg, seed=p["seed"])) for p in pts]
    grid = SweepGrid.of_points(pts)
    for st in STEPPINGS:
        bs = simulate_batch(grid, cfg, slot_us=0.5, stepping=st, device="cpu")
        for i, rs in enumerate(ev):
            e_ev, e_bs = rs.energy_uj, float(bs.energy_uj[i])
            assert abs(e_bs - e_ev) <= E_ABS_UJ + E_REL * e_ev, \
                (st, i, e_bs, e_ev)
            pp_ev = rs.energy_per_packet_nj
            pp_bs = float(bs.energy_per_packet_nj[i])
            assert abs(pp_bs - pp_ev) <= EPP_ABS_NJ + EPP_REL * pp_ev, \
                (st, i, pp_bs, pp_ev)


# --------------------------------------------------- hr_sleep calibrate

def test_calibrate_margin_floored_at_spin_resolution():
    cal = calibrate(samples=25, probe_ns=1_000)
    # the margin the spin tail must cover can never be finer than what
    # the spin loop can resolve, nor below the 1us bulk/spin split floor
    assert cal.margin_ns >= cal.spin_resolution_ns
    assert cal.margin_ns >= 1_000
    assert cal.spin_resolution_ns >= 1
    # min_sleep_ns is the mean ACHIEVED duration of a probe_ns request:
    # at least the request itself (sleeps never return early)
    assert cal.min_sleep_ns >= 1_000


# ------------------------------------------- hypothesis (optional)

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
           deep=st.booleans())
    def test_energy_identity_holds_for_random_grids(pts, stepping, deep):
        em = DEEP_CSTATE_ENERGY_MODEL if deep else DEFAULT_ENERGY_MODEL
        # 4 ms a grid (the reference runs 20)
        cfg = SimRunConfig(duration_us=4_000.0,
                           sleep_model=HR_SLEEP_MODEL,
                           window_us=1_000.0, energy_model=em)
        bs = simulate_batch(SweepGrid.of_points(pts), cfg, slot_us=0.5,
                            stepping=stepping, device="cpu")
        _check_conservation(bs, em)
