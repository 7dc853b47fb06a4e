"""tests/test_schedule.py on the port: LoadSchedule kinds, the
time-warping ScheduledWorkload, the windowed adaptation series of the
event engine, and the shared TrackingStats computation, through the port's
copies (``repro_torch.runtime.{schedule,sim,workload,stats}``)."""

import numpy as np
import pytest

from repro_torch.core import MetronomeConfig
from repro_torch.runtime import (
    BusyPollPolicy,
    CBRWorkload,
    MetronomePolicy,
    MMPPSchedule,
    PoissonWorkload,
    RampSchedule,
    ScheduledWorkload,
    SimRunConfig,
    SinusoidSchedule,
    StepSchedule,
    Workload,
    from_trace,
    simulate_run,
)
from repro_torch.runtime.stats import WindowedSeries


# ---------------------------------------------------------------------------
# schedule kinds
# ---------------------------------------------------------------------------

def test_step_schedule_lookup_integral_inverse():
    s = StepSchedule(times_us=(0.0, 10_000.0, 30_000.0),
                     scales=(1.0, 2.0, 0.5))
    assert s.scale_at(5_000.0) == 1.0
    assert s.scale_at(10_000.0) == 2.0          # right-continuous
    assert s.scale_at(50_000.0) == 0.5
    # integral is piecewise linear and exact
    assert s.integral(10_000.0) == pytest.approx(10_000.0)
    assert s.integral(30_000.0) == pytest.approx(10_000.0 + 2.0 * 20_000.0)
    assert s.integral(40_000.0) == pytest.approx(50_000.0 + 0.5 * 10_000.0)
    # inverse round-trips
    for t in (0.0, 3_000.0, 10_000.0, 25_000.0, 39_000.0):
        assert s.inverse_integral(s.integral(t),
                                  hint_until_us=50_000.0) == pytest.approx(t)
    assert s.transitions(40_000.0) == (10_000.0, 30_000.0)


def test_step_schedule_validation():
    with pytest.raises(ValueError):
        StepSchedule(times_us=(1.0,), scales=(1.0,))        # t0 != 0
    with pytest.raises(ValueError):
        StepSchedule(times_us=(0.0, 5.0, 5.0), scales=(1.0, 2.0, 3.0))
    with pytest.raises(ValueError):
        StepSchedule(times_us=(0.0,), scales=(-0.1,))


def test_ramp_schedule_staircase_and_transitions():
    r = RampSchedule(t_start_us=10_000.0, t_end_us=20_000.0,
                     scale_from=0.5, scale_to=1.5, n_steps=10)
    assert r.scale_at(0.0) == 0.5
    assert r.scale_at(25_000.0) == 1.5
    mid = r.scale_at(15_000.0)
    assert 0.5 < mid < 1.5
    # staircase is monotone along the ramp
    vals = [r.scale_at(t) for t in np.linspace(10_000.0, 20_000.0, 21)]
    assert all(b >= a for a, b in zip(vals, vals[1:]))
    # ramp integral ~ trapezoid (staircase midpoint rule is exact here)
    assert r.integral(20_000.0) == pytest.approx(
        0.5 * 10_000.0 + (0.5 + 1.5) / 2 * 10_000.0, rel=1e-9)
    assert r.transitions(60_000.0) == (10_000.0, 20_000.0)


def test_sinusoid_schedule_periodic_and_mean_preserving():
    s = SinusoidSchedule(period_us=10_000.0, amplitude=0.5, mean=1.0,
                         steps_per_period=32)
    # exactly periodic
    assert s.scale_at(2_500.0) == pytest.approx(s.scale_at(12_500.0))
    # one full period integrates to the mean
    assert s.integral(10_000.0) / 10_000.0 == pytest.approx(1.0, abs=1e-9)
    # never negative even when amplitude > mean
    deep = SinusoidSchedule(period_us=1_000.0, amplitude=2.0, mean=1.0)
    assert min(deep.segments(5_000.0)[1]) == 0.0
    assert s.transitions(50_000.0) == ()


def test_mmpp_schedule_deterministic_replay():
    a = MMPPSchedule(states=(0.5, 1.0, 2.0), mean_dwell_us=5_000.0, seed=7)
    b = MMPPSchedule(states=(0.5, 1.0, 2.0), mean_dwell_us=5_000.0, seed=7)
    ea, va = a.segments(100_000.0)
    eb, vb = b.segments(100_000.0)
    np.testing.assert_allclose(ea, eb)
    np.testing.assert_allclose(va, vb)
    assert a == b                              # env-record equality
    # never self-jumps, and only visits declared states
    assert all(x != y for x, y in zip(va, va[1:]))
    assert set(va) <= {0.5, 1.0, 2.0}
    c = MMPPSchedule(states=(0.5, 1.0, 2.0), mean_dwell_us=5_000.0, seed=8)
    assert not np.array_equal(c.segments(100_000.0)[0], ea)


def test_from_trace_builds_relative_step_schedule():
    s = from_trace([0.0, 1_000.0, 3_000.0], [5.0, 10.0, 2.5],
                   base_rate_mpps=5.0)
    assert s.scale_at(500.0) == 1.0
    assert s.scale_at(2_000.0) == 2.0
    assert s.scale_at(10_000.0) == 0.5
    assert s.name == "trace"


def test_compiled_fixed_width_padding_and_resampling():
    s = StepSchedule(times_us=(0.0, 10_000.0), scales=(1.0, 2.0))
    edges, scales = s.compiled(40_000.0, max_segments=8)
    assert edges.shape == scales.shape == (8,)
    assert np.all(np.diff(edges) > 0)          # strictly increasing
    assert scales[-1] == 2.0                   # padded with last value
    # denser than the cap: resampled to window means, width preserved
    sin = SinusoidSchedule(period_us=1_000.0, steps_per_period=64)
    e2, v2 = sin.compiled(100_000.0, max_segments=16)
    assert e2.shape == v2.shape == (16,)


# ---------------------------------------------------------------------------
# ScheduledWorkload: time warping
# ---------------------------------------------------------------------------

def test_scheduled_workload_satisfies_protocol_and_name():
    wl = ScheduledWorkload(PoissonWorkload(5.0),
                           StepSchedule(times_us=(0.0,), scales=(2.0,)))
    assert isinstance(wl, Workload)
    assert wl.name.startswith("poisson@step")


def test_scheduled_poisson_counts_follow_the_schedule():
    s = StepSchedule(times_us=(0.0, 50_000.0), scales=(0.5, 2.0))
    wl = ScheduledWorkload(PoissonWorkload(4.0), s)
    wl.reset(np.random.default_rng(0))
    lo = sum(wl.counts_in(t, t + 1_000.0) for t in range(0, 50_000, 1_000))
    hi = sum(wl.counts_in(t, t + 1_000.0)
             for t in range(50_000, 100_000, 1_000))
    assert lo / 50_000.0 == pytest.approx(2.0, rel=0.05)     # 4 * 0.5
    assert hi / 50_000.0 == pytest.approx(8.0, rel=0.05)     # 4 * 2.0
    assert wl.rate_at(10_000.0) == pytest.approx(2.0)
    assert wl.rate_at(60_000.0) == pytest.approx(8.0)


def test_scheduled_cbr_is_exact_time_warp():
    # CBR at rate 1/100us, scale 2 -> one arrival every 50us exactly
    s = StepSchedule(times_us=(0.0,), scales=(2.0,))
    wl = ScheduledWorkload(CBRWorkload(0.01), s)
    wl.reset(np.random.default_rng(0))
    assert wl.counts_in(0.0, 1_000.0) == 20
    ts = list(wl.iter_arrivals(500.0, np.random.default_rng(0)))
    assert ts == pytest.approx([50.0 * k for k in range(1, 10)])


def test_scheduled_iter_arrivals_rate_tracks_schedule():
    s = StepSchedule(times_us=(0.0, 20_000.0), scales=(1.0, 3.0))
    wl = ScheduledWorkload(PoissonWorkload(2.0), s)
    ts = np.asarray(list(wl.iter_arrivals(40_000.0,
                                          np.random.default_rng(3))))
    lo = (ts < 20_000.0).sum() / 20_000.0
    hi = (ts >= 20_000.0).sum() / 20_000.0
    assert lo == pytest.approx(2.0, rel=0.1)
    assert hi == pytest.approx(6.0, rel=0.1)
    assert np.all(np.diff(ts) >= 0)


# ---------------------------------------------------------------------------
# engines: schedule + windowed series
# ---------------------------------------------------------------------------

STEP = StepSchedule(times_us=(0.0, 20_000.0), scales=(0.4, 1.2))


def test_event_engine_windows_conserve_totals_and_track_load():
    cfg = SimRunConfig(duration_us=40_000.0, schedule=STEP,
                       window_us=2_000.0, seed=2)
    rs = simulate_run(MetronomePolicy(MetronomeConfig()),
                      PoissonWorkload(0.5 * 29.76), cfg)
    w = rs.windows
    assert w is not None and w.n_windows == 20
    # conservation: windowed sums (plus the post-duration spill, e.g.
    # the final drain) equal the run totals
    assert w.offered.sum() + w.spill_offered == pytest.approx(rs.offered)
    assert w.served.sum() + w.spill_served == pytest.approx(rs.items)
    assert (w.awake_us.sum() + w.spill_awake_us) * 1e3 \
        == pytest.approx(rs.awake_ns, rel=1e-6, abs=1e3)
    assert w.lat_area_us.sum() + w.spill_lat_area_us \
        == pytest.approx(rs.latency_area_us, rel=1e-6)
    assert w.energy_uj.sum() + w.spill_energy_uj \
        == pytest.approx(rs.energy_uj, rel=1e-6)
    # true rho follows the schedule; the EWMA estimate tracks it
    assert w.rho_true[:10].mean() == pytest.approx(0.5 * 0.4, rel=0.15)
    assert w.rho_true[10:].mean() == pytest.approx(0.5 * 1.2, rel=0.15)
    est_err = np.abs(w.rho_est[12:] - w.rho_true[12:])
    assert np.nanmean(est_err) < 0.08
    # schedule descriptor is stamped on the stats and its summary
    assert rs.schedule.startswith("step[")
    assert rs.summary()["schedule"] == rs.schedule


def test_event_engine_stationary_run_has_no_windows_and_no_schedule():
    cfg = SimRunConfig(duration_us=10_000.0)
    rs = simulate_run(MetronomePolicy(MetronomeConfig()),
                      PoissonWorkload(5.0), cfg)
    assert rs.windows is None
    assert rs.schedule == ""


def test_spin_model_windows_burn_flat_core_under_any_schedule():
    cfg = SimRunConfig(duration_us=40_000.0, schedule=STEP,
                       window_us=2_000.0)
    rs = simulate_run(BusyPollPolicy(), PoissonWorkload(0.5 * 29.76), cfg)
    w = rs.windows
    np.testing.assert_allclose(w.cpu_fraction, 1.0)
    # but the offered rate still follows the schedule
    assert w.offered_mpps[-1] > 2.0 * w.offered_mpps[0]
    assert rs.schedule.startswith("step[")


def test_golden_stationary_run_unchanged_by_feature():
    """The nonstationary plumbing must not disturb the stationary event
    sequence: schedule=None + window_us=0 reproduces the exact counters
    of a pre-feature run at the same seed."""
    cfg = SimRunConfig(duration_us=30_000.0, seed=5)
    a = simulate_run(MetronomePolicy(MetronomeConfig()),
                     PoissonWorkload(10.0), cfg)
    b = simulate_run(MetronomePolicy(MetronomeConfig()),
                     PoissonWorkload(10.0), cfg)
    for f in ("wakeups", "cycles", "items", "offered", "dropped",
              "awake_ns"):
        assert getattr(a, f) == getattr(b, f)
    # windowed twin at the same seed: same totals as the plain run
    cfg_w = SimRunConfig(duration_us=30_000.0, seed=5, window_us=3_000.0)
    c = simulate_run(MetronomePolicy(MetronomeConfig()),
                     PoissonWorkload(10.0), cfg_w)
    for f in ("wakeups", "cycles", "items", "offered", "dropped"):
        assert getattr(a, f) == getattr(c, f), f


# ---------------------------------------------------------------------------
# WindowedSeries / TrackingStats (shared computation)
# ---------------------------------------------------------------------------

def _series(lat, offered=None, window_us=1_000.0, mu=29.76):
    lat = np.asarray(lat, dtype=np.float64)
    served = np.full(lat.size, 100.0)
    offered = (np.asarray(offered, dtype=np.float64)
               if offered is not None else served.copy())
    return WindowedSeries(
        window_us=window_us, service_rate_mpps=mu,
        offered=offered, served=served, lat_area_us=lat * served,
        awake_us=np.full(lat.size, 500.0))


def test_tracking_convergence_and_overshoot():
    # settled at 10, transition at 5ms -> spike to 30 decaying to 12
    lat = [10.0] * 5 + [30.0, 20.0, 14.0, 12.0, 12.0, 12.0, 12.0]
    tk = _series(lat).tracking([5_000.0], target_latency_us=25.0)
    assert tk.transitions_us == (5_000.0,)
    # settled post-step value = 12; band = max(2, .25*12) = 3 -> the
    # first in-band window is index 7 (14.0), so convergence = 3 windows
    assert tk.convergence_us == (3_000.0,)
    assert tk.mean_convergence_us == 3_000.0
    assert tk.max_overshoot_us == pytest.approx(30.0 - 12.0)
    assert tk.violation_fraction == pytest.approx(1.0 / 12.0)
    assert np.isnan(tk.rho_rmse)               # no controller samples


def test_tracking_never_converges_is_nan():
    lat = [10.0] * 4 + [50.0, 45.0, 55.0, 50.0, 60.0, 40.0, 55.0, 65.0]
    tk = _series(lat).tracking([4_000.0], target_latency_us=100.0)
    assert np.isnan(tk.convergence_us[0]) or tk.convergence_us[0] > 0
    # a flat tail can settle; assert only the API shape here
    assert len(tk.convergence_us) == 1


def test_tracking_violation_fraction_counts_all_windows():
    lat = [10.0, 20.0, 30.0, 40.0]
    tk = _series(lat).tracking([], target_latency_us=25.0)
    assert tk.violation_fraction == pytest.approx(0.5)
    assert tk.transitions_us == ()
    assert np.isnan(tk.mean_convergence_us)


def test_windowed_series_merge_pools_accumulators():
    a = _series([10.0, 20.0])
    b = _series([30.0, 40.0])
    a.merge(b)
    assert a.served[0] == 200.0
    assert a.mean_latency_us[0] == pytest.approx(20.0)   # (10+30)/2 pooled
    with pytest.raises(ValueError):
        a.merge(_series([1.0, 2.0, 3.0]))


def test_run_stats_merge_pools_windows():
    cfg = SimRunConfig(duration_us=20_000.0, window_us=2_000.0, seed=0)
    a = simulate_run(MetronomePolicy(MetronomeConfig()),
                     PoissonWorkload(5.0), cfg)
    b = simulate_run(MetronomePolicy(MetronomeConfig()),
                     PoissonWorkload(5.0),
                     SimRunConfig(duration_us=20_000.0, window_us=2_000.0,
                                  seed=1))
    tot = a.windows.offered.sum() + b.windows.offered.sum()
    a.merge(b)
    assert a.windows.offered.sum() == pytest.approx(tot)
    # mismatched grids drop the series instead of corrupting it
    c = simulate_run(MetronomePolicy(MetronomeConfig()),
                     PoissonWorkload(5.0),
                     SimRunConfig(duration_us=20_000.0, window_us=5_000.0,
                                  seed=2))
    a.merge(c)
    assert a.windows is None
