"""tests/test_controller_tracking.py on the port: controller-level
adaptation guarantees (exact EWMA step response, the T_L >= T_S clamp along
a full schedule trajectory, operating-table interpolation continuity at its
knots, and the recorded rho/T_S trajectory surface) through the port's
controller, policy, calibration tables and event engine, with the
reference's durations and checks."""

import numpy as np
import pytest

from repro_torch.core import MetronomeConfig, MetronomeController
from repro_torch.runtime import (
    MetronomePolicy,
    PoissonWorkload,
    SimRunConfig,
    SinusoidSchedule,
    StepSchedule,
    simulate_run,
)
from repro_torch.runtime.calibrate import OperatingPoint, OperatingTable


def test_ewma_step_response_is_exactly_one_minus_decay_pow_n():
    """Eq 10 against a rate step: feeding a constant observed load
    rho* = B/(V+B), the estimate's remaining error after n cycles is
    exactly (1-alpha)^n of the initial error — the textbook first-order
    step response, with no hidden state or bias."""
    alpha = 0.125
    ctl = MetronomeController(MetronomeConfig(alpha=alpha, rho_init=0.2))
    rho_star = 0.8          # B=8, V=2 -> B/(V+B) = 0.8
    err0 = rho_star - ctl.rho
    for n in range(1, 40):
        ctl.on_cycle_end(busy_us=8.0, vacation_us=2.0)
        expected = rho_star - err0 * (1.0 - alpha) ** n
        assert ctl.rho == pytest.approx(expected, abs=1e-12), n
    # the fractional progress toward the step is exactly 1-(1-a)^n
    ctl2 = MetronomeController(MetronomeConfig(alpha=0.3, rho_init=0.0))
    for n in range(1, 25):
        ctl2.on_cycle_end(busy_us=1.0, vacation_us=1.0)   # rho* = 0.5
        frac = ctl2.rho / 0.5
        assert frac == pytest.approx(1.0 - 0.7 ** n, abs=1e-12)


def test_tl_clamp_holds_along_full_schedule_trajectory():
    """An adversarial feed-forward table whose T_L rungs dip far below
    its T_S rungs must never invert the role split while the EWMA
    sweeps the whole load range (up and down): T_L >= T_S after every
    cycle of a full schedule trajectory."""
    evil = OperatingTable(
        target_mean_latency_us=15.0, service_rate_mpps=29.76,
        points=(
            OperatingPoint(rho=0.1, t_s_us=60.0, t_l_us=5.0, m=3,
                           mean_latency_us=10.0, cpu_fraction=0.1,
                           loss_fraction=0.0),
            OperatingPoint(rho=0.5, t_s_us=30.0, t_l_us=2.0, m=3,
                           mean_latency_us=10.0, cpu_fraction=0.5,
                           loss_fraction=0.0),
            OperatingPoint(rho=0.9, t_s_us=8.0, t_l_us=1.0, m=3,
                           mean_latency_us=10.0, cpu_fraction=0.9,
                           loss_fraction=0.0),
        ))
    pol = MetronomePolicy(
        MetronomeConfig(m=3, record_trajectory=True),
        operating_table=evil)
    sched = StepSchedule(times_us=(0.0, 15_000.0, 30_000.0),
                         scales=(0.2, 1.0, 0.3))
    cfg = SimRunConfig(duration_us=45_000.0, schedule=sched, seed=4)
    simulate_run(pol, PoissonWorkload(0.8 * 29.76), cfg)
    traj = pol.trajectory
    assert len(traj) > 100          # the loop actually cycled a lot
    for cycle, rho, ts, tl in traj:
        assert tl >= ts - 1e-9, (cycle, rho, ts, tl)
    # the trajectory really swept the schedule's load range
    rhos = np.asarray([r for _, r, _, _ in traj])
    assert rhos.min() < 0.3 and rhos.max() > 0.6


def test_operating_table_interpolation_is_continuous_at_knots():
    table = OperatingTable(
        target_mean_latency_us=15.0, service_rate_mpps=29.76,
        points=(
            OperatingPoint(rho=0.2, t_s_us=40.0, t_l_us=500.0, m=3,
                           mean_latency_us=12.0, cpu_fraction=0.2,
                           loss_fraction=0.0),
            OperatingPoint(rho=0.5, t_s_us=20.0, t_l_us=300.0, m=3,
                           mean_latency_us=12.0, cpu_fraction=0.5,
                           loss_fraction=0.0),
            OperatingPoint(rho=0.8, t_s_us=10.0, t_l_us=150.0, m=3,
                           mean_latency_us=12.0, cpu_fraction=0.8,
                           loss_fraction=0.0),
        ))
    eps = 1e-9
    for knot in (0.2, 0.5, 0.8):
        lo_s, lo_l = table.timeouts_us(knot - eps)
        at_s, at_l = table.timeouts_us(knot)
        hi_s, hi_l = table.timeouts_us(knot + eps)
        assert lo_s == pytest.approx(at_s, abs=1e-6)
        assert hi_s == pytest.approx(at_s, abs=1e-6)
        assert lo_l == pytest.approx(at_l, abs=1e-6)
        assert hi_l == pytest.approx(at_l, abs=1e-6)
    # strictly between knots: linear interpolation, monotone here
    mid_s, _ = table.timeouts_us(0.35)
    assert 20.0 < mid_s < 40.0
    assert mid_s == pytest.approx((40.0 + 20.0) / 2)
    # outside the calibrated range: clamped, still continuous
    assert table.timeouts_us(0.0) == table.timeouts_us(0.2)
    assert table.timeouts_us(1.0) == table.timeouts_us(0.8)


def test_trajectory_recording_off_by_default_and_capped():
    ctl = MetronomeController(MetronomeConfig())
    ctl.on_cycle_end(1.0, 1.0)
    assert ctl.trajectory == []                # off by default
    ctl2 = MetronomeController(
        MetronomeConfig(record_trajectory=True, trajectory_cap=10))
    for _ in range(25):
        ctl2.on_cycle_end(1.0, 1.0)
    assert len(ctl2.trajectory) == 10          # bounded
    cyc, rho, ts, tl = ctl2.trajectory[-1]
    assert cyc == 10 and 0.0 <= rho <= 1.0 and tl >= ts
    # reset clears the trace (policies re-arm the controller in place)
    ctl2.__post_init__()
    assert ctl2.trajectory == []


def test_windows_surface_controller_ts_series():
    """The windowed series exposes the controller's T_S trajectory
    (ts_us), and it responds to the schedule: higher load -> shorter
    primary timeout."""
    sched = StepSchedule(times_us=(0.0, 20_000.0), scales=(0.25, 1.0))
    cfg = SimRunConfig(duration_us=40_000.0, schedule=sched,
                       window_us=2_000.0, seed=1)
    rs = simulate_run(MetronomePolicy(MetronomeConfig(alpha=0.125)),
                      PoissonWorkload(0.7 * 29.76), cfg)
    ts = rs.windows.ts_us
    lo = np.nanmean(ts[2:10])       # settled low-load windows
    hi = np.nanmean(ts[12:])        # settled high-load windows
    assert hi < lo                  # Eq 12: T_S shrinks as rho rises
    # rho estimate column tracks the step too
    assert np.nanmean(rs.windows.rho_est[12:]) > np.nanmean(
        rs.windows.rho_est[2:10]) + 0.2


def test_sinusoid_schedule_rho_tracking_rmse_is_small():
    sched = SinusoidSchedule(period_us=10_000.0, amplitude=0.3, mean=0.6)
    cfg = SimRunConfig(duration_us=40_000.0, schedule=sched,
                       window_us=1_000.0, seed=3)
    rs = simulate_run(MetronomePolicy(MetronomeConfig(alpha=0.2)),
                      PoissonWorkload(0.8 * 29.76), cfg)
    tk = rs.windows.tracking((), target_latency_us=50.0)
    assert tk.rho_rmse < 0.15       # EWMA follows a slow sinusoid
    assert tk.violation_fraction == 0.0
