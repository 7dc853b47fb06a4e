"""tests/test_calibrate.py on the port: operating-table construction,
persistence, controller feed-forward, serving integration, and the
calibrated-vs-fixed-baseline verdict, with ``build_operating_table(...,
device="cpu")`` (its lattice sweep in the sweep kernel's plain version).

The plain fixed-slot sweep makes ~10^5 point-slots a second on the CPU (a
72-point table of 30 ms takes ~19 s), so the tables are built from runs of
10 ms (the reference's 30) and the environment spot check runs 8 ms (its
20); the checks are the reference's.  Its slow verdict test runs the
benchmark's quick lattice through the port's sweep at the reference's 30 ms.

Then what the port adds: a table built on the event-jump sweep
(``stepping="adaptive"``), a precomputed reference sweep handed to the
port's ``build_operating_table`` (the same table as the reference's), and
the JSON round trip with the reference's ``OperatingTable`` both ways."""

import json

import numpy as np
import pytest
import torch

from repro_torch.core import MetronomeConfig, MetronomeController
from repro_torch.runtime import (
    MetronomePolicy,
    OperatingPoint,
    OperatingTable,
    SimRunConfig,
    build_operating_table,
)

DURATION_US = 10_000.0          # the reference's tables: 30 ms
SPOT_ENV_US = 8_000.0           # its environment spot check: 20 ms


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain sweeps' small tensors gain nothing from intra-op threads;
    one keeps a parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_table(**kw):
    args = dict(
        rhos=[0.15, 0.4, 0.65],
        target_mean_latency_us=15.0,
        t_s_grid=np.linspace(4.0, 48.0, 6),
        t_l_grid=[150.0, 500.0],
        m_grid=(2, 3),
        cfg=SimRunConfig(duration_us=DURATION_US),
        seeds=(0,),
        slot_us=1.0,
        device="cpu",
    )
    args.update(kw)
    return build_operating_table(**args)


@pytest.fixture(scope="module")
def table():
    return _tiny_table()


def test_build_meets_target_and_scales_cpu_with_load(table):
    assert all(p.meets_target for p in table.points)
    assert all(p.mean_latency_us <= table.target_mean_latency_us
               for p in table.points)
    assert all(p.loss_fraction <= 1e-3 for p in table.points)
    cpus = [p.cpu_fraction for p in table.points]
    assert cpus == sorted(cpus)                  # more load, more CPU
    assert cpus[-1] < 1.0                        # still beats busy-poll


def test_spot_check_against_event_engine_passes():
    # same tiny grid, now cross-examined by the exact engine
    _tiny_table(spot_check=2)


def test_table_records_its_calibration_environment(table):
    """Tentpole: the table carries the SimRunConfig it was calibrated
    in, sleep model and interference knobs included, through JSON."""
    from repro_torch.runtime import OperatingTable

    env = table.environment
    assert env is not None
    assert env["duration_us"] == DURATION_US
    assert env["interference_prob"] == 0.0
    assert env["stall_rate_per_us"] == 0.0
    assert "base_us" in env["sleep_model"]
    rt = OperatingTable.from_json(table.to_json())
    assert rt.environment == env
    assert rt == table


def test_fleet_calibration_shrinks_host_budget_and_records_fleet():
    """A fleet-aware table gives hosts a latency budget shrunk by the
    share-weighted topology delay at the fleet-aggregate peak rate, and
    records the FleetConfig in its environment (JSON-safe)."""
    from repro_torch.runtime import FleetConfig, OperatingTable

    fleet = FleetConfig(n_hosts=8, far_fraction=0.5, near_cost_us=1.0,
                        far_cost_us=3.0, link_rate_mpps=200.0)
    table = _tiny_table(fleet=fleet)
    cfg = SimRunConfig(duration_us=DURATION_US)
    topo = fleet.mean_topo_delay_us(0.65 * cfg.service_rate_mpps * 8)
    assert topo > 0.0
    assert table.target_mean_latency_us == pytest.approx(15.0 - topo)
    assert table.environment["fleet"]["n_hosts"] == 8
    assert table.environment["fleet"]["far_fraction"] == 0.5
    rt = OperatingTable.from_json(table.to_json())
    assert rt.environment["fleet"]["link_rate_mpps"] == 200.0
    # a topology that eats the whole budget is rejected loudly
    greedy = FleetConfig(n_hosts=8, far_fraction=1.0, far_cost_us=20.0)
    with pytest.raises(ValueError, match="latency target"):
        _tiny_table(fleet=greedy)


def test_noisy_host_calibration_is_contention_honest():
    """Tentpole: build_operating_table in an interference environment
    (a) records that environment, (b) spot-checks against the event
    engine WITHOUT quieting the config first, and (c) produces a table
    whose points reflect the noisy host (higher latency than the quiet
    table at the same grid/loads)."""
    noisy_cfg = SimRunConfig(duration_us=DURATION_US,
                             interference_prob=0.2,
                             interference_mean_us=15.0,
                             stall_rate_per_us=1.0 / 5000.0,
                             stall_mean_us=100.0)
    noisy = _tiny_table(cfg=noisy_cfg, target_mean_latency_us=40.0,
                        max_loss=0.05, spot_check=2)
    assert noisy.environment["interference_prob"] == 0.2
    assert noisy.environment["stall_rate_per_us"] == 1.0 / 5000.0
    quiet = _tiny_table(target_mean_latency_us=40.0, max_loss=0.05)
    for np_, qp in zip(noisy.points, quiet.points):
        assert np_.mean_latency_us > qp.mean_latency_us


def test_spot_check_runs_in_the_calibration_environment(monkeypatch):
    """The event-engine spot check must see the caller's interference
    config — the old code laundered noisy tables through a quieted
    replace(cfg, interference_prob=0, stall_rate_per_us=0)."""
    from repro_torch.runtime import calibrate as cal

    seen_cfgs = []
    real = cal._event_sim_point

    def spy(p, cfg, rate):
        seen_cfgs.append(cfg)
        return real(p, cfg, rate)

    monkeypatch.setattr(cal, "_event_sim_point", spy)
    noisy_cfg = SimRunConfig(duration_us=SPOT_ENV_US,
                             interference_prob=0.15,
                             interference_mean_us=10.0,
                             stall_rate_per_us=1.0 / 8000.0,
                             stall_mean_us=80.0)
    _tiny_table(cfg=noisy_cfg, target_mean_latency_us=40.0,
                max_loss=0.05, spot_check=1)
    assert seen_cfgs, "spot check did not run"
    for c in seen_cfgs:
        assert c.interference_prob == 0.15
        assert c.stall_rate_per_us == 1.0 / 8000.0


def test_multi_queue_build_operating_table_regression():
    """Satellite bugfix: the analytic guard used a literal-[0] n_queues
    placeholder and the aggregate rho, so every multi-queue lattice was
    compared against the wrong closed form and wholesale-rejected
    (tables fell back to meets_target=False rows).  With the per-queue
    prediction, a plainly feasible multi-queue grid calibrates."""
    cfg = SimRunConfig(duration_us=DURATION_US, n_queues=2)
    tbl = _tiny_table(cfg=cfg, target_mean_latency_us=25.0)
    assert all(p.meets_target for p in tbl.points)
    assert tbl.environment["n_queues"] == 2
    cpus = [p.cpu_fraction for p in tbl.points]
    assert cpus == sorted(cpus)


def test_guard_mask_uses_per_queue_load():
    """Direct unit check of the fixed meshgrid: at n_queues=nq the
    guard's prediction is nq * general(ts, tl, m, p(rho/nq))."""
    from repro_torch.core import analytics
    from repro_torch.runtime.calibrate import analytic_guard_mask

    ts, tl, m, rho, nq = 12.0, 300.0, 3, 0.6, 4
    pred_q = float(nq * analytics.mean_vacation_general(
        ts, tl, m, analytics.primary_prob(rho / nq)))
    vac = np.full((1, 1, 1, 1, 1), pred_q)
    ok = analytic_guard_mask(vac, [ts], [tl], [m], [rho],
                             guard_rel=0.05, slot_us=0.0, n_queues=(nq,))
    assert ok.all()
    # the aggregate-rho prediction (the old bug) is far outside the band
    pred_agg = float(analytics.mean_vacation_general(
        ts, tl, m, analytics.primary_prob(rho)))
    vac_bad = np.full((1, 1, 1, 1, 1), pred_agg)
    assert not analytic_guard_mask(vac_bad, [ts], [tl], [m], [rho],
                                   guard_rel=0.05, slot_us=0.0,
                                   n_queues=(nq,)).any()


def test_guard_mask_interference_slack_widens_band():
    cfg = SimRunConfig(interference_prob=0.25, interference_mean_us=20.0,
                       stall_rate_per_us=1.0 / 4000.0, stall_mean_us=100.0)
    slack = cfg.interference_slack_us()
    assert slack == pytest.approx(0.25 * 20.0 + 100.0 ** 2 / 4000.0)
    from repro_torch.core import analytics
    from repro_torch.runtime.calibrate import analytic_guard_mask

    ts, tl, m, rho = 10.0, 200.0, 2, 0.5
    pred = float(analytics.mean_vacation_general(
        ts, tl, m, analytics.primary_prob(rho)))
    # a measurement shifted by almost the whole slack passes only when
    # the slack is threaded through
    vac = np.full((1, 1, 1, 1, 1), pred * 1.05 + slack * 0.9)
    common = dict(guard_rel=0.05, slot_us=0.0)
    assert analytic_guard_mask(vac, [ts], [tl], [m], [rho],
                               slack_us=slack, **common).all()
    assert not analytic_guard_mask(vac, [ts], [tl], [m], [rho],
                                   **common).any()


def test_lookup_is_conservative_and_interp_clamps(table):
    lo, hi = table.points[0], table.points[-1]
    # below the ladder: governed by the lowest calibrated load
    assert table.lookup(0.0) == lo
    # between rungs: governed by the next rung UP (conservative)
    mid_rho = (table.points[0].rho + table.points[1].rho) / 2
    assert table.lookup(mid_rho) == table.points[1]
    # above the ladder: clamped to the top rung
    assert table.lookup(0.99) == hi
    # interpolation clamps outside the calibrated range
    assert table.timeouts_us(0.0) == (lo.t_s_us, lo.t_l_us)
    assert table.timeouts_us(1.0) == (hi.t_s_us, hi.t_l_us)
    t_s_mid, _ = table.timeouts_us(mid_rho)
    assert (min(lo.t_s_us, table.points[1].t_s_us) <= t_s_mid
            <= max(lo.t_s_us, table.points[1].t_s_us))


def test_json_roundtrip_and_save_load(table, tmp_path):
    assert OperatingTable.from_json(table.to_json()) == table
    path = tmp_path / "op_table.json"
    table.save(path)
    assert OperatingTable.load(path) == table


def test_points_sorted_and_validated():
    pts = (OperatingPoint(rho=0.7, t_s_us=10.0, t_l_us=500.0, m=3,
                          mean_latency_us=8.0, cpu_fraction=0.7,
                          loss_fraction=0.0),
           OperatingPoint(rho=0.2, t_s_us=40.0, t_l_us=500.0, m=2,
                          mean_latency_us=14.0, cpu_fraction=0.2,
                          loss_fraction=0.0))
    t = OperatingTable(target_mean_latency_us=15.0, service_rate_mpps=29.76,
                       points=pts)
    assert [p.rho for p in t.points] == [0.2, 0.7]
    with pytest.raises(ValueError):
        OperatingTable(target_mean_latency_us=15.0,
                       service_rate_mpps=29.76, points=())


# ---------------------------------------------------------------------------
# controller / policy / server integration
# ---------------------------------------------------------------------------

def _hand_table():
    return OperatingTable(
        target_mean_latency_us=15.0, service_rate_mpps=29.76,
        points=(
            OperatingPoint(rho=0.1, t_s_us=60.0, t_l_us=800.0, m=2,
                           mean_latency_us=12.0, cpu_fraction=0.1,
                           loss_fraction=0.0),
            OperatingPoint(rho=0.9, t_s_us=10.0, t_l_us=400.0, m=3,
                           mean_latency_us=9.0, cpu_fraction=0.9,
                           loss_fraction=0.0),
        ))


def test_controller_feedforward_follows_table():
    tbl = _hand_table()
    cfg = MetronomeConfig(m=3, v_target_us=10.0, t_long_us=500.0)
    ctl = MetronomeController(cfg, feedforward=tbl)
    # init at rho_init=0.5: the table's interpolated surface, not Eq 12
    ts_ff, tl_ff = tbl.timeouts_us(cfg.rho_init)
    assert ctl.t_short_us == pytest.approx(ts_ff)
    assert ctl.t_long_us == pytest.approx(tl_ff)
    # drive rho high: T_S slides toward the high-load rung
    for _ in range(200):
        ctl.on_cycle_end(busy_us=40.0, vacation_us=10.0)
    assert ctl.rho > 0.75
    ts_hi, tl_hi = tbl.timeouts_us(ctl.rho)
    assert ctl.t_short_us == pytest.approx(ts_hi)
    assert ctl.timeout_us(primary=False) == pytest.approx(tl_hi)
    # feed-forward beats the Eq-12 upper clamp at low load: the 60us
    # low-load rung survives even though resolved_ts_max() is 30us
    ctl2 = MetronomeController(cfg, feedforward=tbl)
    for _ in range(200):
        ctl2.on_cycle_end(busy_us=0.5, vacation_us=60.0)
    assert ctl2.t_short_us > cfg.resolved_ts_max()


def test_controller_clamps_tl_above_ts_with_adversarial_table():
    """Satellite bugfix: a calibrated rung whose T_L is below T_S (or a
    pathological blend) must not invert the backup/primary roles —
    backups would fire before primaries.  The controller clamps
    T_L >= T_S at every derivation, and releases the clamp once T_S
    falls again."""
    adversarial = OperatingTable(
        target_mean_latency_us=15.0, service_rate_mpps=29.76,
        points=(
            # low-load rung: huge T_S, tiny T_L — inverted on purpose
            OperatingPoint(rho=0.1, t_s_us=120.0, t_l_us=8.0, m=2,
                           mean_latency_us=12.0, cpu_fraction=0.1,
                           loss_fraction=0.0),
            OperatingPoint(rho=0.9, t_s_us=10.0, t_l_us=400.0, m=3,
                           mean_latency_us=9.0, cpu_fraction=0.9,
                           loss_fraction=0.0),
        ))
    cfg = MetronomeConfig(m=3, v_target_us=10.0, t_long_us=500.0)
    ctl = MetronomeController(cfg, feedforward=adversarial)
    # drive rho low: the table feeds T_S=120, T_L=8 — the clamp holds
    for _ in range(300):
        ctl.on_cycle_end(busy_us=0.5, vacation_us=100.0)
        assert ctl.t_long_us >= ctl.t_short_us
        assert (ctl.timeout_us(primary=False)
                >= ctl.timeout_us(primary=True))
    assert ctl.t_short_us > 100.0          # the inverted rung is active
    # back at high load the table is sane again and the clamp releases:
    # T_L returns to the table's 400us rung, well above T_S
    for _ in range(300):
        ctl.on_cycle_end(busy_us=40.0, vacation_us=10.0)
    assert ctl.rho > 0.75
    assert ctl.t_long_us > 4 * ctl.t_short_us
    assert ctl.t_long_us >= ctl.t_short_us
    # the clamp also guards the pure-Eq-12 path (no table): a config
    # with T_L below the Eq-12 T_S band cannot invert either
    ctl2 = MetronomeController(
        MetronomeConfig(m=3, v_target_us=200.0, t_long_us=50.0))
    for _ in range(50):
        ctl2.on_cycle_end(busy_us=0.5, vacation_us=300.0)
        assert ctl2.t_long_us >= ctl2.t_short_us


def test_feedforward_weight_blends_back_to_eq12():
    tbl = _hand_table()
    cfg0 = MetronomeConfig(m=3, v_target_us=10.0, feedforward_weight=0.0)
    ctl = MetronomeController(cfg0, feedforward=tbl)
    plain = MetronomeController(MetronomeConfig(m=3, v_target_us=10.0))
    for c in (ctl, plain):
        c.on_cycle_end(busy_us=20.0, vacation_us=10.0)
    assert ctl.t_short_us == pytest.approx(plain.t_short_us)
    assert ctl.t_long_us == pytest.approx(cfg0.t_long_us)


def test_policy_carries_table_across_resets():
    tbl = _hand_table()
    pol = MetronomePolicy(MetronomeConfig(m=3, v_target_us=10.0),
                          operating_table=tbl)
    pol.reset()
    assert pol.controller.feedforward is tbl
    ts_ff, _ = tbl.timeouts_us(pol.controller.rho)
    assert pol.t_short_us == pytest.approx(ts_ff)


def test_server_loads_operating_table_at_startup(tmp_path):
    from repro_torch.serving import Server

    class _NullEngine:
        def submit(self, reqs):
            pass

        def pump(self):
            return False

    tbl = _hand_table()
    path = tmp_path / "table.json"
    tbl.save(path)
    pol = MetronomePolicy(MetronomeConfig(m=2, v_target_us=2_000.0,
                                          t_long_us=50_000.0))
    srv = Server(_NullEngine(), pol, operating_table=str(path))
    assert srv.operating_table == tbl
    assert pol.controller.feedforward == tbl
    ts_ff, _ = tbl.timeouts_us(pol.controller.rho)
    assert pol.controller.t_short_us == pytest.approx(ts_ff)
    # policies without a controller cannot take a table
    from repro_torch.runtime import FixedPeriodPolicy
    with pytest.raises(ValueError, match="no .*controller"):
        Server(_NullEngine(), FixedPeriodPolicy(50.0), operating_table=tbl)


# ---------------------------------------------------------------------------
# acceptance verdict: calibrated beats (<=) the fixed-t_s baseline
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_sweep_frontier_verdict_calibrated_beats_fixed():
    """The benchmark's verdict row (benchmarks/sweep_frontier.py's quick
    lattice and verdict, on the port): per load, the calibrated table meets
    the latency target at CPU <= the best fixed configuration."""
    import torch

    from repro_torch.runtime import SweepGrid, simulate_batch
    from repro_torch.runtime.calibrate import analytic_guard_mask

    device = "cuda" if torch.cuda.is_available() else "cpu"
    t_s_grid, t_l_grid, m_grid = np.linspace(4.0, 60.0, 8), np.asarray([120.0, 500.0]), (2, 3)
    rhos, target, max_loss = np.asarray([0.15, 0.35, 0.55, 0.75]), 15.0, 1e-3
    cfg = SimRunConfig(duration_us=30_000.0)
    grid = SweepGrid.product(t_s_us=t_s_grid, t_l_us=t_l_grid, m=m_grid,
                             rate_mpps=rhos * 29.76, seeds=(0,))
    bs = simulate_batch(grid, cfg, slot_us=1.0, device=device)
    lat = bs.reshaped("mean_latency_us").mean(axis=-1)[:, :, :, 0, :]
    cpu = bs.reshaped("cpu_fraction").mean(axis=-1)[:, :, :, 0, :]
    loss = bs.reshaped("loss_fraction").mean(axis=-1)[:, :, :, 0, :]
    vac = bs.reshaped("mean_vacation_us").mean(axis=-1)
    valid = analytic_guard_mask(vac, t_s_grid, t_l_grid, m_grid, rhos, guard_rel=0.6,
                                slot_us=1.0, slack_us=cfg.interference_slack_us())[:, :, :, 0, :]
    table = build_operating_table(rhos=rhos, target_mean_latency_us=target, t_s_grid=t_s_grid,
                                  t_l_grid=t_l_grid, m_grid=m_grid, cfg=cfg, seeds=(0,),
                                  slot_us=1.0, max_loss=max_loss, sweep=bs, device=device)
    assert all(p.meets_target for p in table.points)
    meets_all = (valid & (lat <= target) & (loss <= max_loss)).all(axis=-1)
    assert meets_all.any()
    total_cpu = np.where(meets_all, cpu.sum(axis=-1), np.inf)
    i, j, l = np.unravel_index(int(np.argmin(total_cpu)), total_cpu.shape)
    tab_cpu = np.asarray([p.cpu_fraction for p in table.points])
    assert np.all(tab_cpu <= cpu[i, j, l, :] + 1e-9)


# ---------------------------------------------------------------------------
# the port's own: the event-jump sweep, reference sweeps, JSON both ways
# ---------------------------------------------------------------------------

def test_adaptive_stepping_builds_the_table_and_passes_spot_checks():
    """The calibration path of the port: the lattice through the event-jump
    sweep (``stepping="adaptive"``, its plain version here), spot-checked
    against the exact event engine, meets the target with CPU rising with
    load."""
    tbl = _tiny_table(stepping="adaptive", spot_check=2)
    assert all(p.meets_target for p in tbl.points)
    cpus = [p.cpu_fraction for p in tbl.points]
    assert cpus == sorted(cpus) and cpus[-1] < 1.0


def _ref_lattice():
    return dict(rhos=[0.15, 0.4, 0.65], target_mean_latency_us=15.0,
                t_s_grid=np.linspace(4.0, 48.0, 6), t_l_grid=[150.0, 500.0], m_grid=(2, 3),
                seeds=(0, 1), slot_us=1.0)


@pytest.mark.parametrize("stepping", ("fixed", "adaptive"))
def test_reference_sweep_picks_the_references_table(stepping):
    """``build_operating_table(sweep=...)`` with the port's ``BatchStats``
    holding the reference's arrays selects the reference's table, point for
    point (the selection, the guard and the seed averages are the
    reference's code)."""
    from repro.runtime import SimRunConfig as RefConfig
    from repro.runtime import SweepGrid as RefGrid
    from repro.runtime import build_operating_table as ref_build
    from repro.runtime import simulate_batch as ref_simulate_batch
    from repro_torch.runtime import BatchStats, SweepGrid

    kw = _ref_lattice()
    cfg, ref_cfg = SimRunConfig(duration_us=DURATION_US), RefConfig(duration_us=DURATION_US)
    axes = dict(t_s_us=kw["t_s_grid"], t_l_us=kw["t_l_grid"], m=kw["m_grid"], n_queues=(1,),
                rate_mpps=np.asarray(kw["rhos"]) * cfg.service_rate_mpps, seeds=kw["seeds"])
    ref_bs = ref_simulate_batch(RefGrid.product(**axes), ref_cfg, slot_us=1.0,
                                stepping=stepping)
    fields = ("offered", "dropped", "serviced", "wakeups", "busy_tries", "cycles", "awake_us",
              "lat_area", "vac_sum", "nv_sum", "ts_arms", "energy_uj", "win", "n_steps",
              "forced_steps", "sim_time_us", "final_backlog")
    port_bs = BatchStats(grid=SweepGrid.product(**axes), cfg=cfg, slot_us=1.0,
                         stepping=stepping, scan_len=ref_bs.scan_len,
                         **{f: np.asarray(getattr(ref_bs, f)) for f in fields})
    want = ref_build(cfg=ref_cfg, sweep=ref_bs, stepping=stepping, **kw)
    got = build_operating_table(cfg=cfg, sweep=port_bs, stepping=stepping, device="cpu", **kw)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    with pytest.raises(ValueError, match="precomputed sweep"):
        build_operating_table(cfg=cfg, sweep=port_bs, device="cpu",
                              stepping="fixed" if stepping == "adaptive" else "adaptive", **kw)


def test_json_round_trip_with_the_reference_both_ways(table, tmp_path):
    """A table the port saves loads in the reference's ``OperatingTable``
    as the same table, and the other way round."""
    from repro.runtime import OperatingTable as RefTable

    path = tmp_path / "port.json"
    table.save(path)
    ref = RefTable.load(path)
    assert json.loads(ref.to_json()) == json.loads(table.to_json())
    assert ref.timeouts_us(0.3) == table.timeouts_us(0.3)
    back = tmp_path / "ref.json"
    ref.save(back)
    assert OperatingTable.load(back) == table
