"""tests/test_batched_engine.py on the port: the batched engine
(``repro_torch.runtime.batched``) on the CPU, where
``simulate_batch(..., device="cpu")`` runs the sweep kernels' plain
versions; the tests that do not need the fleet.

The plain version runs ~10^4 slots a second on the CPU, so the ports of
tests that simulate 30-100 ms run 5-30 ms (each names its cut); their
checks are the reference's.  The reference's 120 ms parity bands against
the event engine, both steppings and the event-jump sweep against the
fixed-slot one (on 8-seed means, ``_band_check`` says why), are ported
under the ``slow`` marker, as in the reference; ``chip_smoke.py`` runs them
through the kernels on the card."""

import numpy as np
import pytest
import torch

from repro.runtime import SweepGrid as RefGrid
from repro_torch.core import MetronomeConfig
from repro_torch.core import analytics as an
from repro_torch.kernels.slot_sweep import slot_sweep
from repro_torch.runtime import (
    HR_SLEEP_MODEL,
    MetronomePolicy,
    PoissonWorkload,
    SimRunConfig,
    SweepGrid,
    simulate_batch,
    simulate_run,
)
from repro_torch.runtime import batched
from repro_torch.runtime.simcore import PERFECT_SLEEP_MODEL


# -- tests/test_batched_engine.py (not slow) on the port ----------------------

LAT_ABS_US, LAT_REL = 1.5, 0.12
CPU_ABS, CPU_REL = 0.02, 0.05
ILAT_ABS_US, ILAT_REL = 4.5, 0.22
ICPU_ABS, ICPU_REL = 0.025, 0.06
ILOSS_ABS = 0.03
INTERFERENCE_ENV = dict(interference_prob=0.25, interference_mean_us=20.0,
                        stall_rate_per_us=1.0 / 4000.0, stall_mean_us=150.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain sweeps' small tensors gain nothing from intra-op threads;
    one keeps a parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_configs(n=24, seed=42):
    rng = np.random.default_rng(seed)
    pts = []
    for i in range(n):
        t_s = float(rng.uniform(5.0, 40.0))
        pts.append(dict(t_s_us=t_s, t_l_us=float(t_s * rng.uniform(4.0, 25.0)),
                        m=int(rng.integers(1, 5)),
                        rate_mpps=float(rng.uniform(0.15, 0.85) * 29.76), seed=i))
    return pts


def test_interference_increases_latency_and_loss_vs_quiet_baseline():
    """Directional sanity: switching the noisy-host environment on strictly
    raises mean vacation, mean sojourn, and loss over the quiet baseline at
    fixed grid/seed (20 ms a point; the reference runs 60)."""
    pts = [dict(t_s_us=12.0, t_l_us=300.0, m=3, rate_mpps=0.5 * 29.76, seed=s)
           for s in range(3)]
    quiet = SimRunConfig(duration_us=20_000.0, sleep_model=HR_SLEEP_MODEL)
    noisy = SimRunConfig(duration_us=20_000.0, sleep_model=HR_SLEEP_MODEL,
                         **INTERFERENCE_ENV)
    bq = simulate_batch(SweepGrid.of_points(pts), quiet, slot_us=0.5, device="cpu")
    bn = simulate_batch(SweepGrid.of_points(pts), noisy, slot_us=0.5, device="cpu")
    assert np.all(bn.mean_vacation_us > bq.mean_vacation_us)
    assert np.all(bn.mean_latency_us > bq.mean_latency_us)
    assert float(bn.loss_fraction.mean()) > float(bq.loss_fraction.mean())


def test_thousand_point_sweep_is_one_call(monkeypatch):
    """A >= 1000-point grid runs through one call of the sweep (on the card,
    one kernel launch; here, one plain-version call with no launch) and
    returns finite, load-ordered metrics (5 ms, the reference 10)."""
    grid = SweepGrid.product(t_s_us=np.linspace(4.0, 40.0, 8), t_l_us=[150.0, 500.0],
                             m=[2, 3, 4], rate_mpps=np.linspace(2.0, 25.0, 9),
                             seeds=(0, 1, 2))
    assert len(grid) >= 1000
    calls = []
    real = batched.slot_sweep

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return real(*args, **kw)

    launches = slot_sweep.launches
    monkeypatch.setattr(batched, "slot_sweep", counted)
    bs = simulate_batch(grid, SimRunConfig(duration_us=5_000.0), slot_us=1.0, device="cpu")
    assert calls == [len(grid)] and slot_sweep.launches == launches
    assert len(bs) == len(grid)
    for name in ("mean_latency_us", "cpu_fraction", "loss_fraction", "mean_vacation_us",
                 "wakeups"):
        assert np.isfinite(getattr(bs, name)).all(), name
    # CPU grows with offered load on average (marginalize everything else)
    cpu = bs.reshaped("cpu_fraction").mean(axis=(0, 1, 2, 3, 5))
    assert np.all(np.diff(cpu) > 0)
    # and with more threads at fixed everything else
    cpu_m = bs.reshaped("cpu_fraction").mean(axis=(0, 1, 3, 4, 5))
    assert cpu_m[-1] > cpu_m[0]


def test_batched_latency_matches_closed_form_in_stable_region():
    """Batched mean latency within tolerance of the E[V^2]/(2 E[V]) closed
    form (high-load regime, perfect timers; 30 ms, the reference 100)."""
    pts = []
    for t_s in (10.0, 20.0, 40.0):
        for m in (1, 2, 3):
            pts.append(dict(t_s_us=t_s, t_l_us=20.0 * t_s, m=m, rate_mpps=0.5 * 29.76,
                            seed=7))
    cfg = SimRunConfig(duration_us=30_000.0, sleep_model=PERFECT_SLEEP_MODEL)
    bs = simulate_batch(SweepGrid.of_points(pts), cfg, slot_us=0.5, device="cpu")
    for i, p in enumerate(pts):
        pred = float(an.mean_sojourn_high(p["t_s_us"], p["t_l_us"], p["m"]))
        got = float(bs.mean_latency_us[i])
        assert got == pytest.approx(pred, rel=0.25), (p, got, pred)


def test_batched_mean_vacation_tracks_eq6():
    """High load, T_L >> T_S: measured mean vacation ~= Eq (6) (30 ms, the
    reference 100)."""
    pts = [dict(t_s_us=10.0, t_l_us=500.0, m=m, rate_mpps=14.88, seed=3)
           for m in (1, 2, 3, 4)]
    cfg = SimRunConfig(duration_us=30_000.0, sleep_model=PERFECT_SLEEP_MODEL)
    bs = simulate_batch(SweepGrid.of_points(pts), cfg, slot_us=0.5, device="cpu")
    for i, p in enumerate(pts):
        pred = float(an.mean_vacation_high(10.0, 500.0, p["m"]))
        assert float(bs.mean_vacation_us[i]) == pytest.approx(pred, rel=0.15)


def test_multi_queue_batched_accounting():
    """n_queues > 1: offered tracks the rate, nothing is lost at light load,
    and CPU stays below one thread-count's worth (20 ms, the reference 50)."""
    grid = SweepGrid.of_points([dict(t_s_us=15.0, t_l_us=300.0, m=4, n_queues=4,
                                     rate_mpps=10.0, seed=0)])
    cfg = SimRunConfig(duration_us=20_000.0)
    bs = simulate_batch(grid, cfg, slot_us=0.5, device="cpu")
    assert bs.offered[0] == pytest.approx(10.0 * 20_000.0, rel=0.05)
    assert float(bs.loss_fraction[0]) < 1e-3
    assert 0.0 < float(bs.cpu_fraction[0]) < 4.0
    assert float(bs.serviced[0]) <= bs.offered[0]


def test_to_run_stats_conversion():
    grid = SweepGrid.of_points([dict(t_s_us=10.0, t_l_us=500.0, m=3, rate_mpps=14.88,
                                     seed=0)])
    cfg = SimRunConfig(duration_us=10_000.0)      # 10 ms (the reference runs 30)
    bs = simulate_batch(grid, cfg, slot_us=0.5, device="cpu")
    rs = bs.to_run_stats(0)
    assert rs.backend == "batched"
    assert rs.items == int(bs.serviced[0])
    assert rs.cpu_fraction == pytest.approx(float(bs.cpu_fraction[0]), rel=1e-3)
    assert rs.mean_latency_us == pytest.approx(float(bs.mean_latency_us[0]), rel=1e-6)
    assert rs.mean_sojourn_us == pytest.approx(float(bs.mean_latency_us[0]), rel=1e-3)
    s = rs.summary()
    assert s["backend"] == "batched"
    assert s["cpu_fraction"] == pytest.approx(rs.cpu_fraction)


def test_batched_rejects_event_engine_only_features_eagerly():
    """Event-engine-only config fields fail fast, by name, before any
    sweep work (on either device); interference configs are accepted."""
    grid = SweepGrid.of_points([dict(t_s_us=10.0, t_l_us=100.0, m=2, rate_mpps=1.0,
                                     seed=0)])
    bad = SimRunConfig(duration_us=1_000.0, timeseries_bin_us=100.0)
    assert batched.unsupported_config_fields(bad) == ["timeseries_bin_us"]
    with pytest.raises(ValueError, match="timeseries_bin_us"):
        batched.validate_batched_config(bad)
    launches = slot_sweep.launches
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="timeseries_bin_us"):
            simulate_batch(grid, bad, device=device)
    assert slot_sweep.launches == launches
    ok = SimRunConfig(duration_us=1_000.0, interference_prob=0.1,
                      interference_mean_us=10.0, stall_rate_per_us=1e-4,
                      stall_mean_us=50.0)
    assert batched.unsupported_config_fields(ok) == []
    bs = simulate_batch(grid, ok, slot_us=1.0, device="cpu")
    assert np.isfinite(bs.mean_latency_us).all()


def test_sweep_grid_product_shape_and_point():
    grid = SweepGrid.product(t_s_us=[5.0, 10.0], t_l_us=[100.0], m=[2, 3],
                             rate_mpps=[1.0, 2.0, 3.0], seeds=(0, 1))
    assert len(grid) == 2 * 1 * 2 * 1 * 3 * 2
    assert grid.shape == (2, 1, 2, 1, 3, 2)
    p = grid.point(0)
    assert set(p) == set(grid.dims)
    ref = RefGrid.product(t_s_us=[5.0, 10.0], t_l_us=[100.0], m=[2, 3],
                          rate_mpps=[1.0, 2.0, 3.0], seeds=(0, 1))
    for f in grid.dims:
        np.testing.assert_array_equal(getattr(grid, f), getattr(ref, f))
    # reshaped round-trips the cartesian structure
    cfg = SimRunConfig(duration_us=2_000.0)
    bs = simulate_batch(grid, cfg, slot_us=1.0, device="cpu")
    assert bs.reshaped("cpu_fraction").shape == grid.shape


# -- the reference's 120 ms parity bands against the event engine --------------

BAND_SEEDS = 8      # the event-jump sweep against the fixed-slot one: 8-seed means


def _band_check(pts, cfg, lat_abs, lat_rel, cpu_abs, cpu_rel, loss_abs=None):
    """BOTH steppings against the event engine in the band at each config's
    seed, as the reference holds them; and the event-jump sweep against the
    fixed-slot one in the same band on the means over ``BAND_SEEDS`` seeds a
    config (its seed, then seed + 1000 k): the two draw independent sample
    paths, and one seed's noise alone can cross the noisy band (the
    reference's own noisy band test fails on its own draws, PERF.md PR 20).
    Returns the two ``BatchStats``, every seed."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    n = len(pts)
    grid = SweepGrid.of_points([dict(p, seed=p["seed"] + 1000 * k)
                                for k in range(BAND_SEEDS) for p in pts])
    bs = simulate_batch(grid, cfg, slot_us=0.5, device=device)
    ba = simulate_batch(grid, cfg, slot_us=0.5, stepping="adaptive", device=device)
    for i, p in enumerate(pts):
        rs = simulate_run(MetronomePolicy(MetronomeConfig(
            m=p["m"], v_target_us=p["t_s_us"], t_long_us=p["t_l_us"],
            ts_min_us=min(1.0, p["t_s_us"])), adaptive=False),
            PoissonWorkload(p["rate_mpps"]), cfg)
        for tag, b in (("fixed", bs), ("adaptive", ba)):
            lat_b, lat_e = float(b.mean_latency_us[i]), rs.mean_sojourn_us
            cpu_b, cpu_e = float(b.cpu_fraction[i]), rs.cpu_fraction
            assert abs(lat_b - lat_e) <= max(lat_abs, lat_rel * lat_e), (tag, p, lat_b, lat_e)
            assert abs(cpu_b - cpu_e) <= cpu_abs + cpu_rel * cpu_e, (tag, p, cpu_b, cpu_e)
            assert b.wakeups[i] == pytest.approx(rs.wakeups, rel=0.15), tag
            if loss_abs is None:
                assert float(b.loss_fraction[i]) < 1e-3 and rs.loss_fraction < 1e-3, tag
            else:
                assert abs(float(b.loss_fraction[i]) - rs.loss_fraction) <= loss_abs, tag

    def mean(b, metric):
        return getattr(b, metric).reshape(BAND_SEEDS, n).mean(0)

    # adaptive-vs-fixed inside the same band, on the seed means
    lat_f, lat_a = mean(bs, "mean_latency_us"), mean(ba, "mean_latency_us")
    cpu_f, cpu_a = mean(bs, "cpu_fraction"), mean(ba, "cpu_fraction")
    loss_f, loss_a = mean(bs, "loss_fraction"), mean(ba, "loss_fraction")
    for i, p in enumerate(pts):
        assert abs(lat_a[i] - lat_f[i]) <= max(lat_abs, lat_rel * lat_f[i]), (p, lat_a[i],
                                                                              lat_f[i])
        assert abs(cpu_a[i] - cpu_f[i]) <= cpu_abs + cpu_rel * cpu_f[i], p
        if loss_abs is not None:
            assert abs(loss_a[i] - loss_f[i]) <= loss_abs, p
    return bs, ba


@pytest.mark.slow
def test_parity_with_event_engine_24_random_configs():
    bs, ba = _band_check(_random_configs(), SimRunConfig(duration_us=120_000.0,
                                                         sleep_model=HR_SLEEP_MODEL),
                         LAT_ABS_US, LAT_REL, CPU_ABS, CPU_REL)
    # and the whole point of the adaptive kernel: far fewer live steps
    assert float(ba.n_steps.mean()) < 0.35 * float(bs.n_steps.mean())


@pytest.mark.slow
def test_parity_under_interference_16_random_configs():
    _band_check(_random_configs(n=16, seed=7),
                SimRunConfig(duration_us=120_000.0, sleep_model=HR_SLEEP_MODEL,
                             **INTERFERENCE_ENV),
                ILAT_ABS_US, ILAT_REL, ICPU_ABS, ICPU_REL, ILOSS_ABS)
