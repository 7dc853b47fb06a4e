"""tests/test_apps.py on the port: the co-run application layer (AppLoad
protocol, the concrete loads, the Runtime/Server wiring, and the demand ->
interference contention mapping of the paper's Sec 5.6 CPU-sharing
scenario), with ``MatmulAppLoad`` as the port's ``torch.matmul`` tenant."""

import time

import numpy as np
import pytest
import torch

from repro_torch.core import MetronomeConfig
from repro_torch.runtime import (
    AppLoad,
    BoundedQueue,
    BusyPollPolicy,
    DutyCycleBurner,
    MatmulAppLoad,
    MetronomePolicy,
    PoissonWorkload,
    Runtime,
    RunStats,
    SimRunConfig,
    co_run_config,
    simulate_run,
)


def _policy(m=2):
    return MetronomePolicy(MetronomeConfig(m=m, v_target_us=500.0,
                                           t_long_us=5_000.0))


def test_loads_satisfy_protocol():
    assert isinstance(DutyCycleBurner(0.3), AppLoad)
    assert isinstance(MatmulAppLoad(n=32), AppLoad)
    assert DutyCycleBurner(0.3, threads=2).threads == 2
    assert DutyCycleBurner(0.3).demand == pytest.approx(0.3)
    with pytest.raises(ValueError):
        DutyCycleBurner(-0.1)


def test_duty_cycle_burner_burns_its_share():
    app = DutyCycleBurner(demand=0.5, period_us=2_000.0)
    app.reset()
    t0 = time.perf_counter_ns()
    for _ in range(3):
        assert app.step() == 1
    wall_us = (time.perf_counter_ns() - t0) / 1e3
    # 3 quanta of a 2ms period: at least the burn phases, and not
    # wildly more than the full periods (generous CI-scheduler slack)
    assert wall_us >= 3 * 0.5 * 2_000.0 * 0.8
    assert wall_us <= 3 * 2_000.0 * 10


def test_runtime_co_runs_app_load_and_reports_progress():
    q = [BoundedQueue(1024)]
    rt = Runtime(q, process=lambda items: None, policy=_policy(),
                 app_load=DutyCycleBurner(demand=0.5, period_us=1_000.0))
    rt.start()
    for i in range(100):
        q[0].push(i)
    time.sleep(0.25)
    st = rt.stop()
    assert st.items == 100
    assert st.app_ops > 0
    assert st.app_cpu_ns > 0
    assert 0.0 < st.app_cpu_fraction
    assert rt._app_threads == []           # joined and cleared
    # the I/O task's CPU accounting excludes the app's burn
    assert st.awake_ns + st.app_cpu_ns <= 2 * st.duration_ns


def test_matmul_app_load_steps_on_torch():
    app = MatmulAppLoad(n=32, device="cpu")
    app.reset()
    assert app.step() == 1
    assert app.step() == 1
    assert app._y.shape == (32, 32) and app._y.device.type == "cpu"
    torch.testing.assert_close(app._y, app._x @ app._x)


def test_matmul_app_load_defaults_to_cuda_and_never_falls_back():
    app = MatmulAppLoad(n=32)
    assert app.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            app.reset()
        assert app._x is None


@pytest.mark.gpu
def test_matmul_app_load_steps_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    app = MatmulAppLoad(n=256)
    app.reset()
    assert app.step() == 1
    assert app._y.device.type == "cuda"
    torch.testing.assert_close(app._y, app._x @ app._x)


def test_server_app_load_passthrough():
    from repro_torch.serving import Server

    class _NullEngine:
        def submit(self, reqs):
            pass

        def pump(self):
            return False

    srv = Server(_NullEngine(), _policy(),
                 app_load=DutyCycleBurner(demand=0.4, period_us=1_000.0))
    srv.start()
    time.sleep(0.2)
    st = srv.stop()
    assert st.app_ops > 0
    assert st.app_cpu_ns > 0


def test_run_stats_merge_adds_app_counters():
    a = RunStats(app_ops=3, app_cpu_ns=1_000)
    b = RunStats(app_ops=5, app_cpu_ns=2_500)
    a.merge(b)
    assert a.app_ops == 8
    assert a.app_cpu_ns == 3_500


# ---------------------------------------------------------------------------
# demand -> SimRunConfig contention mapping
# ---------------------------------------------------------------------------

def test_co_run_config_zero_demand_is_identity():
    cfg = SimRunConfig()
    assert co_run_config(cfg, 0.0) is cfg
    assert co_run_config(cfg, 0.0, spin=True) is cfg
    with pytest.raises(ValueError):
        co_run_config(cfg, -0.5)


def test_co_run_config_sleepwake_mapping():
    cfg = SimRunConfig()
    c = co_run_config(cfg, 0.6, preempt_mean_us=8.0,
                      pileup_every_us=8_000.0, pileup_mean_us=120.0)
    assert c.interference_prob == pytest.approx(0.6)
    assert c.interference_mean_us == pytest.approx(8.0)
    assert c.stall_rate_per_us == pytest.approx(0.6 / 8_000.0)
    assert c.stall_mean_us == pytest.approx(120.0)
    # demand saturates at one core
    assert co_run_config(cfg, 2.0).interference_prob == pytest.approx(1.0)


def test_co_run_config_spin_mapping_caps_at_fair_share():
    cfg = SimRunConfig()
    c = co_run_config(cfg, 0.3, spin=True, quantum_us=250.0)
    assert c.stall_rate_per_us == pytest.approx(0.3 / 250.0)
    assert c.stall_mean_us == pytest.approx(250.0)
    assert c.interference_prob == 0.0      # a spinner has no wakes
    # against an always-runnable spinner the app's share caps at 1/2
    c_hi = co_run_config(cfg, 0.9, spin=True, quantum_us=250.0)
    assert c_hi.stall_rate_per_us == pytest.approx(0.5 / 250.0)


def test_co_run_config_layers_on_existing_interference():
    base = SimRunConfig(interference_prob=0.2, interference_mean_us=10.0,
                        stall_rate_per_us=1e-4, stall_mean_us=50.0)
    c = co_run_config(base, 0.5, preempt_mean_us=8.0,
                      pileup_every_us=10_000.0, pileup_mean_us=100.0)
    # Bernoulli union, expected-delay-preserving mean
    assert c.interference_prob == pytest.approx(1 - 0.8 * 0.5)
    exp_delay = 0.2 * 10.0 + 0.5 * 8.0
    assert (c.interference_prob * c.interference_mean_us
            == pytest.approx(exp_delay))
    assert c.stall_rate_per_us == pytest.approx(1e-4 + 0.5 / 10_000.0)
    # stall means combine weighted by rate contribution
    assert (c.stall_rate_per_us * c.stall_mean_us
            == pytest.approx(1e-4 * 50.0 + 0.5 / 10_000.0 * 100.0))


def test_co_run_simulation_shows_the_sharing_asymmetry():
    """The headline: under a co-run app, sleep&wake keeps near-zero loss
    while the descheduled spinner starts dropping — the simulation-side
    counterpart of benchmarks/cpu_sharing.py's verdict."""
    cfg = SimRunConfig(duration_us=40_000.0, queue_capacity=4096)
    wl = lambda: PoissonWorkload(0.45 * 29.76)  # noqa: E731
    d = 0.6
    rs_m = simulate_run(_paper_metronome(), wl(), co_run_config(cfg, d))
    rs_b = simulate_run(BusyPollPolicy(), wl(),
                        co_run_config(cfg, d, spin=True))
    rs_b0 = simulate_run(BusyPollPolicy(), wl(), cfg)
    assert rs_m.loss_fraction < 1e-3
    assert rs_b.loss_fraction > 0.01
    assert rs_b.mean_latency_us > 20 * max(rs_b0.mean_latency_us, 1e-9)
    assert np.isfinite(rs_m.p99_latency_us)


def _paper_metronome():
    return MetronomePolicy(MetronomeConfig())
