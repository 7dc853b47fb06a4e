"""tests/test_simulator_invariants.py on the port: hypothesis property
tests on the renewal-system invariants of the port's event engine (through
its copy of the deprecated ``core.simulator`` surface) — for ANY
configuration the simulator must conserve packets, respect capacity, and
keep its accounting self-consistent."""

import numpy as np
import pytest
pytest.importorskip("hypothesis", reason="hypothesis not installed in this environment")
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core.simulator import (
    HR_SLEEP_MODEL,
    NANOSLEEP_MODEL,
    PERFECT_SLEEP_MODEL,
    SimConfig,
    simulate,
)

finite = dict(allow_nan=False, allow_infinity=False)

cfg_st = st.builds(
    SimConfig,
    m=st.integers(min_value=1, max_value=6),
    arrival_rate_mpps=st.floats(min_value=0.01, max_value=20.0, **finite),
    service_rate_mpps=st.floats(min_value=21.0, max_value=60.0, **finite),
    queue_capacity=st.sampled_from([64, 256, 1024, 4096]),
    duration_us=st.just(60_000.0),
    v_target_us=st.floats(min_value=2.0, max_value=50.0, **finite),
    t_long_us=st.floats(min_value=100.0, max_value=1000.0, **finite),
    adaptive=st.booleans(),
    equal_timeouts=st.booleans(),
    sleep_model=st.sampled_from(
        [HR_SLEEP_MODEL, NANOSLEEP_MODEL, PERFECT_SLEEP_MODEL]),
    interference_prob=st.sampled_from([0.0, 0.2]),
    interference_mean_us=st.just(200.0),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
)


@given(cfg=cfg_st)
@settings(max_examples=40, deadline=None)
def test_packet_conservation_and_bounds(cfg):
    r = simulate(cfg)
    # conservation: everything offered is serviced, dropped, or still queued
    backlog = r.offered - r.dropped - r.serviced
    assert backlog >= -1, (r.offered, r.dropped, r.serviced)
    # a vacation's backlog can never exceed the ring
    if r.n_v.size:
        assert float(r.n_v.max()) <= cfg.queue_capacity + 1e-9
    # loss fraction is a probability
    assert 0.0 <= r.loss_fraction <= 1.0
    # CPU: at most M cores' worth of awake time
    assert 0.0 <= r.cpu_fraction <= cfg.m + 1e-9
    # periods are nonnegative and finite
    for arr in (r.vacations_us, r.busies_us):
        if arr.size:
            assert np.isfinite(arr).all()
            assert (arr >= -1e-9).all()
    # latency stats are ordered
    assert r.mean_latency_us <= r.worst_latency_us + 1e-9


@given(cfg=cfg_st)
@settings(max_examples=25, deadline=None)
def test_determinism_same_seed(cfg):
    a, b = simulate(cfg), simulate(cfg)
    assert a.offered == b.offered
    assert a.dropped == b.dropped
    assert a.serviced == b.serviced
    np.testing.assert_array_equal(a.vacations_us, b.vacations_us)


@given(seed=st.integers(min_value=0, max_value=2**31 - 1),
       lam=st.floats(min_value=0.5, max_value=14.0, **finite))
@settings(max_examples=20, deadline=None)
def test_no_loss_with_infinite_queue(seed, lam):
    cfg = SimConfig(arrival_rate_mpps=lam, service_rate_mpps=29.76,
                    queue_capacity=10**9, duration_us=60_000.0, seed=seed)
    r = simulate(cfg)
    assert r.dropped == 0


@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
@settings(max_examples=15, deadline=None)
def test_more_threads_never_lengthen_vacations_much(seed):
    """E[V] decreases (or stays ~flat) in M under identical settings."""
    means = []
    for m in (1, 3, 6):
        cfg = SimConfig(m=m, adaptive=False, v_target_us=30.0,
                        arrival_rate_mpps=5.0, service_rate_mpps=29.76,
                        sleep_model=PERFECT_SLEEP_MODEL,
                        duration_us=120_000.0, seed=seed)
        means.append(simulate(cfg).mean_vacation_us)
    assert means[2] <= means[0] * 1.25 + 1.0
