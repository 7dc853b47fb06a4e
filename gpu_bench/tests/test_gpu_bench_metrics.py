"""The end-to-end metrics as defined: TTFT's tail over every request due,
failures above all; tokens per second over the whole window."""

import math
from types import SimpleNamespace

import pytest

import gpu_bench_toy  # noqa: F401

from gpu_bench.bench import spec
from gpu_bench.bench.stats import MISSING, nearest_rank


def _due(waits_ms, failed=()):
    recs = []
    for i, w in enumerate(waits_ms):
        due = 1_000_000_000 + i * 10_000_000
        first = 0 if i in failed else due + int(w * 1e6)
        recs.append(SimpleNamespace(due_ns=due, first_token_ns=first))
    return SimpleNamespace(window=SimpleNamespace(due=recs, gave_up_ns=10_000_000_000))


def test_nearest_rank():
    assert nearest_rank(range(1, 101), 0.9) == 90
    assert nearest_rank([5], 0.9) == 5
    assert nearest_rank([1, 2, MISSING], 0.9) == MISSING


def test_ttft_p90_over_all_requests_and_a_stall_moves_it():
    read = spec.metric_reader("ttft_p90_ms")
    base = [100.0] * 100
    assert read(_due(base)) == pytest.approx(100.0, abs=1e-3)
    # a stall of 2 s that delays the 15 requests after it
    stalled = base[:50] + [100.0 + 2000.0 - 20 * k for k in range(15)] + base[65:]
    assert read(_due(stalled)) > 1500.0


def test_a_failed_request_ranks_above_all():
    read = spec.metric_reader("ttft_p90_ms")
    waits = [float(i) for i in range(1, 101)]
    assert read(_due(waits)) == pytest.approx(90.0, abs=1e-3)
    failed = read(_due(waits, failed=range(90, 100)))
    assert failed == pytest.approx(90.0, abs=1e-3)
    with_eleven = read(_due(waits, failed=range(89, 100)))
    assert with_eleven > 1000.0 and math.isfinite(with_eleven)


def test_output_tokens_per_s_over_the_whole_window():
    read = spec.metric_reader("output_tokens_per_s")
    run = SimpleNamespace(window=SimpleNamespace(tokens=1234, seconds=51.0))
    assert read(run) == pytest.approx(1234 / 51.0)


def test_setup_and_poller_readers():
    assert spec.metric_reader("setup_s")(SimpleNamespace(setup_s=12.5)) == 12.5
    stats = SimpleNamespace(cpu_fraction=0.7, latency_us=[float(i) for i in range(1, 1001)])
    run = SimpleNamespace(window=SimpleNamespace(stats=stats))
    assert spec.metric_reader("poller_cores.prompt")(run) == 0.7
    assert spec.metric_reader("retrieval_p90_ms.prompt")(run) == 0.9
