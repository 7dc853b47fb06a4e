"""The traffic generator: the same seed gives the same requests, another
seed the same sizes and gaps in another order with other ids."""

import numpy as np
import pytest

from gpu_bench_toy import CELLS

from gpu_bench.bench import spec
from gpu_bench.bench.traffic import Traffic, quantile_sizes

SEEDS = (7, 2**31 + 17, 2**40 + 3, -5)


def _requests(name, seed, seconds=51.0, n=64):
    cell = spec.resolve(name)
    t = Traffic(cell.mix, seed, cell.config["model"]["vocab_size"])
    if t.open_loop:
        return t.window(seconds)
    return [t.plan(k) for k in range(n)]


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_requests(name):
    a, b = _requests(name, SEEDS[1]), _requests(name, SEEDS[1])
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new and x.due_s == y.due_s


@pytest.mark.parametrize("name", CELLS)
def test_other_seed_same_work_other_order(name):
    runs = [_requests(name, s) for s in SEEDS]
    for size in (lambda r: len(r.prompt), lambda r: r.max_new):
        sets = [sorted(size(r) for r in rs) for rs in runs]
        assert all(s == sets[0] for s in sets)
    orders = {tuple(len(r.prompt) for r in rs) for rs in runs}
    assert len(orders) == len(SEEDS)
    assert not np.array_equal(runs[0][0].prompt[:8], runs[1][0].prompt[:8])
    vocab = spec.resolve(name).config["model"]["vocab_size"]
    for rs in runs:
        assert all(r.prompt.min() >= 1 and r.prompt.max() < vocab for r in rs)


@pytest.mark.parametrize("name", [c for c in CELLS if "rag" in c])
def test_open_loop_due_inside_the_window_at_the_rate(name):
    cell = spec.resolve(name)
    for seed in SEEDS:
        reqs = _requests(name, seed)
        due = [r.due_s for r in reqs]
        assert due == sorted(due) and 0 < due[0] and due[-1] < 51.0
        assert len(reqs) == int(cell.mix["arrivals"]["rate_per_s"] * 51.0)
        lo, hi = cell.mix["prompt_tokens"]["min"], cell.mix["prompt_tokens"]["max"]
        assert all(lo <= len(r.prompt) <= hi for r in reqs)


def test_backlog_blocks_hold_the_same_sizes():
    reqs = _requests("granite-3-8b.chat_batch", 99, n=96)
    blocks = [sorted(len(r.prompt) for r in reqs[i:i + 32]) for i in range(0, 96, 32)]
    assert blocks[0] == blocks[1] == blocks[2]


def test_quantile_sizes_log_uniform():
    s = quantile_sizes({"kind": "log_uniform", "min": 128, "max": 1024}, 4)
    assert list(s) == [int(round(128 * 8 ** ((i + 0.5) / 4))) for i in range(4)]
    assert list(quantile_sizes({"kind": "fixed", "value": 16}, 3)) == [16, 16, 16]


@pytest.mark.parametrize("name", CELLS)
def test_prompt_sizes_hold_every_planned_prompt(name):
    """Set-up warms the buckets of ``prompt_sizes``: every request the
    window can send is among them."""
    cell = spec.resolve(name)
    t = Traffic(cell.mix, SEEDS[0], cell.config["model"]["vocab_size"])
    sizes = t.prompt_sizes()
    for seconds in (51.0, 10.0, 3.3):
        reqs = t.window(seconds) if t.open_loop else [t.plan(k) for k in range(100)]
        assert {len(r.prompt) for r in reqs} <= sizes


def test_unknown_arrivals_are_refused():
    mix = dict(spec.resolve("granite-3-8b.rag_8k").mix, arrivals={"kind": "poisson",
                                                                   "rate_per_s": 1.0})
    with pytest.raises(ValueError, match="unknown arrivals"):
        Traffic(mix, 1, 100)
