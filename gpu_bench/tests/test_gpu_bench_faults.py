"""A run with the timed path broken underneath comes out not correct: the
whole run past the look for a card (the driver, the window, the check) at
a test's size, once for each fault a served cell can have.  The exchange
between cards is not among them: every cell runs on one."""

import pytest
import torch

from gpu_bench_toy import CELLS, toy_cell

from gpu_bench.drivers import serve


class _Broken:
    """``engine.model`` with ``decode_step`` replaced."""

    def __init__(self, model, step):
        self._model, self._step = model, step

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, params, tokens, cache, pos):
        return self._step(self._model, params, tokens, cache, pos)


def _stale_state(model, params, tokens, cache, pos):
    """The step returns its state (the KV cache) unchanged."""
    scratch = {k: {leaf: v.clone() for leaf, v in d.items()} for k, d in cache.items()}
    return model.decode_step(params, tokens, scratch, pos)[0], cache


def _half_batch(model, params, tokens, cache, pos):
    """Half of the batch left out: its slots (the first, which the engine
    fills first) get the other half's rows."""
    logits, cache = model.decode_step(params, tokens, cache, pos)
    half = logits.shape[0] // 2
    return torch.cat([logits[half:2 * half], logits[half:]]), cache


def _altered_token(model, params, tokens, cache, pos):
    """Each decoded token altered where it is produced (the next id)."""
    logits, cache = model.decode_step(params, tokens, cache, pos)
    return logits.roll(1, dims=-1), cache


FAULTS = {"stale_state": _stale_state, "half_batch": _half_batch, "altered_token": _altered_token}


def _run(name, plant=None, seed=3):
    # in float32, so that a sound run's gaps are rounding alone and only a fault moves them
    return serve.run(toy_cell(name, dtype="float32"), seed, 1.0, False, device="cpu",
                     t_start=0.0, plant=plant)


@pytest.mark.parametrize("name", CELLS)
def test_unbroken_run_is_correct(name):
    run = _run(name)
    assert run.correct, [(c.name, c.value, c.limit) for c in run.checks]
    assert run.window.attempted > 0 and run.window.failed == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_run_is_not_correct(name, fault):
    def plant(engine):
        engine.model = _Broken(engine.model, FAULTS[fault])
    run = _run(name, plant)
    assert not run.correct, [(c.name, c.value, c.limit) for c in run.checks]
