"""The one traffic generator: a mix file's parameters and a seed in,
requests out.

Sizes are stratified: every block of ``block`` consecutive requests holds
the same set of prompt and output lengths (the distribution's quantiles at
the block's midpoints), and the seed only orders them inside the block and
draws the token ids.  An open loop's gaps are likewise stratified: each
block's gaps are the exponential distribution's quantiles, ordered by the
seed.  So every seed offers the same work and the same arrivals in another
order, and runs of different seeds differ by the order and the ids alone.
The arrivals are not a Poisson process: each block of requests spans the
same time, which caps a burst at a block's.

Mix keys read here (a mix file may hold more, for its driver):

  arrivals       {"kind": "stratified_poisson", "rate_per_s": r} — an open
                 loop, ``floor(r * seconds)`` requests due at the offsets
                 above; or {"kind": "backlog", "depth": d} — an offline
                 batch: ``d`` queued before the window, one more for each
                 completion
  prompt_tokens  {"kind": "log_uniform", "min": a, "max": b} or
                 {"kind": "fixed", "value": n}
  output_tokens  the same two kinds
  block          requests a stratified block, for the sizes and an open
                 loop's gaps alike
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = ["Plan", "rng_for", "quantile_sizes", "Traffic"]


@dataclass(frozen=True)
class Plan:
    """One request as the generator made it: token ids (none is 0), the
    output tokens it asks for, and when it is due (seconds after the
    window opens; None for a backlog request)."""

    prompt: np.ndarray
    max_new: int
    due_s: float | None


def rng_for(seed: int, *keys: int) -> np.random.Generator:
    """A generator for ``seed`` and ``keys``: any whole seed, however large
    or negative, maps to its own stream."""
    return np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), *keys]))


def quantile_sizes(dist: dict, n: int) -> np.ndarray:
    """``n`` sizes at the midpoints of the distribution's n quantiles."""
    if dist["kind"] == "fixed":
        return np.full(n, int(dist["value"]), np.int64)
    if dist["kind"] != "log_uniform":
        raise ValueError(f"unknown size distribution {dist['kind']!r}")
    lo, hi = math.log(dist["min"]), math.log(dist["max"])
    u = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(lo + u * (hi - lo))).astype(np.int64)


class Traffic:
    """The requests of one mix under one seed.  ``plan(k)`` is the k-th
    request; ``window(seconds)`` the open loop's requests due in a window."""

    _STREAM_SIZES, _STREAM_IDS, _STREAM_GAPS = 1, 2, 3
    KINDS = ("stratified_poisson", "backlog")

    def __init__(self, mix: dict, seed: int, vocab_size: int):
        self.mix, self.seed, self.vocab = mix, int(seed), int(vocab_size)
        self.arrivals = mix["arrivals"]
        if self.arrivals["kind"] not in self.KINDS:
            raise ValueError(f"unknown arrivals {self.arrivals['kind']!r}; known: {self.KINDS}")
        self.block = int(mix["block"])
        self._blocks: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}

    @property
    def open_loop(self) -> bool:
        return self.arrivals["kind"] == "stratified_poisson"

    def count(self, seconds: float) -> int:
        """Requests an open loop makes due in a window of ``seconds``."""
        return int(math.floor(self.arrivals["rate_per_s"] * seconds))

    def _block(self, b: int, size: int) -> tuple[np.ndarray, np.ndarray]:
        if (b, size) not in self._blocks:
            rng = rng_for(self.seed, self._STREAM_SIZES, b)
            prompts = rng.permutation(quantile_sizes(self.mix["prompt_tokens"], size))
            outputs = rng.permutation(quantile_sizes(self.mix["output_tokens"], size))
            self._blocks[b, size] = (prompts, outputs)
        return self._blocks[b, size]

    def prompt_sizes(self) -> set[int]:
        """Every prompt length a request can have: the quantiles of a
        block, or of a last block cut short to any length."""
        return {int(n) for m in range(1, self.block + 1)
                for n in quantile_sizes(self.mix["prompt_tokens"], m)}

    def plan(self, k: int, *, total: int | None = None, due_s: float | None = None) -> Plan:
        """The k-th request; of ``total`` in all, where a last block that
        is cut short holds its own length's quantiles."""
        size = self.block
        b = k // size
        if total is not None:
            size = min(size, total - b * size)
        prompts, outputs = self._block(b, size)
        n = int(prompts[k % size])
        ids = rng_for(self.seed, self._STREAM_IDS, k).integers(1, self.vocab, n, dtype=np.int64)
        return Plan(prompt=ids, max_new=int(outputs[k % size]), due_s=due_s)

    def window(self, seconds: float) -> list[Plan]:
        """The open loop's requests: each block's gaps the exponential
        distribution's quantiles, in the seed's order, those due before
        ``seconds``."""
        n = self.count(seconds)
        if n == 0:
            return []
        rate = self.arrivals["rate_per_s"]
        size = self.block
        rng = rng_for(self.seed, self._STREAM_GAPS)
        gaps = np.concatenate([rng.permutation(-np.log1p(-(np.arange(m) + 0.5) / m) / rate)
                               for m in (min(size, n - b0) for b0 in range(0, n, size))])
        due = np.cumsum(gaps)
        return [self.plan(k, total=n, due_s=float(t))
                for k, t in enumerate(due) if t < seconds]
