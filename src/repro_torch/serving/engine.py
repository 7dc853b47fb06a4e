"""Continuous-batching inference engine (slot-based KV cache), PyTorch
port of ``repro.serving.engine``.

The device side of the serving stack: a fixed pool of B cache slots; new
requests are prefilled (bucketed lengths), their KV copied into a free
slot, and one decode step advances every active slot per tick.  Host-side
retrieval cadence — *when* ``pump()`` gets called — is the paper's
contribution and lives in server.py; the engine itself is
scheduler-agnostic.

Where the reference donates the cache to a jitted update, the port writes
into the slot's row of its cache in place, and decode writes each new
token's KV in place.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models import Model

__all__ = ["Request", "EngineConfig", "InferenceEngine"]


@dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    id: int = field(default_factory=itertools.count().__next__)
    arrival_ns: int = field(default_factory=time.monotonic_ns)
    tokens: list[int] = field(default_factory=list)
    first_token_ns: int = 0
    done_ns: int = 0
    _done: threading.Event = field(default_factory=threading.Event)

    def wait(self, timeout=None) -> bool:
        return self._done.wait(timeout)


@dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 4
    max_len: int = 128
    prefill_buckets: tuple = (16, 32, 64)
    eos_id: int = -1              # -1: run to max_new_tokens


def _insert(cache: dict, pre: dict, slot: int) -> None:
    """Copy a B=1 prefill cache into row ``slot`` of the batch cache, in
    place.  KV leaves (G, 1, S_pre, ...) land in positions [0, S_pre) of
    the row and the rest of the row is zeroed; a leaf of the row's own
    shape is copied whole; anything else leaves the row as it was (the
    reference's rule)."""
    for name, leaves in pre.items():
        for leaf, p in leaves.items():
            c = cache[name][leaf]
            if p.shape[1] != 1:
                continue
            row, src = c[:, slot], p[:, 0]
            if row.dim() >= 3 and src.dim() == row.dim() and \
                    row.shape[0] == src.shape[0] and src.shape[1] <= row.shape[1]:
                row.zero_()
                row[:, :src.shape[1]] = src.to(row.dtype)
            elif src.shape == row.shape:
                row.copy_(src)


class InferenceEngine:
    """Single-threaded engine: callers serialize via the server's trylock
    (paper Sec 3.2) — exactly one thread pumps at a time."""

    def __init__(self, model: Model, params, cfg: EngineConfig):
        self.model = model
        self.params = params
        self.cfg = cfg
        b, s = cfg.max_slots, cfg.max_len
        self.device = model.device
        self.cache = model.init_cache(b, s)
        self.pos = np.zeros(b, np.int64)
        self.active: list[Request | None] = [None] * b
        self.pending: list[Request] = []
        self.steps = 0
        self.prefill_tokens = 0
        self.decoded_tokens = 0
        self._last_tok = np.zeros(b, np.int64)

    # -- queue side -----------------------------------------------------------
    def submit(self, reqs: list[Request]) -> None:
        self.pending.extend(reqs)

    @property
    def has_work(self) -> bool:
        return bool(self.pending) or any(r is not None for r in self.active)

    # -- engine tick ------------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.cfg.prefill_buckets:
            if n <= b:
                return b
        return self.cfg.prefill_buckets[-1]

    def _admit(self) -> bool:
        if not self.pending:
            return False
        try:
            slot = self.active.index(None)
        except ValueError:
            return False
        req = self.pending.pop(0)
        prompt = req.prompt[-self.cfg.prefill_buckets[-1]:]
        bucket = self._bucket(len(prompt))
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :len(prompt)] = prompt
        with torch.no_grad():
            logits, pre_cache = self.model.prefill(
                self.params, {"tokens": torch.from_numpy(toks).to(self.device)})
            _insert(self.cache, pre_cache, slot)
            next_tok = int(torch.argmax(logits[0, len(prompt) - 1]))
        req.tokens.append(next_tok)
        req.first_token_ns = time.monotonic_ns()
        self.prefill_tokens += len(prompt)
        self.pos[slot] = len(prompt)
        self.active[slot] = req
        self._last_tok[slot] = next_tok
        return True

    def _decode_tick(self) -> bool:
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return False
        with torch.no_grad():
            toks = torch.from_numpy(self._last_tok).to(self.device)
            pos = torch.from_numpy(self.pos).to(self.device)
            logits, self.cache = self.model.decode_step(self.params, toks, self.cache, pos)
            next_toks = torch.argmax(logits, dim=-1).cpu().numpy()
        self.steps += 1
        for i in live:
            req = self.active[i]
            tok = int(next_toks[i])
            req.tokens.append(tok)
            self.decoded_tokens += 1
            self.pos[i] += 1
            self._last_tok[i] = tok
            if (len(req.tokens) >= req.max_new_tokens
                    or tok == self.cfg.eos_id
                    or self.pos[i] >= self.cfg.max_len - 1):
                req.done_ns = time.monotonic_ns()
                req._done.set()
                self.active[i] = None
        return True

    def pump(self) -> int:
        """Drain everything currently runnable (one busy period).
        Returns the number of engine ticks executed."""
        ticks = 0
        while True:
            admitted = self._admit()
            decoded = self._decode_tick()
            if not admitted and not decoded:
                return ticks
            ticks += 1
