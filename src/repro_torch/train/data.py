"""Deterministic, seekable synthetic data pipeline.

Every batch is a pure function of (seed, step) — counter-based Philox
bits, no stored iterator state — so checkpoint resume and elastic
restarts reproduce the exact token stream by construction (the resume
test asserts bit-equality).  A host prefetcher overlaps batch synthesis
with device compute; its idle behaviour is Metronome-style sleep&wake
rather than a spin loop (the paper's technique applied to the training
input path — DESIGN.md §2).
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass

import numpy as np

from repro_torch.core import MetronomeConfig, MetronomeController, hr_sleep

__all__ = ["TokenDataset", "HostPrefetcher"]


@dataclass(frozen=True)
class TokenDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> dict:
        """Batch for `step` — stateless, O(1) seek."""
        rng = np.random.Generator(np.random.Philox(key=self.seed, counter=step))
        tokens = rng.integers(0, self.vocab_size,
                              (self.global_batch, self.seq_len + 1),
                              dtype=np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


class HostPrefetcher:
    """Depth-k batch prefetcher with Metronome sleep&wake idle behaviour."""

    def __init__(self, ds: TokenDataset, start_step: int, *, depth: int = 2,
                 v_target_us: float = 500.0):
        self.ds = ds
        self.depth = depth
        self._buf: collections.deque = collections.deque()
        self._next = start_step
        self._take = start_step
        self._lock = threading.Lock()
        self._running = threading.Event()
        self._running.set()
        self._ctrl = MetronomeController(
            MetronomeConfig(m=1, v_target_us=v_target_us,
                            t_long_us=v_target_us * 20))
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        import time
        while self._running.is_set():
            t0 = time.monotonic_ns()
            did = False
            with self._lock:
                room = self.depth - len(self._buf)
                nxt = self._next
            for _ in range(max(room, 0)):
                b = self.ds.batch(nxt)
                with self._lock:
                    self._buf.append((nxt, b))
                    self._next = nxt = nxt + 1
                did = True
            busy_us = (time.monotonic_ns() - t0) / 1e3
            self._ctrl.on_cycle_end(busy_us if did else 0.0,
                                    max(self._ctrl.timeout_us(primary=True), 1.0))
            hr_sleep(self._ctrl.timeout_ns(primary=did))

    def get(self, step: int) -> dict:
        """Batch for `step`; blocks briefly if the producer is behind."""
        while True:
            with self._lock:
                while self._buf and self._buf[0][0] < step:
                    self._buf.popleft()
                if self._buf and self._buf[0][0] == step:
                    return self._buf.popleft()[1]
                # seek (elastic restart onto a different step)
                if not self._buf and self._next != step:
                    self._next = step
            hr_sleep(100_000)

    def stop(self) -> None:
        self._running.clear()
        self._thread.join(1.0)
