"""Bounded ingress queue shared by the real-thread backends."""

from __future__ import annotations

import collections
import time
from typing import Any

from repro_torch.core.trylock import TryLock

__all__ = ["BoundedQueue"]


class BoundedQueue:
    """Bounded MPSC-ish queue standing in for the NIC Rx descriptor ring.

    ``push`` drops (and counts) on overflow — Rx-ring semantics, paper
    Table 2/3 loss accounting.  ``poll`` is only called under the queue's
    TryLock, so a plain deque suffices (append is GIL-atomic for pushers).
    """

    __slots__ = ("_q", "capacity", "dropped", "offered", "serviced", "lock",
                 "last_busy_end_ns")

    def __init__(self, capacity: int = 1024):
        self._q: collections.deque = collections.deque()
        self.capacity = capacity
        self.dropped = 0
        self.offered = 0
        self.serviced = 0
        self.lock = TryLock()
        self.last_busy_end_ns = time.monotonic_ns()

    def push(self, item: Any) -> bool:
        self.offered += 1
        if len(self._q) >= self.capacity:
            self.dropped += 1
            return False
        self._q.append((time.monotonic_ns(), item))
        return True

    def poll(self, max_items: int) -> list[tuple[int, Any]]:
        out = []
        q = self._q
        for _ in range(min(max_items, len(q))):
            try:
                out.append(q.popleft())
            except IndexError:  # racing pushers can't cause this; be safe
                break
        self.serviced += len(out)
        return out

    def __len__(self) -> int:
        return len(self._q)
