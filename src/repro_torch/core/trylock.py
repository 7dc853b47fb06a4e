"""Non-blocking queue-ownership lock — the paper's userspace ``trylock()``.

The paper builds trylock from the x86 CMPXCHG read-modify-write.  CPython's
``threading.Lock.acquire(blocking=False)`` bottoms out in a futex fast path
using the same compare-and-exchange hardware primitive, so the semantics
(single winner, losers return immediately, no syscall on the fast path) are
preserved.

The lock also keeps the two counters the paper's evaluation relies on:
``busy_tries`` (failed acquisitions — paper Fig 7/8) and ``acquisitions``.
Counters are approximate under contention by design (they are telemetry,
not synchronization).
"""

from __future__ import annotations

import threading

__all__ = ["TryLock"]


class TryLock:
    __slots__ = ("_lock", "busy_tries", "acquisitions")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.busy_tries = 0
        self.acquisitions = 0

    def try_acquire(self) -> bool:
        """Single atomic attempt; never blocks (paper Listing 2, line 4)."""
        ok = self._lock.acquire(blocking=False)
        if ok:
            self.acquisitions += 1
        else:
            self.busy_tries += 1
        return ok

    def release(self) -> None:
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def reset_stats(self) -> None:
        self.busy_tries = 0
        self.acquisitions = 0
