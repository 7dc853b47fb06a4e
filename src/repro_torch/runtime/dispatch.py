"""Ingress dispatchers — *which queue* an arrival lands in.

A multi-queue NIC spreads flows across N Rx rings with an RSS hash; the
spread is rarely uniform (a handful of elephant flows pin whole rings).
A ``Dispatcher`` models that placement step for every backend:

  - the discrete-event simulator calls ``split(n, backlogs)`` to divide
    an aggregate arrival count across queues (aggregate-exact, like the
    workload itself);
  - the threaded ``Runtime`` / serving ``Server`` call
    ``pick(seq, backlogs, key=...)`` per arrival.

``reset(n_queues, rng)`` re-arms internal state before each run; the
``rng`` is the run's generator, so a dispatch pattern is reproducible
per seed.

Implementations:
  - ``RoundRobinDispatch``  uniform spread; with one queue it degenerates
    to "everything in the queue" and consumes no randomness, so single-
    queue runs reproduce the pre-multi-queue event sequence exactly;
  - ``FlowHashDispatch``    RSS emulation: flows with Zipf popularity are
    hashed to queues, so per-queue load inherits the skew of wherever
    the elephant flows land (``key=`` gives stable request affinity);
  - ``LeastLoadedDispatch`` idealized load balancer: arrivals water-fill
    the shortest backlogs (the upper bound NIC hashing can't reach);
  - ``WeightedDispatch``    weighted round-robin: fixed per-queue traffic
    shares (a fleet balancer splitting across heterogeneous replicas);
  - ``StaleLeastLoadedDispatch``  least-loaded against a backlog snapshot
    that refreshes only every ``refresh_every`` decisions — the finite-
    polling-rate balancer whose stale signal herds arrivals onto a
    replica that *was* idle (the regime the fleet tier studies).
"""

from __future__ import annotations

import zlib
from typing import Protocol, runtime_checkable

import numpy as np

__all__ = [
    "Dispatcher",
    "RoundRobinDispatch",
    "FlowHashDispatch",
    "LeastLoadedDispatch",
    "WeightedDispatch",
    "StaleLeastLoadedDispatch",
]


@runtime_checkable
class Dispatcher(Protocol):
    name: str

    def reset(self, n_queues: int, rng: np.random.Generator) -> None: ...

    def split(self, n: int, backlogs: np.ndarray) -> np.ndarray: ...

    def pick(self, seq: int, backlogs, key=None) -> int: ...


def _stable_hash(key) -> int:
    """Process-independent hash (``hash(str)`` is salted per process)."""
    return zlib.crc32(repr(key).encode())


class RoundRobinDispatch:
    """Uniform spread: arrival ``seq`` goes to queue ``seq % N``; aggregate
    counts are divided as evenly as possible with a rotating remainder
    cursor so no queue is systematically favored."""

    name = "round-robin"

    def __init__(self):
        self._n = 1
        self._cursor = 0

    def reset(self, n_queues: int, rng: np.random.Generator) -> None:
        self._n = int(n_queues)
        self._cursor = 0

    def split(self, n: int, backlogs: np.ndarray) -> np.ndarray:
        out = np.full(self._n, n // self._n, dtype=np.int64)
        extra = n % self._n
        if extra:
            idx = (self._cursor + np.arange(extra)) % self._n
            out[idx] += 1
            self._cursor = (self._cursor + extra) % self._n
        return out

    def pick(self, seq: int, backlogs, key=None) -> int:
        return seq % self._n


class FlowHashDispatch:
    """RSS emulation: ``n_flows`` flows with Zipf(``zipf_s``) popularity,
    each flow hashed to one queue at ``reset`` time.  Per-queue load is
    the sum of its flows' popularity — skewed exactly the way a real RSS
    indirection table is when elephant flows land together.

    ``pick(..., key=k)`` maps ``k`` through the same flow table, so equal
    keys always reach the same queue (request/flow affinity); without a
    key a flow is drawn from the popularity distribution.
    """

    name = "flow-hash"

    def __init__(self, n_flows: int = 256, zipf_s: float = 1.2):
        if n_flows < 1:
            raise ValueError("n_flows must be >= 1")
        if zipf_s <= 0:
            raise ValueError("zipf_s must be > 0")
        self.n_flows = int(n_flows)
        self.zipf_s = float(zipf_s)
        self._n = 1
        self._flow_queue = np.zeros(self.n_flows, dtype=np.int64)
        self._flow_probs = np.full(self.n_flows, 1.0 / self.n_flows)
        self._queue_weights = np.ones(1)
        self._cum_probs = np.cumsum(self._flow_probs)
        self._rng: np.random.Generator | None = None

    @property
    def queue_weights(self) -> np.ndarray:
        """Fraction of offered load each queue receives (diagnostics)."""
        return self._queue_weights.copy()

    def reset(self, n_queues: int, rng: np.random.Generator) -> None:
        self._n = int(n_queues)
        self._rng = rng
        w = 1.0 / np.arange(1, self.n_flows + 1, dtype=np.float64) ** self.zipf_s
        self._flow_probs = w / w.sum()
        self._cum_probs = np.cumsum(self._flow_probs)
        # random flow->queue placement: the skew comes from *where* the
        # heavy flows land, exactly like a hardware indirection table
        self._flow_queue = rng.integers(0, self._n, size=self.n_flows)
        self._queue_weights = np.bincount(
            self._flow_queue, weights=self._flow_probs, minlength=self._n)

    def split(self, n: int, backlogs: np.ndarray) -> np.ndarray:
        if n <= 0:
            return np.zeros(self._n, dtype=np.int64)
        return self._rng.multinomial(int(n), self._queue_weights)

    def pick(self, seq: int, backlogs, key=None) -> int:
        if key is not None:
            flow = _stable_hash(key) % self.n_flows
        else:
            flow = int(np.searchsorted(self._cum_probs, self._rng.random()))
            flow = min(flow, self.n_flows - 1)
        return int(self._flow_queue[flow])


class LeastLoadedDispatch:
    """Idealized balancer: each arrival joins the shortest backlog;
    aggregate counts water-fill queues toward a common level.  The
    upper bound on what queue-aware placement can achieve (real RSS
    cannot see backlogs)."""

    name = "least-loaded"

    def __init__(self):
        self._n = 1

    def reset(self, n_queues: int, rng: np.random.Generator) -> None:
        self._n = int(n_queues)

    def split(self, n: int, backlogs: np.ndarray) -> np.ndarray:
        if n <= 0:
            return np.zeros(self._n, dtype=np.int64)
        b = np.asarray(backlogs, dtype=np.float64)
        # water level L with sum(max(L - b, 0)) = n, found over sorted b
        s = np.sort(b)
        for k in range(1, self._n + 1):
            level = (n + s[:k].sum()) / k
            if k == self._n or level <= s[k]:
                break
        fill = np.maximum(level - b, 0.0)
        alloc = np.floor(fill).astype(np.int64)
        short = int(n - alloc.sum())
        if short > 0:
            # hand the integer remainder to the least-loaded-after-fill
            after = b + alloc
            idx = np.argsort(after, kind="stable")[:short]
            alloc[idx] += 1
        return alloc

    def pick(self, seq: int, backlogs, key=None) -> int:
        return int(np.argmin(np.asarray(backlogs)))


class WeightedDispatch:
    """Weighted round-robin: queue i receives a fixed ``weights[i]``
    share of arrivals.  Aggregate counts split by largest remainder
    (deterministic, so equal-seed runs reproduce); per-arrival picks
    walk the cumulative weights with a rotating fractional cursor, the
    classic smooth-WRR spread without bursts onto one queue."""

    name = "weighted"

    def __init__(self, weights):
        w = np.asarray(weights, dtype=np.float64)
        if w.size < 1 or np.min(w) <= 0:
            raise ValueError("weights must be positive and non-empty")
        self._weights = w / w.sum()
        self._cum = np.cumsum(self._weights)
        self._n = w.size
        self._frac = np.zeros(w.size)

    @property
    def queue_weights(self) -> np.ndarray:
        return self._weights.copy()

    def reset(self, n_queues: int, rng: np.random.Generator) -> None:
        if int(n_queues) != self._n:
            raise ValueError(
                f"WeightedDispatch built for {self._n} queues, "
                f"run has {n_queues}")
        self._frac = np.zeros(self._n)

    def split(self, n: int, backlogs: np.ndarray) -> np.ndarray:
        if n <= 0:
            return np.zeros(self._n, dtype=np.int64)
        # carry fractional credit across calls so small batches still
        # honor the shares in the long run
        ideal = n * self._weights + self._frac
        alloc = np.floor(ideal).astype(np.int64)
        short = int(n - alloc.sum())
        if short > 0:
            idx = np.argsort(-(ideal - alloc), kind="stable")[:short]
            alloc[idx] += 1
        self._frac = ideal - alloc
        return alloc

    def pick(self, seq: int, backlogs, key=None) -> int:
        # deterministic low-discrepancy walk over the cumulative shares
        u = ((seq + 0.5) * 0.6180339887498949) % 1.0
        return int(np.searchsorted(self._cum, u, side="right")
                   .clip(0, self._n - 1))


class StaleLeastLoadedDispatch:
    """Least-loaded routing on a *stale* backlog signal: the snapshot the
    decisions use refreshes only every ``refresh_every`` dispatch calls,
    modeling a balancer that polls replica queue depths at a finite
    rate.  ``refresh_every=1`` degenerates to ``LeastLoadedDispatch``
    exactly; large values reproduce the herd-to-the-idle-replica
    misbehavior of real stale-signal balancers."""

    name = "stale-least-loaded"

    def __init__(self, refresh_every: int = 64):
        if refresh_every < 1:
            raise ValueError("refresh_every must be >= 1")
        self.refresh_every = int(refresh_every)
        self._fresh = LeastLoadedDispatch()
        self._n = 1
        self._snapshot = np.zeros(1)
        self._calls = 0

    def reset(self, n_queues: int, rng: np.random.Generator) -> None:
        self._n = int(n_queues)
        self._fresh.reset(n_queues, rng)
        self._snapshot = np.zeros(self._n)
        self._calls = 0

    def _maybe_refresh(self, backlogs) -> None:
        if self._calls % self.refresh_every == 0:
            self._snapshot = np.asarray(backlogs, dtype=np.float64).copy()
        self._calls += 1

    def split(self, n: int, backlogs: np.ndarray) -> np.ndarray:
        self._maybe_refresh(backlogs)
        out = self._fresh.split(n, self._snapshot)
        # decisions feed back into the *snapshot* (the balancer knows
        # what it sent), just not into the true backlogs it cannot see
        self._snapshot = self._snapshot + out
        return out

    def pick(self, seq: int, backlogs, key=None) -> int:
        self._maybe_refresh(backlogs)
        q = int(np.argmin(self._snapshot))
        self._snapshot[q] += 1.0
        return q
