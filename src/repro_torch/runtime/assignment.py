"""Thread↔queue assignment — *who* polls *which* Rx queue.

With N queues the paper's M sleep&wake threads can be organized three
ways, each a real deployment shape:

  - ``SharedAssignment``    every thread sweeps every queue in order —
    the paper's M threads generalized to N rings (and exactly what the
    threaded ``Runtime`` always did);
  - ``DedicatedAssignment`` one poller set *and one controller* per
    queue: each ring gets its own policy clone with its own M threads,
    the software analogue of per-ring interrupts (no cross-queue help,
    but per-queue timeouts adapt to per-queue load);
  - ``StealingAssignment``  threads are partitioned across home queues,
    drain their own ring first, then steal from the longest remaining
    backlog — dedicated's cache affinity with shared's tail behavior.

An assignment compiles ``(policy, n_queues)`` into ``ThreadSlot``s; both
execution backends (``repro.runtime.sim`` and ``repro.runtime.runtime``)
consume the same slots, so a strategy validated in simulation maps to OS
threads unchanged.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

__all__ = [
    "ThreadSlot",
    "Assignment",
    "SharedAssignment",
    "DedicatedAssignment",
    "StealingAssignment",
    "clone_policy",
]


def clone_policy(policy):
    """Independent copy of a policy with freshly-armed internal state
    (``DedicatedAssignment`` needs one controller per queue)."""
    p = copy.deepcopy(policy)
    p.reset()
    return p


@dataclass(frozen=True)
class ThreadSlot:
    """One poller thread's compiled assignment: the policy object it
    consults (possibly shared with other slots) and the queue indices it
    sweeps, in order.  ``steal=True`` lets it visit the longest unvisited
    backlog after its own queues run dry.  ``demote_on_miss=False`` keeps
    the primary cadence even when every lock was contended — right when
    the thread is its queue's *only* home poller (stealing), where a
    missed trylock means transient help, not a standing primary, and the
    paper's long backup timeout would abandon the ring."""

    policy: object
    queues: tuple[int, ...]
    steal: bool = False
    demote_on_miss: bool = True


@runtime_checkable
class Assignment(Protocol):
    name: str

    def slots(self, policy, n_queues: int) -> list[ThreadSlot]: ...


class SharedAssignment:
    """All ``policy.threads`` threads sweep all queues (one shared
    controller): today's ``Runtime._run`` behavior made explicit."""

    name = "shared"

    def slots(self, policy, n_queues: int) -> list[ThreadSlot]:
        order = tuple(range(n_queues))
        return [ThreadSlot(policy, order) for _ in range(policy.threads)]


class DedicatedAssignment:
    """One policy clone + one poller set per queue — per-ring interrupt
    semantics.  Total threads = ``policy.threads * n_queues``; each
    queue's controller adapts to that queue's load alone."""

    name = "dedicated"

    def slots(self, policy, n_queues: int) -> list[ThreadSlot]:
        out = []
        for q in range(n_queues):
            p = clone_policy(policy) if n_queues > 1 else policy
            out.extend(ThreadSlot(p, (q,)) for _ in range(p.threads))
        return out


class StealingAssignment:
    """``policy.threads`` threads with home queues ``i % n_queues``; a
    thread drains its home ring first, then steals from the longest
    backlog among rings it has not visited this wake."""

    name = "stealing"

    def slots(self, policy, n_queues: int) -> list[ThreadSlot]:
        homes = [i % n_queues for i in range(policy.threads)]
        # only demote threads whose home ring has redundant pollers; a
        # ring's sole home poller must keep its cadence (see ThreadSlot)
        return [ThreadSlot(policy, (h,), steal=True,
                           demote_on_miss=homes.count(h) > 1)
                for h in homes]
