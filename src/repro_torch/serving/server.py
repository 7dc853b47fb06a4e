"""Request ingress for the serving engine — the paper's architecture on
the serving path, expressed through the ``repro_torch.runtime`` API
(PyTorch port of ``repro.serving.server``).

One ``Server`` composes three pieces instead of hand-rolling a loop:

  - ``n_queues`` ``BoundedQueue``s as the request ingress (the "NIC Rx
    rings"), fronted by a ``Dispatcher`` with request affinity (equal
    affinity keys always land in the same queue, like an RSS flow hash);
  - any ``RetrievalPolicy`` deciding the retrieval cadence;
  - the generic threaded ``Runtime``, whose busy period drains ingress
    *and* keeps ``engine.pump()`` ticking until the engine goes idle —
    with an ``Assignment`` deciding which threads sweep which queues.

So the exact policy object you validated in the simulator serves real
requests unchanged:

    srv = Server(engine, MetronomePolicy(cfg), n_queues=4)
    srv.start(); srv.submit(req); ...; stats = srv.stop()

``ServerStats`` is the unified ``RunStats`` under its old name; the
reference's deprecated ``MetronomeServer`` / ``BusyPollServer`` aliases
are not part of the port.  Stats
mirror the paper's evaluation: CPU fraction (awake-time), busy tries,
retrieval latency (enqueue -> retrieval), time-to-first-token, and a
``per_queue`` breakdown when ingress is sharded.
"""

from __future__ import annotations

import threading

import numpy as np

from repro_torch.core.hr_sleep import hr_sleep
from repro_torch.runtime.dispatch import FlowHashDispatch, RoundRobinDispatch
from repro_torch.runtime.queues import BoundedQueue
from repro_torch.runtime.runtime import Runtime
from repro_torch.runtime.stats import RunStats as ServerStats

from .engine import InferenceEngine, Request

__all__ = ["ServerStats", "Server"]


def _affinity_key(req):
    """Stable per-request routing key: a session/user/flow attribute when
    the request carries one, else its id (unique => effectively random
    placement, still stable for the request's lifetime)."""
    for attr in ("session_id", "session", "user", "flow", "id"):
        key = getattr(req, attr, None)
        if key is not None:
            return key
    return None


class Server:
    """Serving ingress: ``Runtime`` + policy + engine, one class for every
    retrieval strategy.  ``n_queues > 1`` shards ingress across queues
    with affinity dispatch; ``assignment`` picks the thread↔queue
    strategy (shared / dedicated / stealing)."""

    def __init__(self, engine: InferenceEngine, policy, *,
                 queue_capacity: int = 1024, sleep_fn=hr_sleep,
                 n_queues: int = 1, dispatcher=None, assignment=None,
                 operating_table=None, app_load=None):
        """``app_load`` (any object with the ``AppLoad`` protocol of
        ``repro.runtime.apps``) co-runs a competing application on the
        serving host for the server's lifetime — the CPU-sharing
        deployment the paper argues sleep&wake retrieval enables; its
        progress lands in ``stats.app_ops`` / ``stats.app_cpu_ns``."""
        self.engine = engine
        self.policy = policy
        # calibrated operating table (repro_torch.runtime.calibrate): accept a
        # ready table or a path to one saved by build_operating_table,
        # and install it as the policy controller's feed-forward term so
        # the server starts at pre-validated operating points
        if isinstance(operating_table, (str, bytes)) or hasattr(
                operating_table, "__fspath__"):
            from repro_torch.runtime.calibrate import OperatingTable
            operating_table = OperatingTable.load(operating_table)
        self.operating_table = operating_table
        if operating_table is not None:
            ctl = getattr(policy, "controller", None)
            if ctl is None:
                raise ValueError(
                    f"policy {getattr(policy, 'name', policy)!r} has no "
                    "controller to install the operating table into")
            ctl.feedforward = operating_table
            ctl.__post_init__()        # re-derive T_S/T_L from the table
        self.queues = [BoundedQueue(queue_capacity)
                       for _ in range(max(n_queues, 1))]
        self.queue = self.queues[0]        # single-queue back-compat alias
        self.dispatcher = dispatcher or (
            FlowHashDispatch() if len(self.queues) > 1 else RoundRobinDispatch())
        self.dispatcher.reset(len(self.queues), np.random.default_rng(0))
        self._seq = 0
        self._submit_lock = threading.Lock()
        # With one queue the engine was implicitly serialized by the queue
        # lock (only its holder ingested/pumped).  Sharded ingress has
        # several lock holders at once, so the engine gets its own lock:
        # ingest blocks (it is short), pump try-locks — if a peer is
        # already pumping, this poller reports no progress and re-sleeps.
        self._engine_lock = threading.Lock()
        self._runtime = Runtime(
            self.queues,
            process=self._ingest,
            policy=policy,
            sleep_fn=sleep_fn,
            # sample every retrieval: request rates are orders of magnitude
            # below packet rates, so the reservoir absorbs the cost
            latency_sample_every=1,
            idle_work=self._pump,
            assignment=assignment,
            app_load=app_load,
        )
        self.app_load = app_load

    def _ingest(self, reqs: list) -> None:
        with self._engine_lock:
            self.engine.submit(reqs)

    def _pump(self) -> bool:
        if not self._engine_lock.acquire(blocking=False):
            return False
        try:
            return self.engine.pump()
        finally:
            self._engine_lock.release()

    # -- producer side ---------------------------------------------------------
    def submit(self, req: Request) -> bool:
        with self._submit_lock:
            seq = self._seq
            self._seq += 1
        backlogs = [len(q) for q in self.queues]
        i = self.dispatcher.pick(seq, backlogs, key=_affinity_key(req))
        return self.queues[i].push(req)

    # -- lifecycle --------------------------------------------------------------
    def start(self) -> None:
        self._runtime.start()
        self.stats.backend = "server"

    def stop(self, timeout: float = 10.0) -> ServerStats:
        return self._runtime.stop(timeout)

    @property
    def stats(self) -> ServerStats:
        return self._runtime.stats

    # -- scheduled replay -------------------------------------------------------
    def replay(self, workload, *, duration_us: float, schedule=None,
               make_request=None, seed: int = 0,
               drain_timeout_s: float = 10.0) -> ServerStats:
        """Drive the server with a (possibly nonstationary) workload:
        start, submit one request per ``workload`` arrival at its
        scheduled wall-clock offset — ``schedule`` (a
        ``LoadSchedule``, as in ``repro.runtime.schedule``) modulating the rate
        exactly as ``SimRunConfig.schedule`` does in simulation — then
        drain and stop.  ``make_request(i)`` builds the i-th request
        (default: a tiny 4-token prompt).  The returned stats carry the
        schedule descriptor, so live serving runs line up with
        simulated adaptation studies.
        """
        import time as _time

        # label with the BASE workload (the simulate_run / Runtime.run
        # convention): the schedule lands in stats.schedule, so rows
        # from every backend group by the same workload name
        base_wl = getattr(workload, "base", workload)
        workload_label = getattr(base_wl, "name", type(base_wl).__name__)
        if schedule is not None:
            from repro_torch.runtime.workload import ScheduledWorkload
            workload = ScheduledWorkload(workload, schedule)
        if make_request is None:
            def make_request(i):
                return Request(prompt=[1, 2, 3, 4], max_new_tokens=4)
        rng = np.random.default_rng(seed)
        self.start()
        t0 = _time.monotonic_ns()
        n = 0
        max_lag_ns = 0
        for t_us in workload.iter_arrivals(duration_us, rng):
            gap_ns = t0 + int(t_us * 1e3) - _time.monotonic_ns()
            if gap_ns > 0:
                _time.sleep(gap_ns / 1e9)
            else:
                max_lag_ns = max(max_lag_ns, -gap_ns)
            self.submit(make_request(n))
            n += 1
        deadline = _time.monotonic() + drain_timeout_s
        while (any(len(q) for q in self.queues)
               and _time.monotonic() < deadline):
            _time.sleep(0.005)
        st = self.stop()
        st.workload = workload_label
        sched = schedule or getattr(workload, "schedule", None)
        st.schedule = sched.descriptor() if sched is not None else ""
        st.feeder_lag_us = max_lag_ns / 1e3
        return st

