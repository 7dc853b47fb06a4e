"""Real-thread execution backend: any policy × any workload, OS threads.

One generic ``Runtime`` runs poller threads against one or more shared
bounded queues, executing the paper's Listing-2 loop shape:

    while running:
        lock_taken = False
        for q in my_queues:                  # from the Assignment
            if not trylock(q):   continue
            lock_taken = True
            while work:  process(...)                        # busy period
            policy.on_cycle_end(busy_us, vacation_us)
            unlock(q)
        sleep(policy.on_wake(ctx))          # 0 => spin (busy-poll policy)

Which queues a thread sweeps — and whether each queue gets its own
policy clone — is decided by an ``Assignment``
(``repro.runtime.assignment``): ``shared`` (default, all threads sweep
all queues), ``dedicated`` (one poller set + controller per queue), or
``stealing`` (home queue first, then the longest backlog).

What used to be three hand-rolled loops (``MetronomePollers``,
``BusyPollLoop``, the serving servers) is now this one loop with the
policy injected; ``repro.core.pollers`` and ``repro.serving.server``
keep their old names as thin shims over it.

CPU accounting uses per-thread CPU time (time.thread_time_ns around the
loop body) — the userspace analogue of the paper's getrusage()
methodology, immune to descheduling on shared hosts.  Spinning policies
are pinned at a full core in the report (their defining cost, and what
the paper charges DPDK).

``Runtime.run(workload, ...)`` additionally replays a ``Workload``
against the queues in real time from a feeder thread, returning the same
``RunStats`` the simulator produces — the sim/real parity surface.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Callable

import numpy as np

from repro_torch.core.hr_sleep import hr_sleep

from .assignment import SharedAssignment, ThreadSlot
from .dispatch import RoundRobinDispatch
from .policy import WakeContext
from .queues import BoundedQueue
from .simcore import DEFAULT_ENERGY_MODEL
from .stats import QueueStats, Reservoir, RunStats

__all__ = ["Runtime"]


class Runtime:
    def __init__(
        self,
        queues: list[BoundedQueue],
        process: Callable[[list], None],
        policy,
        *,
        burst_size: int = 32,
        sleep_fn: Callable[[int], None] = hr_sleep,
        latency_sample_every: int = 16,
        idle_work: Callable[[], bool] | None = None,
        latency_reservoir: int = 65_536,
        assignment=None,
        app_load=None,
        energy_model=DEFAULT_ENERGY_MODEL,
    ):
        """``process`` consumes a burst of retrieved items; ``idle_work``
        (optional) is polled during the busy period after each burst and
        returns whether it still made progress — the hook that lets a
        serving engine keep its decode loop inside the busy period.
        ``assignment`` maps threads to queues (default: every thread
        sweeps every queue, the paper's shared-queue shape).
        ``app_load`` (an ``repro.runtime.apps.AppLoad``) co-runs a
        competing application on the same host for the lifetime of the
        run — the paper's Sec 5.6 CPU-sharing scenario: its threads
        start and stop with the pollers, and the work it completed and
        CPU it burned land in ``RunStats.app_ops`` /
        ``RunStats.app_cpu_ns`` (the application-throughput side of the
        sharing trade-off).  ``energy_model`` (an
        ``repro.runtime.simcore.EnergyModel``) prices the run's counters
        into the model-based ``RunStats.energy_uj`` estimate at
        ``stop()`` — real threads have no wattmeter, so the same model
        the simulators account exactly is applied to the measured
        wake/awake/busy-try counters."""
        self.queues = queues
        self.process = process
        self.policy = policy
        self.assignment = assignment or SharedAssignment()
        self.burst_size = burst_size
        self.sleep_fn = sleep_fn
        self.energy_model = energy_model
        self.idle_work = idle_work
        self.app_load = app_load
        self._app_threads: list[threading.Thread] = []
        self.stats = RunStats(backend="threads",
                              policy=getattr(policy, "name", ""))
        self._lat_cap = latency_reservoir
        self._stats_lock = threading.Lock()
        self._running = threading.Event()
        self._threads: list[threading.Thread] = []
        self._cycles_q = [0] * len(queues)
        self._lat_every = max(latency_sample_every, 1)

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> None:
        self._slots = self.assignment.slots(self.policy, len(self.queues))
        # reset each distinct policy once (shared slots alias one object;
        # dedicated slots carry per-queue clones)
        seen: set[int] = set()
        for s in self._slots:
            if id(s.policy) not in seen:
                seen.add(id(s.policy))
                s.policy.reset()
        # queue/lock counters are cumulative; snapshot so a restarted
        # Runtime reports only this run's arrivals and busy tries
        self._base_counts = [(q.offered, q.dropped, q.lock.busy_tries,
                              q.serviced) for q in self.queues]
        self._cycles_q = [0] * len(self.queues)
        now = time.monotonic_ns()
        for q in self.queues:
            # re-arm the vacation clock: it is stamped at queue
            # construction, and a Runtime started later would otherwise
            # report a bogus multi-second first vacation to the policy
            q.last_busy_end_ns = now
        self.stats = RunStats(backend="threads",
                              policy=getattr(self.policy, "name", ""),
                              started_ns=now,
                              latency_us=Reservoir(self._lat_cap))
        self._running.set()
        self._threads = [
            threading.Thread(target=self._run, args=(slot,),
                             name=f"runtime-{i}", daemon=True)
            for i, slot in enumerate(self._slots)
        ]
        for t in self._threads:
            t.start()
        if self.app_load is not None:
            self.app_load.reset()
            self._app_threads = [
                threading.Thread(target=self._run_app,
                                 name=f"app-{i}", daemon=True)
                for i in range(self.app_load.threads)
            ]
            for t in self._app_threads:
                t.start()

    def stop(self, timeout: float = 5.0) -> RunStats:
        self._running.clear()
        for t in self._threads:
            t.join(timeout)
        for t in self._app_threads:
            t.join(timeout)
        self._app_threads = []
        st = self.stats
        st.stopped_ns = time.monotonic_ns()
        base = getattr(self, "_base_counts",
                       [(0, 0, 0, 0)] * len(self.queues))
        cycles_q = getattr(self, "_cycles_q", [0] * len(self.queues))
        st.per_queue = [
            QueueStats(queue=i,
                       offered=q.offered - b[0],
                       dropped=q.dropped - b[1],
                       busy_tries=q.lock.busy_tries - b[2],
                       serviced=q.serviced - b[3],
                       cycles=cycles_q[i])
            for i, (q, b) in enumerate(zip(self.queues, base, strict=True))
        ]
        st.offered = sum(pq.offered for pq in st.per_queue)
        st.dropped = sum(pq.dropped for pq in st.per_queue)
        st.busy_tries = sum(pq.busy_tries for pq in st.per_queue)
        if getattr(self.policy, "spin", False):
            # By construction a spinning policy never sleeps: charge one
            # full core per thread (the paper's DPDK baseline accounting).
            st.awake_ns = st.duration_ns * max(len(self._threads), 1)
        st.energy_uj = self._estimate_energy_uj(st)
        return st

    def _estimate_energy_uj(self, st: RunStats) -> float:
        """Model-based energy from the run's counters (no wattmeter on
        real threads): a spinning policy burns flat active power at the
        DVFS busy frequency on every thread; a sleeping policy pays
        active power over measured CPU time plus one C-state arm charge
        per wake — T_L-priced for the busy-try share of wakes (the lock
        was taken, the policy demoted), T_S-priced for the rest.  The
        targets are the policy's *current* timeouts, so an adaptive
        run's estimate is priced at its converged operating point."""
        em = self.energy_model
        if em is None:
            return 0.0
        if getattr(self.policy, "spin", False):
            return float(em.active_energy_uj(st.duration_ns / 1e3,
                                             spin=True)
                         * max(len(self._threads), 1))
        pol = self.policy
        t_s_us = getattr(pol, "t_short_us", None)
        if t_s_us is None:
            t_s_us = getattr(pol, "period_us", 0.0)
        t_l_us = getattr(getattr(pol, "cfg", None), "t_long_us", t_s_us)
        tl_arms = min(st.busy_tries, st.wakeups)
        ts_arms = st.wakeups - tl_arms
        return float(em.active_power_w * st.awake_ns / 1e3
                     + ts_arms * em.arm_energy_uj(float(t_s_us))
                     + tl_arms * em.arm_energy_uj(float(t_l_us)))

    # -- the paper's loop, policy-parameterized ----------------------------------
    def _run(self, slot: ThreadSlot | None = None) -> None:
        if slot is None:        # direct callers (tests/shims) get default
            slot = ThreadSlot(self.policy, tuple(range(len(self.queues))))
        policy = slot.policy
        st = self.stats
        wake = 0
        while self._running.is_set():
            t_cpu0 = time.thread_time_ns()
            lock_taken = False
            items = 0
            # stats are buffered during the sweep and flushed under ONE
            # _stats_lock acquisition per wake, after every queue lock
            # is back: a queue owner never blocks on another lock
            # (TryLock discipline — analysis rule LOCK002), and stats
            # contention drops from per-cycle to per-wake
            lat_pending: list[float] = []
            cycles_pending: list[int] = []
            # sweep own queues first; with steal, keep visiting the longest
            # unvisited backlog until none remains — mirroring the
            # simulator's sweep so both backends run the same semantics
            targets = list(slot.queues)
            visited = set(targets)
            si = 0
            while si < len(targets):
                qi = targets[si]
                si += 1
                q = self.queues[qi]
                if q.lock.try_acquire():
                    lock_taken = True
                    try:
                        busy_start = time.monotonic_ns()
                        # vacation = unattended time up to lock acquisition
                        # (not wake: earlier queues in this sweep took time)
                        vacation_ns = busy_start - q.last_busy_end_ns
                        while True:
                            burst = q.poll(self.burst_size)
                            if burst:
                                items += len(burst)
                                if wake % self._lat_every == 0:
                                    now = time.monotonic_ns()
                                    lat_pending.extend(
                                        (now - ts) / 1e3
                                        for ts, _ in burst[:4])
                                self.process([it for _, it in burst])
                            did = self.idle_work() if self.idle_work else False
                            if not burst and not did:
                                break
                        busy_end = time.monotonic_ns()
                        q.last_busy_end_ns = busy_end
                        policy.on_cycle_end((busy_end - busy_start) / 1e3,
                                            max(vacation_ns / 1e3, 1e-3))
                        cycles_pending.append(qi)
                    finally:
                        q.lock.release()
                if si == len(targets) and slot.steal:
                    # own/stolen queues done: steal the longest unvisited
                    # backlog next (post-drain depths, like the simulator)
                    best, cand = 0, -1
                    for j, qq in enumerate(self.queues):
                        if j not in visited and len(qq) > best:
                            best, cand = len(qq), j
                    if cand >= 0:
                        targets.append(cand)
                        visited.add(cand)
            t_cpu1 = time.thread_time_ns()
            with self._stats_lock:
                st.wakeups += 1
                st.awake_ns += t_cpu1 - t_cpu0
                st.items += items
                if lock_taken:
                    st.cycles += 1
                if lat_pending:
                    st.latency_us.extend(lat_pending)
                for qi in cycles_pending:
                    self._cycles_q[qi] += 1
            wake += 1
            sleep_ns = policy.on_wake(WakeContext(
                primary=lock_taken or not slot.demote_on_miss, items=items,
                # ns since run start, matching the simulator's clock
                now_ns=time.monotonic_ns() - st.started_ns))
            if sleep_ns > 0:
                self.sleep_fn(sleep_ns)

    def _run_app(self) -> None:
        """Co-run application loop: one quantum of ``app_load.step()``
        per iteration until the runtime stops; totals are folded into
        the run's stats when the thread exits (stop() joins first)."""
        ops = 0
        t_cpu0 = time.thread_time_ns()
        app = self.app_load
        while self._running.is_set():
            ops += app.step()
        dt = time.thread_time_ns() - t_cpu0
        with self._stats_lock:
            self.stats.app_ops += ops
            self.stats.app_cpu_ns += dt

    # -- workload replay ---------------------------------------------------------
    def run(self, workload, *, duration_us: float,
            payload: Callable[[int], object] = lambda i: i,
            seed: int = 0, drain_timeout_s: float = 5.0,
            dispatcher=None, schedule=None) -> RunStats:
        """Replay ``workload`` against the queues in real time, then stop.

        Arrivals are generated by ``workload.iter_arrivals`` and pushed at
        their scheduled offsets (a software traffic generator on the same
        host); ``dispatcher`` (default round-robin, the historical
        behavior) picks the queue each arrival lands in.  ``schedule``
        (a ``repro.runtime.schedule.LoadSchedule``) modulates the
        workload's rate over the run — the live-replay counterpart of
        ``SimRunConfig.schedule``, through the identical time-warping
        wrapper.  Returns the unified ``RunStats`` — directly comparable
        to ``repro.runtime.sim.simulate_run`` for the same
        policy/workload/schedule.
        """
        base_wl = getattr(workload, "base", workload)  # unwrap pre-scheduled
        workload_label = getattr(base_wl, "name", type(base_wl).__name__)
        if schedule is not None:
            from .workload import ScheduledWorkload
            workload = ScheduledWorkload(workload, schedule)
        rng = np.random.default_rng(seed)
        dispatcher = dispatcher or RoundRobinDispatch()
        dispatcher.reset(len(self.queues), rng)
        self.start()
        t0 = time.monotonic_ns()
        n = 0
        max_lag_ns = 0
        for t_us in workload.iter_arrivals(duration_us, rng):
            gap_ns = t0 + int(t_us * 1e3) - time.monotonic_ns()
            if gap_ns > 0:
                time.sleep(gap_ns / 1e9)
            else:
                max_lag_ns = max(max_lag_ns, -gap_ns)
            backlogs = [len(q) for q in self.queues]
            self.queues[dispatcher.pick(n, backlogs)].push(payload(n))
            n += 1
        tail_ns = t0 + int(duration_us * 1e3) - time.monotonic_ns()
        if tail_ns > 0:
            time.sleep(tail_ns / 1e9)
        deadline = time.monotonic() + drain_timeout_s
        while any(len(q) for q in self.queues) and time.monotonic() < deadline:
            time.sleep(0.005)
        st = self.stop()
        st.workload = workload_label
        sched = schedule or getattr(workload, "schedule", None)
        st.schedule = sched.descriptor() if sched is not None else ""
        st.feeder_lag_us = max_lag_ns / 1e3
        if n and max_lag_ns / 1e3 > 0.05 * duration_us:
            warnings.warn(
                f"workload generator fell {max_lag_ns / 1e3:.0f}us behind "
                f"its schedule ({n} arrivals in {duration_us:.0f}us): the "
                "host cannot source this rate in real time, so the run is "
                "not comparable to a simulate_run of the same workload",
                RuntimeWarning, stacklevel=2)
        return st
