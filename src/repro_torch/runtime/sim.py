"""Event-driven simulation engine: any policy × any workload.

Generalizes the paper-specific renewal simulator (Sec 4/5 apparatus) into
an engine that executes an arbitrary ``RetrievalPolicy`` against an
arbitrary ``Workload`` over one or more Rx queues: a ``Dispatcher``
splits arrivals across queues (RSS emulation), an ``Assignment`` decides
which threads sweep which queues, a waking poller races each queue's
lock, the winner drains at deterministic rate mu (busy-period recursion,
arrivals drawn from the workload meanwhile), losers re-sleep whatever
the policy tells them.  Sleep overshoot follows a measured-from-the-
paper affine model (Table 1) so "what if this policy ran on nanosleep?"
is answerable without kernel patches.

The environment model (``SimRunConfig``, ``SleepModel``) and run-setup
normalization live in ``repro.runtime.simcore``, shared with the batched
JAX engine (``repro.runtime.batched``) — this module is the *exact,
serial* engine of the pair: it walks the event sequence one wake at a
time and explores one configuration per call.

With ``n_queues=1`` and the default round-robin dispatcher the engine
reduces *exactly* to the original single-queue event sequence — same
seed, same wakeups/cycles/drops — which the regression tests pin down.

Aggregate-exact accounting: arrivals are *counts per window*
(``workload.counts_in``), never per-packet events, so a 10s line-rate
simulation costs O(#cycles) not O(#packets).

Spinning policies (``policy.spin``) switch to an analytic fluid model —
a per-wake event loop for a policy that never sleeps would cost O(time /
poll granularity) for information a closed form already gives.
"""

from __future__ import annotations

import numpy as np

from .policy import WakeContext
from .simcore import (
    HR_SLEEP_MODEL,
    NANOSLEEP_MODEL,
    PERFECT_SLEEP_MODEL,
    SimRunConfig,
    SleepModel,
    WindowAccum,
    prepare_run,
    queue_reservoirs,
    scheduled_workload,
)
from .stats import QueueStats, Reservoir, RunStats

__all__ = [
    "SleepModel",
    "HR_SLEEP_MODEL",
    "NANOSLEEP_MODEL",
    "PERFECT_SLEEP_MODEL",
    "SimRunConfig",
    "simulate_run",
    "simulate_fleet_run",
    "fleet_tail_reference",
]


def simulate_run(policy, workload, cfg: SimRunConfig | None = None, *,
                 dispatcher=None, assignment=None) -> RunStats:
    """Execute ``policy`` against ``workload`` in simulated time.

    ``dispatcher`` (default ``RoundRobinDispatch``) splits arrivals
    across ``cfg.n_queues`` Rx queues; ``assignment`` (default
    ``SharedAssignment``) maps poller threads to queues.  Spinning
    policies use the analytic fluid model and ignore both (a sweeping
    core sees the union of all rings).
    """
    cfg = cfg or SimRunConfig()
    if getattr(policy, "spin", False):
        return _simulate_spin(policy, workload, cfg)

    base_wl = getattr(workload, "base", workload)   # unwrap pre-scheduled
    workload_label = getattr(base_wl, "name", type(base_wl).__name__)
    setup = prepare_run(policy, workload, cfg, dispatcher=dispatcher,
                        assignment=assignment)
    workload = setup.workload      # schedule-wrapped when cfg.schedule set
    rng = setup.rng
    nq = setup.n_queues
    dispatcher = setup.dispatcher
    slots = setup.slots
    pols = setup.policies
    m = len(slots)
    mu = cfg.service_rate_mpps

    # Threads are launched actively (paper Sec 5): first wakes land within
    # one short timeout, not spread over T_L (that would fabricate a startup
    # backlog transient the real system does not have).
    wake_at = np.empty(m)
    for p in pols:
        idxs = [i for i, s in enumerate(slots) if s.policy is p]
        t_s0 = p.on_wake(WakeContext(primary=True)) / 1e3
        wake_at[idxs] = rng.uniform(0.0, max(t_s0, 1e-3), size=len(idxs))

    backlog = np.zeros(nq)
    last_advanced = 0.0      # arrivals accounted up to here
    busy_until = np.zeros(nq)         # each lock held until this time
    last_busy_end = np.zeros(nq)

    offered = dropped = serviced = busy_tries = wakeups = 0
    truncations = 0
    offered_q = np.zeros(nq, dtype=np.int64)
    dropped_q = np.zeros(nq, dtype=np.int64)
    serviced_q = np.zeros(nq, dtype=np.int64)
    busy_tries_q = np.zeros(nq, dtype=np.int64)
    cycles_q = np.zeros(nq, dtype=np.int64)
    vac, bus, nvs = [], [], []
    # one latency reservoir per queue, decorrelated seeds (simcore)
    lat_q = queue_reservoirs(cfg, nq)
    awake_us = 0.0
    lat_area = 0.0           # queue-depth integral (packet*us), Little's law
    # EnergyModel accounting: active power on awake time, sleep +
    # transition charged per armed sleep at its programmed target (the
    # same arm-time convention as the batched kernels; the m initial
    # staggering sleeps are uncharged in every engine)
    em = cfg.energy_model
    energy_uj = 0.0

    nbins = int(cfg.duration_us / cfg.timeseries_bin_us) if cfg.timeseries_bin_us else 0
    b_rho = np.zeros(max(nbins, 1)); b_ts = np.zeros(max(nbins, 1))
    b_srv = np.zeros(max(nbins, 1)); b_off = np.zeros(max(nbins, 1))
    b_cnt = np.zeros(max(nbins, 1))
    wa = WindowAccum(cfg)        # no-op when cfg.window_us == 0

    def admit(q: int, n: int, at_t: float) -> None:
        """Room-clipped enqueue of ``n`` arrivals into queue ``q``; drops
        beyond queue capacity are counted (Rx-ring semantics)."""
        nonlocal offered, dropped
        offered += n
        offered_q[q] += n
        wa.add(at_t, offered=n)
        room = cfg.queue_capacity - backlog[q]
        if n > room:
            d = int(n - max(room, 0))
            dropped += d
            dropped_q[q] += d
            n = int(max(room, 0))
        backlog[q] += n
        if nbins:
            b = min(int(at_t / cfg.timeseries_bin_us), nbins - 1)
            b_off[b] += n + 0.0

    def advance_arrivals(to_t: float) -> None:
        """Accumulate workload arrivals on [last_advanced, to_t) and
        dispatch them across the queues."""
        nonlocal last_advanced
        if to_t <= last_advanced:
            return
        n = workload.counts_in(last_advanced, to_t)
        if nq == 1:
            admit(0, n, last_advanced)
        elif n > 0:
            parts = dispatcher.split(int(n), backlog)
            for q in range(nq):
                if parts[q]:
                    admit(q, int(parts[q]), last_advanced)
        last_advanced = to_t

    def drain(q: int, t_start: float) -> tuple[float, int]:
        """Busy-period recursion on queue ``q``: serve its backlog at rate
        mu, dispatch workload arrivals meanwhile (this queue's share
        continues the recursion, other queues just accumulate), repeat
        until empty (round-capped so saturated runs still terminate;
        leftovers stay queued and the truncation is counted)."""
        nonlocal offered, dropped, last_advanced, truncations, lat_area
        total_t = 0.0
        served = 0.0
        cursor = t_start
        rounds = 0
        while backlog[q] >= 1.0 and rounds < 64:
            dt = backlog[q] / mu
            b_r = float(backlog[q])
            served += float(backlog[q])
            total_t += dt
            n = workload.counts_in(cursor, cursor + dt)
            cursor += dt
            if nq == 1:
                own = int(n)
            else:
                own = 0
                if n > 0:
                    parts = dispatcher.split(int(n), backlog)
                    own = int(parts[q])
                    for j in range(nq):
                        if j != q and parts[j]:
                            admit(j, int(parts[j]), cursor)
            offered += own
            offered_q[q] += own
            if own > cfg.queue_capacity:
                d = own - cfg.queue_capacity
                dropped += d
                dropped_q[q] += d
                own = cfg.queue_capacity
            backlog[q] = float(own)
            # Little integral, drain round r: the b_r being served decline
            # linearly to 0 over dt while the next round's own arrivals
            # accumulate linearly to `own`
            lat_area += dt * (b_r + own) / 2.0
            wa.add(cursor, offered=own, served=b_r,
                   lat_area=dt * (b_r + own) / 2.0)
            if nbins:
                # bin the drained queue's own busy-period arrivals too, so
                # sum(offered_series * bin) tracks RunStats.offered
                b = min(int(cursor / cfg.timeseries_bin_us), nbins - 1)
                b_off[b] += own + 0.0
            rounds += 1
        if backlog[q] >= 1.0:
            truncations += 1
        last_advanced = max(last_advanced, cursor)
        return total_t, int(served)

    # correlated stall windows (lazy Poisson process)
    next_stall = (rng.exponential(1.0 / cfg.stall_rate_per_us)
                  if cfg.stall_rate_per_us else np.inf)
    stall_end = -1.0

    while True:
        i = int(np.argmin(wake_at))
        t = float(wake_at[i])
        if t >= cfg.duration_us:
            break
        if cfg.stall_rate_per_us:
            while next_stall <= t:
                stall_end = max(stall_end,
                                next_stall + rng.exponential(cfg.stall_mean_us))
                next_stall += rng.exponential(1.0 / cfg.stall_rate_per_us)
            if t < stall_end:
                wake_at[i] = stall_end + rng.uniform(0.0, 1.0)
                continue
        wakeups += 1
        awake_us += cfg.wake_cost_us
        e_wake = em.active_power_w * cfg.wake_cost_us
        energy_uj += e_wake
        wa.add(t, awake=cfg.wake_cost_us, energy_uj=e_wake)
        advance_arrivals(t)

        slot = slots[i]
        pol = slot.policy
        lock_taken = False
        t_cursor = t
        srv_total = 0
        targets = list(slot.queues)
        visited = set(targets)
        si = 0
        while si < len(targets):
            q = targets[si]
            si += 1
            if t_cursor < busy_until[q]:
                # trylock failed: another poller is draining this queue.
                busy_tries += 1
                busy_tries_q[q] += 1
            else:
                # trylock won: primary for this queue. Vacation ended now.
                lock_taken = True
                v = t_cursor - float(last_busy_end[q])
                n_v = float(backlog[q])
                # Little integral, vacation phase: the n_v packets found
                # at busy start arrived ~uniformly over the vacation
                lat_area += n_v * max(v, 0.0) / 2.0
                wa.add(t_cursor, lat_area=n_v * max(v, 0.0) / 2.0)
                b_time, srv = drain(q, t_cursor)
                serviced += srv
                serviced_q[q] += srv
                srv_total += srv
                cycles_q[q] += 1
                busy_until[q] = t_cursor + b_time
                last_busy_end[q] = busy_until[q]
                awake_us += b_time
                e_busy = em.active_power_w * b_time
                energy_uj += e_busy
                wa.add(t_cursor, awake=b_time, energy_uj=e_busy)

                vac.append(v); bus.append(b_time); nvs.append(n_v)
                # Latency: packets found at busy start waited (uniform
                # arrival in V) V/2 on average + their drain position.
                # Sample a handful per cycle for percentiles.
                if n_v >= 1:
                    k = min(int(n_v), 8)
                    arr = rng.uniform(0.0, max(v, 1e-9), size=k)      # age
                    pos = np.sort(rng.uniform(0.0, n_v, size=k)) / mu
                    samp = (max(v, 1e-9) - arr + pos).tolist()
                    lat_q[q].extend(samp)
                    wa.latency_samples(t_cursor, samp)

                pol.on_cycle_end(b_time, max(v, 1e-9))
                t_cursor = float(busy_until[q])
            if si == len(targets) and slot.steal:
                # own queues done: steal from the longest unvisited backlog
                cand, best = -1, 1.0
                for j in range(nq):
                    if j not in visited and backlog[j] >= best:
                        cand, best = j, float(backlog[j])
                if cand >= 0:
                    targets.append(cand)
                    visited.add(cand)

        if not lock_taken:
            # every ring contended: backup role (unless this thread is its
            # ring's only home poller, in which case it keeps its cadence)
            t_b = pol.on_wake(WakeContext(primary=not slot.demote_on_miss,
                                          now_ns=int(t * 1e3))) / 1e3
            e_arm = em.arm_energy_uj(t_b)
            energy_uj += e_arm
            wa.add(t, energy_uj=e_arm)
            delay = float(cfg.sleep_model.sample(t_b, rng))
            if cfg.interference_prob and rng.random() < cfg.interference_prob:
                delay += rng.exponential(cfg.interference_mean_us)
            wake_at[i] = t + delay
            continue

        t_s = pol.on_wake(WakeContext(primary=True,
                                      now_ns=int(t_cursor * 1e3))) / 1e3
        e_arm = em.arm_energy_uj(t_s)
        energy_uj += e_arm
        wa.add(t_cursor, energy_uj=e_arm)
        wa.control(t, float(getattr(pol, "rho", np.nan)), t_s)
        if nbins:
            b = min(int(t / cfg.timeseries_bin_us), nbins - 1)
            b_rho[b] += getattr(pol, "rho", np.nan)
            b_ts[b] += t_s; b_srv[b] += srv_total; b_cnt[b] += 1

        delay = float(cfg.sleep_model.sample(t_s, rng))
        if cfg.interference_prob and rng.random() < cfg.interference_prob:
            delay += rng.exponential(cfg.interference_mean_us)
        wake_at[i] = t_cursor + delay

    cnt = np.maximum(b_cnt, 1)
    nbins_eff = max(nbins, 1)
    # run-level latency = weighted union of the per-queue reservoirs
    # (a fresh object even for one queue: RunStats.merge pools the
    # run-level and per-queue reservoirs independently, so they must
    # never alias)
    lat = Reservoir(cfg.latency_reservoir, seed=cfg.seed)
    for r in lat_q:
        lat.merge(r)
    sched = cfg.schedule or getattr(workload, "schedule", None)
    return RunStats(
        backend="sim",
        policy=getattr(policy, "name", type(policy).__name__),
        workload=workload_label,
        schedule=sched.descriptor() if sched is not None else "",
        wakeups=wakeups, cycles=len(bus), busy_tries=busy_tries,
        items=serviced, offered=offered, dropped=dropped,
        awake_ns=round(awake_us * 1e3), started_ns=0,
        stopped_ns=round(cfg.duration_us * 1e3),
        latency_us=lat,
        latency_area_us=lat_area,
        energy_uj=energy_uj,
        windows=wa.series(cfg),
        per_queue=[QueueStats(queue=q,
                              offered=int(offered_q[q]),
                              dropped=int(dropped_q[q]),
                              serviced=int(serviced_q[q]),
                              busy_tries=int(busy_tries_q[q]),
                              cycles=int(cycles_q[q]),
                              latency_us=lat_q[q])
                   for q in range(nq)],
        drain_truncations=truncations,
        vacations_us=np.asarray(vac),
        busies_us=np.asarray(bus),
        n_v=np.asarray(nvs),
        rho_series=b_rho / cnt if nbins else np.empty(0),
        ts_series=b_ts / cnt if nbins else np.empty(0),
        tput_series_mpps=(b_srv / cfg.timeseries_bin_us) if nbins else np.empty(0),
        offered_series_mpps=(b_off / cfg.timeseries_bin_us) if nbins else np.empty(0),
        series_t_us=(np.arange(nbins_eff) * cfg.timeseries_bin_us) if nbins
        else np.empty(0),
    )


def _simulate_spin(policy, workload, cfg: SimRunConfig) -> RunStats:
    """Analytic fluid model for spinning policies (paper Listing 1).

    One dedicated core polls continuously; CPU is 100% by construction;
    latency is just the drain position (no vacations); loss only beyond
    saturation.  A spinning sweep sees the union of all Rx rings, so
    multi-queue runs aggregate to one fluid queue of total capacity.

    Correlated stall windows (``cfg.stall_rate_per_us`` /
    ``stall_mean_us``) deschedule even a spinning core — on a shared
    host CFS alternates the always-runnable spinner with competing
    threads — so the fluid model serves *nothing* while a window is
    open: arrivals pile into the ring and overflow it exactly as they
    would on real co-located hardware.  Per-wake interference
    (``interference_prob``) does not apply: a spinner never sleeps, so
    there is no wake to delay.
    """
    rng = np.random.default_rng(cfg.seed)
    base_wl = getattr(workload, "base", workload)   # unwrap pre-scheduled
    workload_label = getattr(base_wl, "name", type(base_wl).__name__)
    workload = scheduled_workload(workload, cfg)
    workload.reset(rng)
    policy.reset()
    q_cap = cfg.queue_capacity * max(int(cfg.n_queues), 1)
    n_threads = max(policy.threads, 1)
    # a spinner never sleeps: flat active burn at the DVFS busy scale
    # (a pinned-turbo core), no C-state or transition component at all
    em = cfg.energy_model
    spin_power_w = float(em.active_energy_uj(1.0, spin=True)) * n_threads
    step = 10.0
    t = 0.0
    offered = dropped = serviced = 0
    backlog = 0.0
    lat_num = 0.0
    wa = WindowAccum(cfg)        # no-op when cfg.window_us == 0
    # lazy Poisson stall process, windows merged via max (the same
    # semantics as the sleep&wake event loop above)
    next_stall = (rng.exponential(1.0 / cfg.stall_rate_per_us)
                  if cfg.stall_rate_per_us else np.inf)
    stall_end = -1.0
    while t < cfg.duration_us:
        n = workload.counts_in(t, t + step)
        offered += n
        stalled = 0.0
        if cfg.stall_rate_per_us:
            # carry-over from windows still open at the step boundary
            if stall_end > t:
                stalled += min(stall_end, t + step) - t
            while next_stall <= t + step:
                # windows merge via max: only the segment not already
                # covered counts, from its true start (not the step's)
                w_start = max(next_stall, stall_end)
                w_end = next_stall + rng.exponential(cfg.stall_mean_us)
                if w_end > w_start:
                    seg0 = min(max(w_start, t), t + step)
                    seg1 = min(max(w_end, t), t + step)
                    stalled += max(seg1 - seg0, 0.0)
                    stall_end = max(stall_end, w_end)
                next_stall += rng.exponential(1.0 / cfg.stall_rate_per_us)
            stalled = min(stalled, step)
        cap = cfg.service_rate_mpps * (step - stalled)
        do = min(backlog + n, cap)
        serviced += int(do)
        backlog = backlog + n - do
        if backlog > q_cap:
            dropped += int(backlog - q_cap)
            backlog = float(q_cap)
        lat_num += backlog * step        # area under queue curve (Little)
        # windowed series: a spinner's CPU is one full core per thread in
        # EVERY window by construction (the flat-burn signature the
        # adaptation benchmark's busy-poll verdict asserts); latency area
        # includes the drain position like the aggregate override
        wa.add(t, offered=n, served=do, awake=step * n_threads,
               lat_area=backlog * step + do / cfg.service_rate_mpps,
               energy_uj=spin_power_w * step)
        t += step
    mean_lat = lat_num / max(serviced, 1)
    sched = cfg.schedule or getattr(workload, "schedule", None)
    return RunStats(
        backend="sim",
        policy=getattr(policy, "name", type(policy).__name__),
        workload=workload_label,
        schedule=sched.descriptor() if sched is not None else "",
        wakeups=0, cycles=1, busy_tries=0,
        items=serviced, offered=offered, dropped=dropped,
        # every spinning thread burns its whole core
        awake_ns=round(cfg.duration_us * 1e3) * n_threads,
        started_ns=0,
        stopped_ns=round(cfg.duration_us * 1e3),
        latency_us=Reservoir(4, seed=cfg.seed),
        latency_area_us=lat_num + serviced / cfg.service_rate_mpps,
        energy_uj=spin_power_w * cfg.duration_us,
        windows=wa.series(cfg),
        latency_override={
            "mean": float(mean_lat + 1.0 / cfg.service_rate_mpps),
            "p99": float(mean_lat * 3 + 1.0 / cfg.service_rate_mpps),
            "worst": float(q_cap / cfg.service_rate_mpps),
        },
        vacations_us=np.zeros(1), busies_us=np.asarray([cfg.duration_us]),
        n_v=np.zeros(1),
    )


def simulate_fleet_run(policy_factory, rate_mpps: float,
                       cfg: SimRunConfig, fleet, *,
                       workload_factory=None) -> list[RunStats]:
    """Exact event-engine reference for a fleet: one ``simulate_run``
    per host at that host's *static* LB share of the fleet-aggregate
    Poisson stream (``FleetConfig.shares()`` — Poisson thinning is
    exact for uniform/weighted splits; ``least-loaded`` is a batched-
    engine-only dynamic policy and uses its uniform long-run share
    here).  Host ``h`` runs with seed ``cfg.seed + h``, matching the
    fleet kernel's per-host key contract, so a fleet row and this
    reference draw host-equivalent randomness.

    ``policy_factory(h)`` must return a FRESH policy object per host
    (policies are stateful); ``workload_factory(host_rate_mpps)``
    defaults to ``PoissonWorkload``.  Returns the per-host ``RunStats``
    list — roll it up with ``RunStats.merge_all``, or feed it to
    ``fleet_tail_reference`` for the exact hedged-tail distribution.
    """
    from dataclasses import replace as _replace

    from .workload import PoissonWorkload

    fleet.validate()
    if workload_factory is None:
        workload_factory = PoissonWorkload
    shares = fleet.shares()
    out = []
    for h in range(fleet.n_hosts):
        cfg_h = _replace(cfg, seed=cfg.seed + h)
        out.append(simulate_run(policy_factory(h),
                                workload_factory(rate_mpps * shares[h]),
                                cfg_h))
    return out


def fleet_tail_reference(host_stats, fleet, hedge_deadline_us: float, *,
                         n_samples: int = 200_000,
                         seed: int = 0) -> np.ndarray:
    """Exact first-completion-wins hedging over measured per-host
    latency samples — the reference the fluid/closed-form hedged-tail
    model is parity-pinned against.

    Per simulated request: pick a host by served share, draw a base
    latency from that host's empirical reservoir
    (``host_stats[h].latency_us``), add its topology delay (rack cost
    plus, for far hosts, an Exp-distributed share of the bottleneck-link
    M/M/1 wait at the measured far-rack offered rate).  If the total
    exceeds the hedge deadline D, duplicate to a second host drawn from
    the other replicas and finish at ``min(original, D + partner's full
    latency)`` — first completion wins, exactly.  ``D <= 0`` disables
    hedging.  Returns the ``n_samples`` end-to-end latencies; quantile
    them directly.
    """
    fleet.validate()
    if len(host_stats) != fleet.n_hosts:
        raise ValueError("need one RunStats per host")
    rng = np.random.default_rng(seed)
    pools = [np.asarray(rs.latency_us, dtype=np.float64)
             for rs in host_stats]
    if any(p.size == 0 for p in pools):
        raise ValueError("every host needs latency samples "
                         "(run the event engine, not a spin override)")
    served = np.asarray([max(rs.items, 1) for rs in host_stats],
                        dtype=np.float64)
    weight = served / served.sum()
    far = fleet.far_mask()
    duration_us = host_stats[0].duration_ns / 1e3
    far_rate = float(sum(rs.offered for rs, f in zip(host_stats, far)
                         if f)) / duration_us
    link_wait_us = fleet.link_wait_us(far_rate)
    cost = fleet.host_cost_us()

    def draw(hosts: np.ndarray) -> np.ndarray:
        """End-to-end latency samples for the given host choices."""
        base = np.empty(hosts.size)
        for h in range(fleet.n_hosts):
            m = hosts == h
            if m.any():
                base[m] = rng.choice(pools[h], size=int(m.sum()))
        topo = cost[hosts].astype(np.float64)
        if link_wait_us > 0.0:
            f = far[hosts]
            topo[f] += rng.exponential(link_wait_us, size=int(f.sum()))
        return base + topo

    hosts = rng.choice(fleet.n_hosts, size=n_samples, p=weight)
    lat = draw(hosts)
    d = float(hedge_deadline_us)
    if d > 0.0 and fleet.n_hosts > 1:
        slow = lat > d
        n_slow = int(slow.sum())
        if n_slow:
            # partner: an independent draw from the OTHER replicas,
            # renormalized served-share weights
            pw = np.tile(weight, (n_slow, 1))
            pw[np.arange(n_slow), hosts[slow]] = 0.0
            pw /= pw.sum(axis=1, keepdims=True)
            cum = np.cumsum(pw, axis=1)
            u = rng.random(n_slow)
            partners = (u[:, None] > cum).sum(axis=1).astype(np.int64)
            lat[slow] = np.minimum(lat[slow], d + draw(partners))
    return lat
