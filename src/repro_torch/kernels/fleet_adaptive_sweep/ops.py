"""Public fleet sweep by event jumps and its plain PyTorch version.

``fleet_adaptive_sweep`` simulates every point of a fleet sweep grid over
event-jump steps: ``n_hosts`` Metronome hosts a point behind one load
balancer, advancing in lock-step by one shared ``dt`` a point, the body of
the reference's ``_build_fleet_sweep.fleet_step_a``
(``src/repro/runtime/fleet.py:497``, a ``lax.scan`` over the step budget,
``:794``, under ``jax.jit(jax.vmap(...))``, ``:798-808``).  For CUDA tensors
it launches the hand-written kernel (``csrc/fleet_adaptive_sweep.cu``: up
to 256 hosts one block a point, producer warps make every host's draws into
a ring in shared memory and a consumer lane a host runs the jumps, the
cross-host stages as reductions over the consumer warps; up to 1,792 hosts
a cluster of 8 such blocks a point, 32 host lanes a block and one consumer
thread a host, the reductions exchanged through distributed shared memory;
beyond, several hosts a thread through a global scratch) and counts the
call in
``fleet_adaptive_sweep.launches`` and, by the (M_MAX, Q_MAX, route) build it
launched, in ``fleet_adaptive_sweep.launches_by_build``; for CPU tensors it
runs ``reference_fleet_adaptive_sweep``.  It never falls back from the
kernel to the plain version.

Each step, for every point, in float32:

  1. the schedule's segment at ``now = duration - remaining``; under
     least-loaded, the backlog snapshot refreshes where ``now + 1e-6``
     reaches the refresh lattice's next point (``next_ref``, 0 at the
     start), which then moves to ``(floor(now * (1/stale) + 1e-6) + 1)
     stale``; the shares are a softmax of ``-snapshot * (1/softness)``, or
     the static ones;
  2. every host's queue rates ``(lam * share * scale) * (1/n_queues)``;
  3. one shared jump: the least over the point's hosts of every host's
     wake, drain-out, fill and next stall start, with the segment's end,
     the distance to ``next_ref`` and the remaining time; floored at the
     slot unless a wake or a drain-out comes first, paced as ``remaining /
     steps_left`` in the budget's last eighth (the fleet's budget:
     ``runtime/fleet.py``);
  4. every host runs the event-jump sweep's host step (``adaptive_sweep``:
     arrivals, drain, releases, claims, the stall process) at that ``dt``;
  5. the topology charges each host's admissions its rack cost and, on a
     far host, the link's wait ``1 / max(link - far / dt, (1 - 0.98)
     link)``, ``far`` the far rack's admissions of the step; hedging (a
     point's deadline D > 0) duplicates ``adm * sigmoid((backlog (1/mu) -
     D) / (D/4 + 1e-6))`` of each host onto the least-loaded other host,
     as in the fixed-slot fleet sweep (``fleet_sweep``).

Host ``h`` of a point seeded ``s`` draws the event-jump sweep's Philox
stream of a point seeded ``s + h`` (``adaptive_sweep.philox``, key ``((lo +
h) mod 2**32, hi)``): a one-host fleet without topology or hedging is the
event-jump sweep of its seed, bit for bit, where ``1/n_queues`` is exact.

**Order.**  Every sum over a point's hosts runs in ``fleet_sweep``'s one
order (``host_sum``); a minimum takes no order.  The reference's divisions
by a compile-time constant (``now / stale``, ``/ softness``, the hedge
gate's ``/ mu``, ``/ mu`` in the awake time) are products with the float32
reciprocal, as XLA compiles them; its divisions by traced values (``/ dt``
in the link's rate, ``remaining / steps_left``, the drain and fill
bounds) stay divisions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..adaptive_sweep import philox as step_philox
from ..adaptive_sweep.ops import AdaptiveParams, _recip, _sqrt, _step_inputs
from ..fleet_sweep.ops import (
    STAT_NAMES,
    FleetParams,
    _check as _check_fleet,
    host_rows,
    host_sum,
)
from ..slot_sweep.ops import _f32, _sum, energy_arm_cost
from .kernel import launch_fleet_adaptive_sweep

__all__ = ["STAT_NAMES", "POINT_NAMES", "fleet_constants", "reference_fleet_adaptive_sweep",
           "fleet_adaptive_sweep"]

# the per-point outputs: live steps, forced steps, the simulated time
POINT_NAMES = ("n_steps", "forced_steps", "sim_time")
_CHUNK_ELEMS = 1 << 18   # host-steps of draws the plain version makes at once
_INF = float("inf")
# Where the arithmetic leaves an order or a math library open, the plain
# version takes the kernel's (its bit-equality on the card rests on that);
# each such choice is a name here, so that a test can put the reference's
# compiled choice in its place: the float32 exp of the softmax and of the
# hedge gate, the sum over a host's queues of its admissions and (for the
# hedge gate) of its backlog, and ``host_sum``, every sum over a point's
# hosts.
_exp = torch.exp
_queue_sum = _sum


def fleet_constants(fleet: FleetParams, params: AdaptiveParams) -> dict[str, float]:
    """The fleet's float32 constants beside ``params.constants()``: the
    balancer's ``1/softness``, the refresh lattice's period ``stale =
    stale_every_slots * slot_us`` and its reciprocal, the topology's costs
    and the link's rate and floor, and the hedge gate's epsilon."""
    stale = float(fleet.stale_every_slots) * params.slot_us
    c = fleet.constants(params)
    return {"inv_soft": c["inv_soft"], "near_cost": c["near_cost"], "far_cost": c["far_cost"],
            "link_rate": c["link_rate"], "link_floor": c["link_floor"],
            "hedge_eps": c["hedge_eps"], "stale": _f32(stale), "inv_stale": _recip(stale)}


def reference_fleet_adaptive_sweep(t_s, t_l, m, nq, lam, seed_lo, seed_hi, hedge_d, sched_edges,
                                   sched_scales, params: AdaptiveParams, fleet: FleetParams,
                                   draws=None) -> dict[str, torch.Tensor]:
    """Plain version: the reference's per-step fleet update, vectorised over
    the (point, host) rows, with the steps in a Python loop that ends when
    every point has reached the run's duration (the reference's later steps
    are inert).  Every value is float32; sums over queues run left to right
    and sums over hosts in the kernel's order (``host_sum``).

    Per point (P,): the columns of ``fleet_sweep`` (``lam`` the point's
    rate, which the balancer splits; ``hedge_d`` <= 0: no hedging);
    ``sched_edges`` and ``sched_scales`` float32 (P, n_seg) or ``None``.
    ``params`` is the event-jump sweep's (no windows; ``max_steps`` the
    fleet's budget), ``fleet`` the fleet's.  ``draws`` (default: the
    event-jump sweep's Philox contract at each host's key) supplies the
    noise of the P * H rows, point-major; see ``adaptive_sweep.philox.
    StepDraws``.  Returns each of ``STAT_NAMES`` as a float32 tensor (P, H)
    and each of ``POINT_NAMES`` as one (P,)."""
    p, fp = params, fleet
    c = p.constants()
    fc = fleet_constants(fp, p)
    fl = p.flags
    dev, f32 = t_s.device, torch.float32
    n_pts, n_h = t_s.shape[0], fp.n_hosts
    n_rows = n_pts * n_h
    n_m, n_q = int(m.max()), int(nq.max())

    def rows(x):                 # a point's value on each of its hosts' rows
        return x.repeat_interleave(n_h, 0)

    if draws is None:
        lo, hi = host_rows(seed_lo, seed_hi, n_h)
        draws = step_philox.StepDraws(lo, hi, m=n_m, q=n_q, **fl)

    def const(x: float) -> torch.Tensor:
        # a tensor, not a Python number: PyTorch divides a CUDA tensor by a
        # Python number as a product with its reciprocal, the kernel divides
        return torch.tensor(x, dtype=f32, device=dev)

    mu, inf = const(c["mu"]), const(_INF)
    eps_rate, eps_wake = c["eps_rate"], c["eps_wake"]
    m_r, nq_r, t_s_r, t_l_r = rows(m), rows(nq), rows(t_s), rows(t_l)
    tmask = torch.arange(n_m, device=dev)[None, :] < m_r[:, None]
    qidx = torch.arange(n_q, device=dev)
    qmask = qidx[None, :] < nq_r[:, None]
    # the reference's where(qmask, 1.0 / nq, 0.0): a queue's share of a
    # host's rate, and of its duplicates
    q_share = torch.where(qmask, 1.0 / nq_r.to(f32)[:, None], 0.0)
    e_arm_s = energy_arm_cost(t_s_r, p.sleep_states)
    e_arm_l = energy_arm_cost(t_l_r, p.sleep_states)
    ts1, tl1 = (t_s_r * c["slope1"])[:, None], (t_l_r * c["slope1"])[:, None]
    if sched_edges is not None:
        n_seg = sched_edges.shape[1]
        sched_edges = sched_edges.contiguous()

    # the balancer, the topology and the hedge stage
    balanced = fp.lb_code == 2
    if balanced:
        snap = torch.zeros((n_pts, n_h), dtype=f32, device=dev)
        next_ref = torch.zeros((n_pts,), dtype=f32, device=dev)
        share = torch.zeros((n_pts, n_h), dtype=f32, device=dev)
    else:
        share = torch.tensor(fp.shares, dtype=f32, device=dev)[None, :].expand(n_pts, -1)
    hedged = bool((hedge_d > 0.0).any())
    hedge_on = (hedge_d > 0.0).to(f32)[:, None]
    hedge_den = 0.25 * hedge_d[:, None] + fc["hedge_eps"]
    q_live = qidx[None, :] < nq[:, None]
    q_share_pt = 1.0 / nq.to(f32)[:, None]
    far = torch.arange(n_h, device=dev) < fp.far_count
    rack = torch.where(far, fc["far_cost"], fc["near_cost"])
    h_idx = torch.arange(n_h, device=dev)
    pts = torch.arange(n_pts, device=dev)

    init = draws.initial()
    sleep_rem = torch.where(tmask, (init["sleep_u"] * t_s_r[:, None]).clamp(min=c["floor"]),
                            _INF)
    next_stall = (init["stall_e"] * c["inv_stall"] if fl["stall"]
                  else torch.full((n_rows,), _INF, dtype=f32, device=dev))
    attached = torch.full((n_rows, n_m), -1, dtype=torch.int64, device=dev)
    backlog = torch.zeros((n_rows, n_q), dtype=f32, device=dev)
    vac = torch.zeros_like(backlog)
    arr_res = torch.zeros_like(backlog)
    stall_end = torch.full((n_rows,), -1.0, dtype=f32, device=dev)
    rem = torch.full((n_pts,), c["duration"], dtype=f32, device=dev)
    duration = const(c["duration"])
    acc = torch.zeros((n_rows, len(STAT_NAMES) - 2), dtype=f32, device=dev)
    topo_acc = torch.zeros((n_pts, n_h), dtype=f32, device=dev)
    dup_acc = torch.zeros((n_pts, n_h), dtype=f32, device=dev)
    n_steps = torch.zeros((n_pts,), dtype=f32, device=dev)
    forced_steps = torch.zeros((n_pts,), dtype=f32, device=dev)
    steps_f, tail_steps = np.float32(c["steps"]), np.float32(c["tail_steps"])

    n_run = p.steps
    chunk = max(16, min(512, _CHUNK_ELEMS // max(n_rows, 1)))
    done = False
    for t0 in range(0, n_run, chunk):
        t1 = min(t0 + chunk, n_run)
        x = _step_inputs(draws.chunk(t0, t1), ts1, tl1, c, fl, n_m)
        z_q, slp_s, slp_l = x["z_q"].unbind(0), x["slp_s"].unbind(0), x["slp_l"].unbind(0)
        if fl["stall"]:
            st_len, st_gap = x["stall_len"].unbind(0), x["stall_gap"].unbind(0)
            jitter = x["jitter"].unbind(0)
        for k in range(t1 - t0):
            t = t0 + k
            live = rem > 0.0
            if not bool(live.any()):
                done = True
                break
            live_r = rows(live)
            prev = (sleep_rem, attached, backlog, vac, arr_res, stall_end, next_stall)
            if balanced:
                prev_lb = (snap, next_ref, share)
            now = duration - rem

            # 1. the schedule's segment; the balancer's refresh and shares
            if sched_edges is not None:
                si = (torch.searchsorted(sched_edges, now[:, None], right=True) - 1).clamp(
                    0, n_seg - 1)
                scale = sched_scales.gather(1, si)[:, 0]
                nxt = sched_edges.gather(1, (si + 1).clamp(max=n_seg - 1))[:, 0]
                seg_dt = torch.where(si[:, 0] + 1 < n_seg, nxt - now, inf)
            if balanced:
                fire = now + eps_wake >= next_ref
                if bool(fire.any()):
                    snap = torch.where(fire[:, None], _sum(backlog).view(n_pts, n_h), snap)
                    next_ref = torch.where(
                        fire, (torch.floor(now * fc["inv_stale"] + eps_wake) + 1.0) * fc["stale"],
                        next_ref)
                    xs = -snap * fc["inv_soft"]
                    e = _exp(xs - xs.max(dim=1, keepdim=True).values)
                    share = e / host_sum(e)[:, None]
                ref_dt = next_ref - now
            # 2. the hosts' queue rates: (lam * share * scale) * (1 / n_queues)
            if sched_edges is None:
                lam_h = lam[:, None] * share
            elif fp.lb_code == 0:
                # XLA folds the uniform share (a broadcast constant) into
                # the scale first: lam * (scale * share)
                lam_h = lam[:, None] * (scale[:, None] * share)
            else:
                lam_h = (lam[:, None] * share) * scale[:, None]
            lam_q = lam_h.reshape(n_rows)[:, None] * q_share

            # 3. the jump: the nearest boundary over the point's hosts
            occ = (attached[:, :, None] == qidx).any(1)
            sleeping = tmask & (attached < 0)
            wake_h = torch.where(sleeping, sleep_rem.clamp(min=0.0), inf).amin(1)
            net_out = torch.where(occ, mu - lam_q, 0.0)
            drain_q = torch.where(occ & (net_out > eps_rate),
                                  backlog.clamp(min=0.0) / net_out.clamp(min=eps_rate), inf)
            net_in = lam_q - torch.where(occ, mu, 0.0)
            fill_h = torch.where(qmask & (net_in > eps_rate) & (backlog < c["cap_fill"]),
                                 (c["cap"] - backlog) / net_in.clamp(min=eps_rate),
                                 inf).amin(1)
            wake_drain = torch.minimum(wake_h, drain_q.amin(1)).view(n_pts, n_h).amin(1)
            dt_b = torch.minimum(wake_drain, fill_h.view(n_pts, n_h).amin(1))
            if sched_edges is not None:
                dt_b = torch.minimum(dt_b, seg_dt)
            if balanced:
                dt_b = torch.minimum(dt_b, ref_dt)
            if fl["stall"]:
                dt_b = torch.minimum(dt_b, next_stall.view(n_pts, n_h).amin(1) - now)
            dt_b = torch.minimum(dt_b, rem)
            steps_left = steps_f - np.float32(t)
            floor_eff = wake_drain.clamp(min=eps_wake).clamp(max=c["floor"])
            if steps_left <= tail_steps:
                floor_eff = torch.maximum(floor_eff, rem / const(float(steps_left)))
            dt = torch.minimum(torch.maximum(dt_b, floor_eff), rem)
            forced = (dt > dt_b.clamp(min=c["floor"]) + eps_wake) & live
            t_new = now + dt
            dt_r, t_new_r = rows(dt), rows(t_new)

            # 4. the host step at dt (adaptive_sweep's)
            drain_now = occ & (drain_q <= (dt_r + eps_wake)[:, None])
            mu_a = lam_q * dt_r[:, None]
            z = torch.where(drain_now, 0.0, z_q[k])
            raw = arr_res + mu_a + _sqrt(mu_a) * z
            a = raw.clamp(min=0.0)
            arr_res = raw.clamp(max=0.0)
            mu_dt = (mu * dt_r)[:, None]
            room = (c["cap"] - backlog).clamp(min=0.0) + torch.where(occ, mu_dt, 0.0)
            adm = torch.minimum(a, room)
            offered, dropped = _sum(a), _sum(a - adm)
            serve = torch.where(occ, torch.minimum(backlog + adm, mu_dt), 0.0)
            b_new = (backlog + adm - serve).clamp(min=0.0, max=c["cap"])
            served = _sum(serve)
            b_sum = _sum(b_new)
            lat_area = 0.5 * (_sum(backlog) + b_sum) * dt_r
            vac = vac + torch.where(qmask & ~occ, dt_r[:, None], 0.0)
            backlog = b_new

            if fl["stall"]:
                fire_s = (next_stall <= t_new_r) & live_r
                w_end = next_stall + st_len[k]
                stall_end = torch.where(fire_s, torch.maximum(stall_end, w_end), stall_end)
                next_stall = torch.where(fire_s, next_stall + st_gap[k], next_stall)

            sleep_rem = torch.where(sleeping, sleep_rem - dt_r[:, None], sleep_rem)
            woken = sleeping & (sleep_rem <= eps_wake) & live_r[:, None]
            if fl["stall"]:
                push = woken & (t_new_r < stall_end)[:, None]
                woken = woken & ~push
                sleep_rem = torch.where(push, (stall_end - t_new_r)[:, None] + jitter[k],
                                        sleep_rem)
            n_wake = woken.sum(1, dtype=f32)

            q_done = occ & (backlog <= c["release"])
            t_done = (attached >= 0) & q_done.gather(1, attached.clamp(0, n_q - 1))
            sleep_rem = torch.where(t_done, slp_s[k], sleep_rem)
            attached = torch.where(t_done, -1, attached)
            occ = occ & ~q_done
            tsa = t_done.sum(1, dtype=f32)

            busy = cyc = vacs = nvs = torch.zeros((n_rows,), dtype=f32, device=dev)
            woken_any = woken.any(0).tolist()
            for i in range(n_m):
                if not woken_any[i]:
                    continue
                w = woken[:, i]
                free_q = qmask & ~occ
                claimable = free_q & (backlog >= 1.0)
                qi = torch.argmax(torch.where(claimable, backlog, -1.0), dim=1)
                any_c, any_f = claimable.any(1), free_q.any(1)
                do_attach = w & any_c
                empty = w & ~any_c & any_f
                eqi = torch.argmax(free_q.to(torch.int8), dim=1)
                blocked = w & ~any_f
                claim_hot = do_attach[:, None] & (qidx == qi[:, None])
                claim_any = claim_hot | (empty[:, None] & (qidx == eqi[:, None]))
                vacs = vacs + _sum(vac * claim_any)
                nvs = nvs + torch.where(do_attach, backlog.gather(1, qi[:, None])[:, 0], 0.0)
                vac = torch.where(claim_any, 0.0, vac)
                cyc = cyc + (do_attach | empty).to(f32)
                busy = busy + blocked.to(f32)
                tsa = tsa + empty.to(f32)
                attached[:, i] = torch.where(do_attach, qi, attached[:, i])
                occ = occ | claim_hot
                sleep_rem[:, i] = sleep_rem[:, i] + torch.where(
                    empty, slp_s[k][:, i], torch.where(blocked, slp_l[k][:, i], 0.0))

            awake = n_wake * c["wake_cost"] + served * c["inv_mu"]
            energy = c["active_power"] * awake + tsa * e_arm_s + busy * e_arm_l
            vals = torch.stack([offered, dropped, served, n_wake, busy, cyc, awake, lat_area,
                                vacs, nvs, tsa, energy], dim=1)
            acc = acc + torch.where(live_r[:, None], vals, 0.0)

            # 5. topology: admissions pay the rack's cost, a far host's also
            # the link's wait at the step's far-rack rate
            adm_h = _queue_sum(adm).view(n_pts, n_h)
            if fp.topo_on:
                delay = rack[None, :]
                if fp.link_on:
                    far_rate = host_sum(torch.where(far, adm_h, 0.0)) / dt
                    gap = torch.clamp(fc["link_rate"] - far_rate, min=fc["link_floor"])
                    delay = delay + torch.where(far, 1.0 / gap[:, None], 0.0)
                topo_acc = topo_acc + torch.where(live[:, None], adm_h * delay, 0.0)
            # hedging: the gated share of each host's admissions, split over
            # its queues, goes to b1, the least-loaded host after the step
            # (b1's own to b2), up to the receiver's room
            if hedged:
                btot = _queue_sum(backlog).view(n_pts, n_h)
                xg = (btot * c["inv_mu"] - hedge_d[:, None]) / hedge_den
                dup = adm_h * (1.0 / (1.0 + _exp(-xg))) * hedge_on
                dup_acc = dup_acc + torch.where(live[:, None], dup, 0.0)
                dup_q = dup * q_share_pt
                b1 = torch.argmin(btot, dim=1)
                back = backlog.view(n_pts, n_h, n_q)
                if n_h == 1:        # a lone host's duplicates come back to it
                    inject = [(b1, dup_q[:, 0])]
                else:
                    is_b1 = h_idx[None, :] == b1[:, None]
                    b2 = torch.argmin(torch.where(is_b1, _INF, btot), dim=1)
                    inject = [(b1, host_sum(torch.where(is_b1, 0.0, dup_q))),
                              (b2, dup_q.gather(1, b1[:, None])[:, 0])]
                for dest, total in inject:
                    b = back[pts, dest]
                    room_i = (c["cap"] - b).clamp(min=0.0)
                    back[pts, dest] = torch.where(q_live, b + torch.minimum(total[:, None],
                                                                           room_i), b)
                backlog = back.view(n_rows, n_q)

            # a finished point holds its carry (the reference gates every
            # step after the run's end)
            rem = torch.where(live, rem - dt, rem)
            n_steps = n_steps + live.to(f32)
            forced_steps = forced_steps + forced.to(f32)
            if not bool(live.all()):
                nxt = (sleep_rem, attached, backlog, vac, arr_res, stall_end, next_stall)
                (sleep_rem, attached, backlog, vac, arr_res, stall_end, next_stall) = (
                    torch.where(live_r.view(-1, *[1] * (new.dim() - 1)), new, old)
                    for new, old in zip(nxt, prev, strict=True))
                if balanced:
                    snap, next_ref, share = (
                        torch.where(live.view(-1, *[1] * (new.dim() - 1)), new, old)
                        for new, old in zip((snap, next_ref, share), prev_lb, strict=True))
        if done:
            break

    out = {k: v.view(n_pts, n_h) for k, v in zip(STAT_NAMES, acc.unbind(1))}
    out["topo_area"], out["hedge_dup"] = topo_acc, dup_acc
    out["n_steps"], out["forced_steps"] = n_steps, forced_steps
    out["sim_time"] = duration - rem
    return out


def _check(cols: dict, sched_edges, sched_scales, params: AdaptiveParams,
           fleet: FleetParams, bounds: tuple[int, int] | None = None) -> None:
    _check_fleet(cols, sched_edges, sched_scales, params, fleet, bounds)
    if params.max_steps < 1 or params.duration_us <= 0.0:
        raise ValueError("the sweep needs max_steps >= 1 and duration_us > 0")


def fleet_adaptive_sweep(t_s, t_l, m, nq, lam, seed_lo, seed_hi, hedge_d, sched_edges=None,
                         sched_scales=None, *, params: AdaptiveParams,
                         fleet: FleetParams,
                         bounds: tuple[int, int] | None = None) -> dict[str, torch.Tensor]:
    """The fleet sweep by event jumps over P points of ``fleet.n_hosts``
    hosts: ``t_s``, ``t_l``, ``lam`` (the point's fleet rate), ``hedge_d``
    float32 (P,), ``m``, ``nq``, ``seed_lo``, ``seed_hi`` int32 (P,) (the
    seed halves as int32 bit patterns), optional float32 (P, n_seg)
    schedule rows -> the dict of ``reference_fleet_adaptive_sweep``.

    CUDA tensors go through the kernel, one launch; CPU tensors through
    ``reference_fleet_adaptive_sweep``.  ``bounds`` (m_max, q_max): the
    maxima of a batch the caller has checked that holds these points (a
    shard of it); the launch then reads nothing back from the device and
    takes that batch's build."""
    cols = {"t_s": t_s, "t_l": t_l, "m": m, "nq": nq, "lam": lam, "seed_lo": seed_lo,
            "seed_hi": seed_hi, "hedge_d": hedge_d}
    _check(cols, sched_edges, sched_scales, params, fleet, bounds)
    if t_s.device.type == "cpu":
        return reference_fleet_adaptive_sweep(t_s, t_l, m, nq, lam, seed_lo, seed_hi, hedge_d,
                                              sched_edges, sched_scales, params, fleet)
    if t_s.device.type != "cuda":
        raise ValueError(f"fleet_adaptive_sweep runs on CUDA or CPU tensors, got {t_s.device}")
    cols = {k: v.contiguous() for k, v in cols.items()}
    if sched_edges is not None:
        sched_edges, sched_scales = sched_edges.contiguous(), sched_scales.contiguous()
    n = t_s.shape[0]
    stats = torch.empty((len(STAT_NAMES), n, fleet.n_hosts), dtype=torch.float32,
                        device=t_s.device)
    ends = torch.empty((len(POINT_NAMES), n), dtype=torch.float32, device=t_s.device)
    m_max, q_max = bounds or (int(cols["m"].max()), int(cols["nq"].max()))
    build = launch_fleet_adaptive_sweep(cols, sched_edges, sched_scales, params, fleet, stats,
                                        ends, m_max=m_max, q_max=q_max)
    fleet_adaptive_sweep.launches += 1
    fleet_adaptive_sweep.launches_by_build[build] = (
        fleet_adaptive_sweep.launches_by_build.get(build, 0) + 1)
    out = dict(zip(STAT_NAMES, stats.unbind(0)))
    out.update(zip(POINT_NAMES, ends.unbind(0)))
    return out


fleet_adaptive_sweep.launches = 0
fleet_adaptive_sweep.launches_by_build = {}  # (M_MAX, Q_MAX, route) -> launches
