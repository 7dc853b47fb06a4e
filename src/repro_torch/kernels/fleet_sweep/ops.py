"""Public fleet sweep wrapper and its plain PyTorch version.

``fleet_sweep`` simulates every point of a fleet sweep grid over fixed time
slots: ``n_hosts`` Metronome hosts a point behind one load balancer, the
body of the reference's ``_build_fleet_sweep.one_fleet``
(``src/repro/runtime/fleet.py:234``, a ``lax.scan`` over slots under a host
``vmap`` inside a point ``vmap``).  For CUDA tensors it launches the
hand-written kernel (``csrc/fleet_sweep.cu``: up to 256 hosts one block a
point, producer warps make every host's draws into a ring in shared memory
and a consumer lane a host runs the state machine, the cross-host stages
as reductions over the consumer warps; up to 2,048 hosts a cluster of 8
such blocks a point, 32 host lanes a block and one consumer thread a host,
the reductions exchanged through distributed shared memory; beyond,
several hosts a thread through a global scratch) and counts the call in
``fleet_sweep.launches`` and, by the (M_MAX, Q_MAX, route) build it
launched, in ``fleet_sweep.launches_by_build``; for CPU tensors it runs
``reference_fleet_sweep``.  It never falls back from the kernel to the plain
version.

Each slot, for every point, in float32: the load balancer splits the
point's rate over its hosts (``uniform`` float32(1/H) shares, ``weighted``
static shares, ``least-loaded`` a softmax of ``-stale / softness`` over a
backlog snapshot refreshed every ``stale_every_slots``); every host runs the
single-host slot body of the fixed-slot sweep (``slot_sweep``) with its
share; the topology charges each host's admissions its rack cost and, on a
far host, the bottleneck link's wait ``1 / max(link - far_rate, (1 - 0.98)
link)`` into ``topo_area``; hedging (a point's deadline D > 0) duplicates
``adm * sigmoid((backlog / mu - D) / (D / 4 + 1e-6))`` of each host onto
the least-loaded other host (``b1``, whose own go to the second least
loaded, ``b2``), up to the receiver's room, counted in ``hedge_dup``.

Host ``h`` of a point seeded ``s`` draws the Philox stream of a single-host
point seeded ``s + h`` (key ``(seed_lo + h) mod 2**32, seed_hi``), and its
slot body and sums are ``slot_sweep``'s: with uniform shares and topology
and hedging off, host ``h`` is the fixed-slot sweep of that seed at the
host's rate, bit for bit.

**Reduction order.**  Every sum over a point's hosts (the softmax's
denominator, the far rack's admissions, the duplicates that land on ``b1``)
runs over ``W = min(256, next power of two >= n_hosts)`` lanes, lane ``j``
holding hosts ``j, j + W, j + 2W, ...`` summed in that order; then, in
groups of ``L = min(W, 32)`` lanes (a warp), a halving tree (lane ``j``
adds lane ``j + L/2``, ``j + L/4``, ...), and the same tree over the
``W / L`` groups' sums.  The kernel's block reductions take that order; the
plain version follows it step by step (``host_sum``), so the two agree bit
for bit.  Maxima and first-index argmins take no order.  The reference's
divisions by a compile-time constant (``/ softness``, ``/ dt``, ``/ mu`` in
the hedge gate) are products with the float32 reciprocal, as XLA compiles
them.  As in the reference, each host's duplicates are split over its
queues (the product with ``1 / n_queues``) before they are summed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..slot_sweep import philox
from ..slot_sweep.ops import (
    STAT_NAMES as HOST_STAT_NAMES,
    SweepParams,
    _f32,
    _slot_inputs,
    _sum,
    check_columns,
    energy_arm_cost,
)
from .kernel import launch_fleet_sweep

__all__ = ["STAT_NAMES", "MAX_BLOCK_LANES", "FleetParams", "host_lanes", "host_sum",
           "reference_fleet_sweep", "fleet_sweep"]

# the per-(point, host) sums, in the order of the reference's _FleetSlotStats
STAT_NAMES = (*HOST_STAT_NAMES, "topo_area", "hedge_dup")
MAX_BLOCK_LANES = 256      # lanes of a point's host reductions (kMaxLanes)
_LINK_UTIL_CLAMP = 0.98    # simcore's: the link's wait is clamped at this utilization
_CHUNK_ELEMS = 1 << 20     # host-slots of draws the plain version makes at once


def _recip(x: float) -> float:
    """The float32 reciprocal XLA substitutes for a division by ``x``."""
    return float(np.float32(1.0) / np.float32(x))


def host_lanes(n_hosts: int) -> int:
    """Lanes of a point's host reductions: the least power of two >=
    ``n_hosts``, at most ``MAX_BLOCK_LANES``."""
    w = 1
    while w < min(n_hosts, MAX_BLOCK_LANES):
        w *= 2
    return w


@dataclass(frozen=True)
class FleetParams:
    """The fleet-wide constants of one fleet sweep (the reference's static
    ``_build_fleet_sweep`` arguments beside those of ``SweepParams``).
    ``shares`` are the static LB shares (``uniform``: float32(1/H) each;
    ``weighted``: the normalised weights), one a host, unused by
    ``least-loaded``; ``lb_code`` 0 uniform, 1 weighted, 2 least-loaded
    (the reference's ``_LB_CODE``)."""

    n_hosts: int
    lb_code: int = 0
    shares: tuple = ()
    lb_softness_pkts: float = 4.0
    stale_every_slots: int = 1
    far_count: int = 0
    near_cost_us: float = 0.0
    far_cost_us: float = 0.0
    link_rate_mpps: float = 0.0

    @property
    def topo_on(self) -> bool:
        return self.near_cost_us > 0.0 or self.far_cost_us > 0.0 or self.link_rate_mpps > 0.0

    @property
    def link_on(self) -> bool:
        return self.link_rate_mpps > 0.0 and self.far_count > 0

    def constants(self, params: SweepParams) -> dict[str, float]:
        """The fleet's float32 constants, each rounded once from its double
        value as the reference's weakly typed Python floats are."""
        return {"inv_soft": _recip(self.lb_softness_pkts),
                "near_cost": _f32(self.near_cost_us), "far_cost": _f32(self.far_cost_us),
                "link_rate": _f32(self.link_rate_mpps),
                "link_floor": _f32((1.0 - _LINK_UTIL_CLAMP) * self.link_rate_mpps),
                "inv_dt": _recip(params.slot_us), "inv_mu": _recip(params.service_rate_mpps),
                "hedge_eps": _f32(1e-6)}


def host_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a point's hosts) in the kernel's order: ``W``
    lanes, lane ``j`` summing hosts ``j, j + W, ...`` in turn, then a halving
    tree within each group of ``min(W, 32)`` lanes, then one over the
    groups (padding lanes hold exact zeros)."""
    n = x.shape[-1]
    w = host_lanes(n)
    per_lane = -(-n // w)
    if per_lane * w != n:
        x = torch.cat([x, x.new_zeros(*x.shape[:-1], per_lane * w - n)], -1)
    x = x.unflatten(-1, (per_lane, w))
    s = x[..., 0, :]
    for r in range(1, per_lane):
        s = s + x[..., r, :]
    lanes = min(w, 32)
    s = s.unflatten(-1, (w // lanes, lanes))
    while lanes > 1:
        lanes //= 2
        s = s[..., :lanes] + s[..., lanes:2 * lanes]
    s = s[..., 0]
    groups = s.shape[-1]
    while groups > 1:
        groups //= 2
        s = s[..., :groups] + s[..., groups:2 * groups]
    return s[..., 0]


def host_rows(seed_lo: torch.Tensor, seed_hi: torch.Tensor, n_hosts: int):
    """The Philox keys of a batch's hosts, point-major: host ``h`` of a
    point keys as ``((seed_lo + h) mod 2**32, seed_hi)`` (the reference's
    per-host key, which ignores the carry out of the low word)."""
    h = torch.arange(n_hosts, dtype=torch.int64, device=seed_lo.device)
    lo = ((seed_lo.to(torch.int64) & 0xFFFFFFFF)[:, None] + h[None, :]) & 0xFFFFFFFF
    return lo.flatten(), seed_hi.to(torch.int64).repeat_interleave(n_hosts)


def reference_fleet_sweep(t_s, t_l, m, nq, lam, seed_lo, seed_hi, hedge_d, sched_edges,
                          sched_scales, params: SweepParams, fleet: FleetParams,
                          draws=None) -> dict[str, torch.Tensor]:
    """Plain version: the reference's per-slot fleet update, vectorised over
    the (point, host) rows, with the slots in a Python loop.  Every value is
    float32; sums over queues run left to right and sums over hosts in the
    kernel's order (``host_sum``).

    Per point (P,): the columns of ``slot_sweep`` (``lam`` the point's rate,
    which the balancer splits) and ``hedge_d`` float32 (<= 0: no hedging);
    ``sched_edges`` and ``sched_scales`` float32 (P, n_seg) or ``None``.
    ``draws`` (default: the Philox contract at each host's key) supplies the
    noise of the P * H rows, point-major; see ``philox.SlotDraws``.  Returns
    each of ``STAT_NAMES`` as a float32 tensor (P, H).

    As in ``reference_slot_sweep``, only the state machine runs slot by
    slot (the state-free draws and re-sleep lengths are made a chunk of
    slots at a time), and work that a slot cannot need is skipped, which
    changes no value."""
    p, fp = params, fleet
    dev, f32 = t_s.device, torch.float32
    n_pts, n_h = t_s.shape[0], fp.n_hosts
    n_rows = n_pts * n_h
    n_m, n_q = int(m.max()), int(nq.max())

    def rows(x):                 # a point's value on each of its hosts' rows
        return None if x is None else x.repeat_interleave(n_h, 0)

    if draws is None:
        lo, hi = host_rows(seed_lo, seed_hi, n_h)
        draws = philox.SlotDraws(lo, hi, m=n_m, q=n_q, **p.flags)
    dt = _f32(p.slot_us)
    mu_dt = _f32(p.service_rate_mpps * p.slot_us)
    slope1 = _f32(1.0 + p.slope)
    cap = _f32(p.queue_capacity)
    c = fp.constants(p)
    # a tensor, not a Python number: PyTorch divides a CUDA tensor by a
    # Python number as a product with its reciprocal, the kernel divides
    mu = torch.tensor(p.service_rate_mpps, dtype=f32, device=dev)

    m_r, nq_r, t_s_r, t_l_r = rows(m), rows(nq), rows(t_s), rows(t_l)
    tmask = torch.arange(n_m, device=dev)[None, :] < m_r[:, None]
    qidx = torch.arange(n_q, device=dev)
    qmask = qidx[None, :] < nq_r[:, None]
    nq_f = nq_r.to(f32)
    e_arm_s = energy_arm_cost(t_s_r, p.sleep_states)
    e_arm_l = energy_arm_cost(t_l_r, p.sleep_states)
    ts1, tl1 = (t_s_r * slope1)[:, None], (t_l_r * slope1)[:, None]
    edges_r, scales_r = rows(sched_edges), rows(sched_scales)

    def queue_rates(lam_h):      # (P, H) -> (P * H, q): the reference's lam_q
        return torch.where(qmask, (lam_h.flatten() / nq_f)[:, None], 0.0)

    balanced = fp.lb_code == 2
    if not balanced:
        shares = torch.tensor(fp.shares, dtype=f32, device=dev)
        lam_q = queue_rates(lam[:, None] * shares[None, :])
    else:
        lam_q = torch.zeros((n_rows, n_q), dtype=f32, device=dev)
        stale = torch.zeros((n_pts, n_h), dtype=f32, device=dev)
    # the hedge stage: which points hedge, a queue's share of a duplicate
    # (the reference's qmask / nq) and which queues take one, the hosts'
    # far-rack mask
    hedged = bool((hedge_d > 0.0).any())
    hedge_on = (hedge_d > 0.0).to(f32)[:, None]
    hedge_den = 0.25 * hedge_d[:, None] + c["hedge_eps"]
    q_share = 1.0 / nq.to(f32)[:, None]
    q_live = qidx[None, :] < nq[:, None]
    far = torch.arange(n_h, device=dev) < fp.far_count
    rack = torch.where(far, c["far_cost"], c["near_cost"])
    h_idx = torch.arange(n_h, device=dev)
    pts = torch.arange(n_pts, device=dev)
    cross = fp.topo_on or hedged

    sleep_rem = torch.where(tmask, (draws.initial() * t_s_r[:, None]).clamp(min=dt),
                            float("inf"))
    attached = torch.full((n_rows, n_m), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros((n_rows, n_q), dtype=torch.bool, device=dev)
    backlog = torch.zeros((n_rows, n_q), dtype=f32, device=dev)
    vac_timer = torch.zeros_like(backlog)
    arr_res = torch.zeros_like(backlog)
    stall_end = torch.full((n_rows,), -1.0, dtype=f32, device=dev)
    acc = torch.zeros((n_rows, len(HOST_STAT_NAMES)), dtype=f32, device=dev)
    topo_acc = torch.zeros((n_pts, n_h), dtype=f32, device=dev)
    dup_acc = torch.zeros((n_pts, n_h), dtype=f32, device=dev)

    n_live = p.live_slots()
    nows_all = np.arange(n_live, dtype=np.float32) * np.float32(dt)
    release_at = _f32(1e-6)
    sleeping = tmask & (attached < 0)
    tick = torch.where(qmask & ~occ, dt, 0.0)
    any_occ = False
    chunk = max(16, min(1024, _CHUNK_ELEMS // max(n_rows, 1)))
    for t0 in range(0, n_live, chunk):
        t1 = min(t0 + chunk, n_live)
        nt = t1 - t0
        d = draws.chunk(t0, t1)
        x = _slot_inputs(d, nows_all[t0:t1], lam_q, edges_r, scales_r, ts1, tl1,
                         stall_end, n_m, p)
        mu_a, noise = x["mu_a"].unbind(0), x["noise"].unbind(0)
        slp_s, slp_l = x["slp_s"].unbind(0), x["slp_l"].unbind(0)
        if balanced:
            z_q = d["z_q"].unbind(0)
            scale = x["scale"].unbind(0) if "scale" in x else None
        if "stall_end" in x:
            stall_end = x["stall_end"][-1]
            stall_open, push_to = x["stall_open"].unbind(0), x["push"].unbind(0)
        arr = torch.empty((nt, n_rows, n_q), dtype=f32, device=dev)
        adm_r = torch.empty_like(arr)
        serve_r = torch.zeros_like(arr)
        back_r = torch.empty_like(arr)
        woke_r = torch.zeros((nt, n_rows), dtype=f32, device=dev)
        claim_r = torch.zeros((nt, 5, n_rows), dtype=f32, device=dev)
        for k in range(nt):
            t = t0 + k
            # 0. the load balancer: least-loaded refreshes its snapshot of
            # the hosts' backlogs (before this slot's step) and splits by a
            # softmax of -stale / softness, exp(x - max x) / sum
            if balanced:
                if t % fp.stale_every_slots == 0:
                    stale = _sum(backlog).view(n_pts, n_h)
                xs = -stale * c["inv_soft"]
                e = torch.exp(xs - xs.max(dim=1, keepdim=True).values)
                lam_q = queue_rates(lam[:, None] * (e / host_sum(e)[:, None]))
                mu_k = lam_q * scale[k][:, None] * dt if scale is not None else lam_q * dt
                noise_k = torch.sqrt(mu_k) * z_q[k]
            else:
                mu_k, noise_k = mu_a[k], noise[k]

            # 1. the host step: slot_sweep's body on every (point, host) row
            raw = arr_res + mu_k + noise_k
            a = torch.clamp(raw, min=0.0, out=arr[k])
            arr_res = raw.clamp(max=0.0)
            adm = torch.minimum(a, (cap - backlog).clamp(min=0.0), out=adm_r[k])
            backlog = backlog + adm

            sleep_rem = torch.where(sleeping, sleep_rem - dt, sleep_rem)
            woken = sleeping & (sleep_rem <= 0.0)
            if "stall_end" in x:
                push = woken & stall_open[k][:, None]
                woken = woken & ~push
                sleep_rem = torch.where(push, push_to[k], sleep_rem)

            woken_any = woken.any(0).tolist()
            if any(woken_any):
                torch.sum(woken, 1, dtype=f32, out=woke_r[k])
                busy, cyc, vacs, nvs, tsa = claim_r[k].unbind(0)
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
                    vacs = vacs + _sum(vac_timer * claim_any)
                    nvs = nvs + torch.where(do_attach, backlog.gather(1, qi[:, None])[:, 0],
                                            0.0)
                    vac_timer = torch.where(claim_any, 0.0, vac_timer)
                    cyc = cyc + (do_attach | empty).to(f32)
                    busy = busy + blocked.to(f32)
                    tsa = tsa + empty.to(f32)
                    attached[:, i] = torch.where(do_attach, qi, attached[:, i])
                    occ = occ | claim_hot
                    sleep_rem[:, i] = sleep_rem[:, i] + torch.where(
                        empty, slp_s[k][:, i], torch.where(blocked, slp_l[k][:, i], 0.0))
                claim_r[k] = torch.stack([busy, cyc, vacs, nvs, tsa])
                sleeping = tmask & (attached < 0)
                tick = torch.where(qmask & ~occ, dt, 0.0)
                any_occ = bool(occ.any())

            if any_occ:
                serve = torch.mul(backlog.clamp(max=mu_dt), occ, out=serve_r[k])
                backlog = backlog - serve
                q_done = occ & (backlog <= release_at)
                if bool(q_done.any()):
                    t_done = (attached >= 0) & q_done.gather(1, attached.clamp(0, n_q - 1))
                    claim_r[k, 4] = claim_r[k, 4] + t_done.sum(1).to(f32)
                    sleep_rem = torch.where(t_done, slp_s[k], sleep_rem)
                    attached = torch.where(t_done, -1, attached)
                    occ = occ & ~q_done
                    sleeping = tmask & (attached < 0)
                    tick = torch.where(qmask & ~occ, dt, 0.0)
                    any_occ = bool(occ.any())

            vac_timer = vac_timer + tick
            back_r[k] = backlog
            if not cross:
                continue

            # 2. topology: admissions pay the rack's cost, a far host's also
            # the bottleneck link's wait at this slot's far-rack rate
            adm_h = _sum(adm).view(n_pts, n_h)
            if fp.topo_on:
                delay = rack[None, :]
                if fp.link_on:
                    far_rate = host_sum(torch.where(far, adm_h, 0.0)) * c["inv_dt"]
                    gap = torch.clamp(c["link_rate"] - far_rate, min=c["link_floor"])
                    delay = delay + torch.where(far, 1.0 / gap[:, None], 0.0)
                topo_acc = topo_acc + adm_h * delay
            if not hedged:
                continue

            # 3. hedging: the gated share of each host's admissions, split
            # over its queues, goes to b1, the least-loaded host after the
            # step (b1's own to b2), up to the receiver's room
            btot = _sum(backlog).view(n_pts, n_h)
            xg = (btot * c["inv_mu"] - hedge_d[:, None]) / hedge_den
            dup = adm_h * (1.0 / (1.0 + torch.exp(-xg))) * hedge_on
            dup_acc = dup_acc + dup
            dup_q = dup * q_share
            b1 = torch.argmin(btot, dim=1)
            back = backlog.view(n_pts, n_h, n_q)
            if n_h == 1:        # a lone host's duplicates come back to it
                inject = [(b1, dup_q[:, 0])]
            else:
                is_b1 = h_idx[None, :] == b1[:, None]
                b2 = torch.argmin(torch.where(is_b1, float("inf"), btot), dim=1)
                inject = [(b1, host_sum(torch.where(is_b1, 0.0, dup_q))),
                          (b2, dup_q.gather(1, b1[:, None])[:, 0])]
            for dest, total in inject:
                b = back[pts, dest]
                room = (cap - b).clamp(min=0.0)
                back[pts, dest] = torch.where(q_live, b + torch.minimum(total[:, None], room), b)
            backlog = back.view(n_rows, n_q)

        offered, dropped = _sum(arr), _sum(arr - adm_r)
        served = _sum(serve_r)
        lat_area = _sum(back_r) * dt
        busy, cyc, vacs, nvs, tsa = claim_r.unbind(1)
        awake = woke_r * _f32(p.wake_cost_us) + served / mu
        energy = _f32(p.active_power_w) * awake + tsa * e_arm_s + busy * e_arm_l
        vals = torch.stack([offered, dropped, served, woke_r, busy, cyc, awake, lat_area,
                            vacs, nvs, tsa, energy], dim=2)
        for row in vals.unbind(0):
            acc = acc + row

    out = {k: v.view(n_pts, n_h) for k, v in zip(HOST_STAT_NAMES, acc.unbind(1))}
    out["topo_area"], out["hedge_dup"] = topo_acc, dup_acc
    return out


def _check(cols: dict, sched_edges, sched_scales, params: SweepParams,
           fleet: FleetParams, bounds: tuple[int, int] | None = None) -> None:
    check_columns({k: v for k, v in cols.items() if k != "hedge_d"}, sched_edges,
                  sched_scales, params.sleep_states, bounds)
    hedge = cols["hedge_d"]
    if hedge.dim() != 1 or hedge.shape != cols["t_s"].shape or hedge.dtype != torch.float32:
        raise ValueError(f"hedge_d: want float32 shape {tuple(cols['t_s'].shape)}, got "
                         f"{hedge.dtype} {tuple(hedge.shape)}")
    if hedge.device != cols["t_s"].device:
        raise ValueError(f"inputs on several devices: {hedge.device}, {cols['t_s'].device}")
    if params.n_windows:
        raise ValueError("the fleet sweep keeps no windows (n_windows must be 0)")
    if fleet.n_hosts < 1 or fleet.lb_code not in (0, 1, 2):
        raise ValueError(f"want n_hosts >= 1 and an LB code in (0, 1, 2), got "
                         f"{fleet.n_hosts} and {fleet.lb_code}")
    if fleet.lb_code != 2 and len(fleet.shares) != fleet.n_hosts:
        raise ValueError(f"want {fleet.n_hosts} static shares, got {len(fleet.shares)}")
    if fleet.stale_every_slots < 1 or not 0 <= fleet.far_count <= fleet.n_hosts:
        raise ValueError(f"want stale_every_slots >= 1 and 0 <= far_count <= n_hosts, got "
                         f"{fleet.stale_every_slots} and {fleet.far_count}")


def fleet_sweep(t_s, t_l, m, nq, lam, seed_lo, seed_hi, hedge_d, sched_edges=None,
                sched_scales=None, *, params: SweepParams,
                fleet: FleetParams,
                bounds: tuple[int, int] | None = None) -> dict[str, torch.Tensor]:
    """The fixed-slot fleet sweep over P points of ``fleet.n_hosts`` hosts:
    ``t_s``, ``t_l``, ``lam`` (the point's fleet rate), ``hedge_d`` float32
    (P,), ``m``, ``nq``, ``seed_lo``, ``seed_hi`` int32 (P,) (the seed halves
    as int32 bit patterns), optional float32 (P, n_seg) schedule rows -> the
    dict of ``reference_fleet_sweep``.

    CUDA tensors go through the kernel, one launch; CPU tensors through
    ``reference_fleet_sweep``.  ``bounds`` (m_max, q_max): the maxima of a
    batch the caller has checked that holds these points (a shard of it);
    the launch then reads nothing back from the device and takes that
    batch's build."""
    cols = {"t_s": t_s, "t_l": t_l, "m": m, "nq": nq, "lam": lam, "seed_lo": seed_lo,
            "seed_hi": seed_hi, "hedge_d": hedge_d}
    _check(cols, sched_edges, sched_scales, params, fleet, bounds)
    if t_s.device.type == "cpu":
        return reference_fleet_sweep(t_s, t_l, m, nq, lam, seed_lo, seed_hi, hedge_d,
                                     sched_edges, sched_scales, params, fleet)
    if t_s.device.type != "cuda":
        raise ValueError(f"fleet_sweep runs on CUDA or CPU tensors, got {t_s.device}")
    cols = {k: v.contiguous() for k, v in cols.items()}
    if sched_edges is not None:
        sched_edges, sched_scales = sched_edges.contiguous(), sched_scales.contiguous()
    n = t_s.shape[0]
    stats = torch.empty((len(STAT_NAMES), n, fleet.n_hosts), dtype=torch.float32,
                        device=t_s.device)
    m_max, q_max = bounds or (int(cols["m"].max()), int(cols["nq"].max()))
    build = launch_fleet_sweep(cols, sched_edges, sched_scales, params, fleet, stats,
                               m_max=m_max, q_max=q_max)
    fleet_sweep.launches += 1
    fleet_sweep.launches_by_build[build] = fleet_sweep.launches_by_build.get(build, 0) + 1
    return dict(zip(STAT_NAMES, stats.unbind(0)))


fleet_sweep.launches = 0
fleet_sweep.launches_by_build = {}  # (M_MAX, Q_MAX, route) -> launches
