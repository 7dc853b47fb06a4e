"""Public fixed-slot sweep wrapper and its plain PyTorch version.

``slot_sweep`` simulates every point of a Metronome sweep grid over fixed
time slots: the body of the reference's ``_build_sweep.one_point``
(``src/repro/runtime/batched.py:543``, a ``lax.scan`` over slots under
``jax.jit(jax.vmap(...))``).  For CUDA tensors it launches the hand-written
kernel (``csrc/slot_sweep.cu``: producer warps make the draws, a consumer
warp runs the state machine, 32 points a block) and counts the call in
``slot_sweep.launches`` and, by the (M_MAX, Q_MAX) build it launched, in
``slot_sweep.launches_by_build``; for CPU tensors it runs
``reference_slot_sweep``.  It never falls back from the kernel to the plain
version.  Both draw their noise from the Philox contract of ``philox``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import philox
from .kernel import launch_slot_sweep

__all__ = ["STAT_NAMES", "MAX_THREADS", "MAX_QUEUES", "SweepParams", "energy_arm_cost",
           "reference_slot_sweep", "slot_sweep"]

# the per-point sums, in the order of the reference's _SlotStats
STAT_NAMES = ("offered", "dropped", "serviced", "wakeups", "busy_tries", "cycles",
              "awake_us", "lat_area", "vac_sum", "nv_sum", "ts_arms", "energy_uj")
MAX_THREADS = MAX_QUEUES = philox.MAX_LANES
MAX_SLEEP_STATES = 4
_CHUNK_ELEMS = 1 << 20   # point-slots of draws the plain version makes at once


def _f32(x: float) -> float:
    """``x`` rounded to float32: the value the reference's weakly typed
    Python constant takes inside its float32 arithmetic."""
    return float(np.float32(x))


@dataclass(frozen=True)
class SweepParams:
    """The batch-wide constants of one sweep (the reference's static
    ``_build_sweep`` arguments).  ``n_slots`` bounds the slot loop, which
    also stops at the first slot whose start ``float32(t) * slot_us`` is not
    below ``duration_us``; ``n_windows > 0`` accumulates per-window sums
    into slot ``t``'s window ``min(int(now / window_us), n_win_pad - 1)``,
    of which the first ``n_windows`` are returned."""

    n_slots: int
    slot_us: float
    duration_us: float
    service_rate_mpps: float
    queue_capacity: float
    wake_cost_us: float
    base_us: float
    slope: float
    sigma_us: float
    tail_prob: float
    tail_mean_us: float
    interference_prob: float
    interference_mean_us: float
    stall_rate_per_us: float
    stall_mean_us: float
    active_power_w: float
    sleep_states: tuple          # ((power_w, transition_uj, min_residency_us), ...)
    n_windows: int = 0
    n_win_pad: int = 0
    window_us: float = 0.0

    @property
    def stall_p(self) -> float:
        """Exact per-slot hit probability of the Poisson stall-start process."""
        if not self.stall_rate_per_us:
            return 0.0
        return 1.0 - float(np.exp(-self.stall_rate_per_us * self.slot_us))

    @property
    def flags(self) -> dict[str, bool]:
        """Which noise families the batch draws from (uniform across it)."""
        return {"sigma": self.sigma_us > 0.0, "tail": self.tail_prob > 0.0,
                "intf": self.interference_prob > 0.0, "stall": self.stall_p > 0.0}

    def live_slots(self) -> int:
        """Slots the loop runs: those with float32(t) * slot_us < duration."""
        t = np.arange(self.n_slots, dtype=np.float32)
        return int(np.count_nonzero(t * np.float32(self.slot_us)
                                    < np.float32(self.duration_us)))


def energy_arm_cost(target_us: torch.Tensor, sleep_states) -> torch.Tensor:
    """Per-arm sleep + transition energy (uJ) of a float32 sleep target:
    the deepest C-state whose minimum residency fits pays ``power_w *
    target + transition_uj`` (``simcore.EnergyModel``'s next-timer-event
    governor approximation).  ``sleep_states`` is the shallow-to-deep tuple
    of ``EnergyModel.params()``."""
    p_w = torch.full_like(target_us, _f32(sleep_states[0][0]))
    t_uj = torch.full_like(target_us, _f32(sleep_states[0][1]))
    for pw, tuj, thr_us in sleep_states[1:]:
        fits = target_us >= _f32(thr_us)
        p_w = torch.where(fits, _f32(pw), p_w)
        t_uj = torch.where(fits, _f32(tuj), t_uj)
    return p_w * target_us + t_uj


def _sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right (the kernel's order)."""
    s = x[..., 0]
    for j in range(1, x.shape[-1]):
        s = s + x[..., j]
    return s


def _slot_inputs(d: dict, nows: np.ndarray, lam_q, sched_edges, sched_scales, ts1, tl1,
                 stall_end, n_m: int, p: SweepParams) -> dict:
    """The parts of a chunk of slots that do not depend on the simulated
    state, made for all its slots at once with the reference's float32
    operations: per-slot arrival means and noise (and, with a schedule, its
    per-slot ``scale``), re-sleep lengths, the running end of the stall
    window (``max`` is exact, so a cumulative max equals the per-slot
    update) and the deferred-wake targets."""
    dev, f32 = lam_q.device, torch.float32
    dt = _f32(p.slot_us)
    now = torch.from_numpy(nows).to(dev)
    out = {}
    if sched_edges is not None:
        at = now[None, :].expand(sched_edges.shape[0], -1).contiguous()
        si = torch.searchsorted(sched_edges, at, right=True) - 1
        scale = sched_scales.gather(1, si.clamp(0, sched_edges.shape[1] - 1)).T
        mu_a = lam_q * scale[:, :, None] * dt
        out["scale"] = scale
    else:
        mu_a = (lam_q * dt).expand(len(nows), -1, -1)
    out.update(mu_a=mu_a, noise=torch.sqrt(mu_a) * d["z_q"])
    fl = p.flags
    over = torch.full(d["z_q"].shape[:2] + (n_m,), _f32(p.base_us), dtype=f32, device=dev)
    if fl["sigma"]:
        over = over + _f32(p.sigma_us) * d["z_m"].abs()
    if fl["tail"]:
        over = over + (d["tail_u"] < _f32(p.tail_prob)).to(f32) * _f32(p.tail_mean_us) \
            * d["tail_e"]
    if fl["intf"]:
        over = over + (d["intf_u"] < _f32(p.interference_prob)).to(f32) \
            * _f32(p.interference_mean_us) * d["intf_e"]
    out["slp_s"], out["slp_l"] = ts1 + over, tl1 + over
    if fl["stall"]:
        hit = d["stall_u"] < _f32(p.stall_p)
        end = now[:, None] + _f32(p.stall_mean_us) * d["stall_e"]
        opened = torch.where(hit, end, float("-inf"))
        ends = torch.cummax(torch.cat([stall_end[None], opened]), 0).values[1:]
        out["stall_end"] = ends
        out["stall_open"] = now[:, None] < ends
        out["push"] = (ends - now[:, None])[:, :, None] + d["stall_jitter"]
    return out


def reference_slot_sweep(t_s, t_l, m, nq, lam, seed_lo, seed_hi, sched_edges, sched_scales,
                         params: SweepParams, draws=None) -> dict[str, torch.Tensor]:
    """Plain version: the reference's per-slot update, vectorised over the
    points, with the slots in a Python loop.  Every value is float32 and
    every sum runs in the kernel's order.

    Per point (P,): ``t_s``, ``t_l``, ``lam`` float32; ``m``, ``nq``,
    ``seed_lo``, ``seed_hi`` integer (the seed's 32-bit words);
    ``sched_edges`` and ``sched_scales`` float32 (P, n_seg), or ``None`` for
    a stationary batch.  ``draws`` (default: the Philox contract) supplies
    the noise; see ``philox.SlotDraws``.  Returns float32 tensors: each of
    ``STAT_NAMES`` (P,), ``"win"`` (P, n_windows, 5) of [offered, served,
    lat_area, awake, energy], and ``"backlog"`` (P,), the backlog left at
    the end.

    Only the state machine (timers, owners, backlogs, vacations, arrival
    residuals) runs slot by slot; what does not depend on it is made a
    chunk of slots at a time (``_slot_inputs``).  Work that a slot cannot
    need (claims with no thread woken, drains with no queue owned) is
    skipped, which changes no value."""
    p = params
    dev, f32 = t_s.device, torch.float32
    n_pts = t_s.shape[0]
    n_m, n_q = int(m.max()), int(nq.max())
    if draws is None:
        draws = philox.SlotDraws(seed_lo, seed_hi, m=n_m, q=n_q, **p.flags)
    dt = _f32(p.slot_us)
    mu_dt = _f32(p.service_rate_mpps * p.slot_us)
    slope1 = _f32(1.0 + p.slope)
    cap = _f32(p.queue_capacity)
    # a tensor, not a Python number: PyTorch divides a CUDA tensor by a
    # Python number as a product with its reciprocal, the kernel divides
    mu = torch.tensor(p.service_rate_mpps, dtype=f32, device=dev)

    tmask = torch.arange(n_m, device=dev)[None, :] < m[:, None]
    qidx = torch.arange(n_q, device=dev)
    qmask = qidx[None, :] < nq[:, None]
    lam_q = torch.where(qmask, (lam / nq.to(f32))[:, None], 0.0)
    e_arm_s = energy_arm_cost(t_s, p.sleep_states)
    e_arm_l = energy_arm_cost(t_l, p.sleep_states)
    ts1, tl1 = (t_s * slope1)[:, None], (t_l * slope1)[:, None]

    sleep_rem = torch.where(tmask, (draws.initial() * t_s[:, None]).clamp(min=dt),
                            float("inf"))
    attached = torch.full((n_pts, n_m), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros((n_pts, n_q), dtype=torch.bool, device=dev)
    backlog = torch.zeros((n_pts, n_q), dtype=f32, device=dev)
    vac_timer = torch.zeros_like(backlog)
    arr_res = torch.zeros_like(backlog)
    stall_end = torch.full((n_pts,), -1.0, dtype=f32, device=dev)
    # the twelve sums and, behind them, the open window's five
    acc = torch.zeros((n_pts, len(STAT_NAMES)), dtype=f32, device=dev)
    win = torch.zeros((n_pts, max(p.n_win_pad, 1), 5), dtype=f32, device=dev)

    n_live = p.live_slots()
    nows_all = np.arange(n_live, dtype=np.float32) * np.float32(dt)
    if p.n_windows:
        w_of = np.minimum((nows_all / np.float32(p.window_us)).astype(np.int32),
                          p.n_win_pad - 1)
    release_at = _f32(1e-6)
    # masks that change only when a thread claims or releases a queue
    sleeping = tmask & (attached < 0)
    tick = torch.where(qmask & ~occ, dt, 0.0)
    any_occ = False
    chunk = max(16, min(1024, _CHUNK_ELEMS // max(n_pts, 1)))
    for t0 in range(0, n_live, chunk):
        t1 = min(t0 + chunk, n_live)
        nt = t1 - t0
        x = _slot_inputs(draws.chunk(t0, t1), nows_all[t0:t1], lam_q, sched_edges,
                         sched_scales, ts1, tl1, stall_end, n_m, p)
        mu_a, noise = x["mu_a"].unbind(0), x["noise"].unbind(0)
        slp_s, slp_l = x["slp_s"].unbind(0), x["slp_l"].unbind(0)
        if "stall_end" in x:
            stall_end = x["stall_end"][-1]
            stall_open, push_to = x["stall_open"].unbind(0), x["push"].unbind(0)
        # per-slot records of the state machine, summed after the chunk
        arr = torch.empty((nt, n_pts, n_q), dtype=f32, device=dev)
        adm_r = torch.empty_like(arr)
        serve_r = torch.zeros_like(arr)
        back_r = torch.empty_like(arr)
        woke_r = torch.zeros((nt, n_pts), dtype=f32, device=dev)
        # busy tries, cycles, vacation and backlog sums of claims, T_S arms
        claim_r = torch.zeros((nt, 5, n_pts), dtype=f32, device=dev)
        for k in range(nt):
            # 1. arrivals: residual-carried Gaussian fluid, room/capacity clip
            raw = arr_res + mu_a[k] + noise[k]
            a = torch.clamp(raw, min=0.0, out=arr[k])
            arr_res = raw.clamp(max=0.0)
            adm = torch.minimum(a, (cap - backlog).clamp(min=0.0), out=adm_r[k])
            backlog = backlog + adm

            # 2. countdown + wake (stall windows defer expiring timers)
            sleep_rem = torch.where(sleeping, sleep_rem - dt, sleep_rem)
            woken = sleeping & (sleep_rem <= 0.0)
            if "stall_end" in x:
                push = woken & stall_open[k][:, None]
                woken = woken & ~push
                sleep_rem = torch.where(push, push_to[k], sleep_rem)

            # claims, threads in index order: the longest free backlog >= 1
            # (ties to the lowest index), else an empty win (re-sleep T_S),
            # else a busy try (re-sleep T_L)
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

            # 3. owned queues drain at mu; 4. emptied queues release (T_S)
            if any_occ:
                # min(backlog, mu dt) where owned, 0 elsewhere (backlog is finite)
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

            # 5. vacations tick on free queues; 6. the backlog for Little's law
            vac_timer = vac_timer + tick
            back_r[k] = backlog

        # the slots' sums, then their running totals in slot order
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
        if p.n_windows:
            wvals = torch.stack([offered, served, lat_area, awake, energy], dim=2)
            for k, row in enumerate(wvals.unbind(0)):
                wi = int(w_of[t0 + k])
                win[:, wi] = win[:, wi] + row

    out = dict(zip(STAT_NAMES, acc.unbind(1)))
    out["win"] = win[:, :p.n_windows]
    out["backlog"] = _sum(backlog)
    return out


def check_columns(cols: dict, sched_edges, sched_scales, sleep_states) -> None:
    """The checks both sweep wrappers make on their per-point columns,
    schedule rows and sleep states (shapes, types, bounds, one device)."""
    n = cols["t_s"].shape[0]
    for name, t in cols.items():
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name}: want shape ({n},), got {tuple(t.shape)}")
    for name in ("t_s", "t_l", "lam"):
        if cols[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {cols[name].dtype}")
    for name in ("m", "nq", "seed_lo", "seed_hi"):
        if cols[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {cols[name].dtype}")
    if n == 0:
        raise ValueError("the sweep needs at least one point")
    m_max, q_max = int(cols["m"].max()), int(cols["nq"].max())
    if int(cols["m"].min()) < 1 or int(cols["nq"].min()) < 1:
        raise ValueError("every point needs m >= 1 and n_queues >= 1")
    if m_max > MAX_THREADS or q_max > MAX_QUEUES:
        raise ValueError(
            f"the sweep kernel takes m <= {MAX_THREADS} and n_queues <= {MAX_QUEUES} a "
            f"point (every grid of the repo fits); got m up to {m_max}, n_queues up to "
            f"{q_max}")
    if not 1 <= len(sleep_states) <= MAX_SLEEP_STATES:
        raise ValueError(f"1 to {MAX_SLEEP_STATES} sleep states, got {len(sleep_states)}")
    if (sched_edges is None) != (sched_scales is None):
        raise ValueError("pass both sched_edges and sched_scales, or neither")
    if sched_edges is not None and (
            sched_edges.shape != sched_scales.shape or sched_edges.dim() != 2
            or sched_edges.shape[0] != n or sched_edges.dtype != torch.float32
            or sched_scales.dtype != torch.float32):
        raise ValueError(f"schedules: want float32 ({n}, n_seg) edges and scales, got "
                         f"{tuple(sched_edges.shape)} {sched_edges.dtype} and "
                         f"{tuple(sched_scales.shape)} {sched_scales.dtype}")
    devices = {t.device for t in cols.values()}
    if sched_edges is not None:
        devices |= {sched_edges.device, sched_scales.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")


def _check(cols: dict, sched_edges, sched_scales, params: SweepParams) -> None:
    check_columns(cols, sched_edges, sched_scales, params.sleep_states)
    if params.n_windows and not (params.window_us > 0 and params.n_win_pad >= params.n_windows):
        raise ValueError("windows need window_us > 0 and n_win_pad >= n_windows")


def slot_sweep(t_s, t_l, m, nq, lam, seed_lo, seed_hi, sched_edges=None, sched_scales=None,
               *, params: SweepParams) -> dict[str, torch.Tensor]:
    """The fixed-slot sweep over P points: ``t_s``, ``t_l``, ``lam`` float32
    (P,), ``m``, ``nq``, ``seed_lo``, ``seed_hi`` int32 (P,) (the seed
    halves as int32 bit patterns), optional float32 (P, n_seg) schedule
    rows -> the dict of ``reference_slot_sweep``.

    CUDA tensors go through the kernel, one launch; CPU tensors through
    ``reference_slot_sweep``."""
    cols = {"t_s": t_s, "t_l": t_l, "m": m, "nq": nq, "lam": lam, "seed_lo": seed_lo,
            "seed_hi": seed_hi}
    _check(cols, sched_edges, sched_scales, params)
    if t_s.device.type == "cpu":
        return reference_slot_sweep(t_s, t_l, m, nq, lam, seed_lo, seed_hi, sched_edges,
                                    sched_scales, params)
    if t_s.device.type != "cuda":
        raise ValueError(f"slot_sweep runs on CUDA or CPU tensors, got {t_s.device}")
    cols = {k: v.contiguous() for k, v in cols.items()}
    if sched_edges is not None:
        sched_edges, sched_scales = sched_edges.contiguous(), sched_scales.contiguous()
    n = t_s.shape[0]
    stats = torch.empty((len(STAT_NAMES), n), dtype=torch.float32, device=t_s.device)
    win = torch.empty((n, params.n_windows, 5), dtype=torch.float32, device=t_s.device)
    backlog = torch.empty(n, dtype=torch.float32, device=t_s.device)
    build = launch_slot_sweep(cols, sched_edges, sched_scales, params, stats, win, backlog,
                              m_max=int(cols["m"].max()), q_max=int(cols["nq"].max()))
    slot_sweep.launches += 1
    slot_sweep.launches_by_build[build] = slot_sweep.launches_by_build.get(build, 0) + 1
    out = dict(zip(STAT_NAMES, stats.unbind(0)))
    out["win"] = win
    out["backlog"] = backlog
    return out


slot_sweep.launches = 0
slot_sweep.launches_by_build = {}  # (M_MAX, Q_MAX) -> launches
