"""Public event-jump sweep wrapper and its plain PyTorch version.

``adaptive_sweep`` simulates every point of a Metronome sweep grid over
event-jump macro-slots: the body of the reference's
``_build_adaptive_sweep.one_point`` (``src/repro/runtime/batched_adaptive.py:197``,
a ``lax.scan`` over the step budget, ``:496``, under
``jax.jit(jax.vmap(...))``).  Each step advances a variable ``dt``, the
distance to the next boundary (a wake, a drain-out, a fill to capacity, a
schedule segment's end, a window edge, a stall start, the end of the run),
floored at the slot length unless a wake or a drain-out comes first, and
paced as ``remaining / steps_left`` in the last eighth of the budget.  For
CUDA tensors it launches the hand-written kernel (``csrc/adaptive_sweep.cu``:
producer warps make each step's draws into a ring in shared memory, a
consumer warp runs the jumps of 32 points) and counts the call in
``adaptive_sweep.launches`` and,
by the (M_MAX, Q_MAX) build it launched, in ``adaptive_sweep.launches_by_build``;
for CPU tensors it runs ``reference_adaptive_sweep``.  It never falls back
from the kernel to the plain version.  Both draw their noise from the Philox
contract of ``philox``.

The reference divides by a compile-time constant in three places (``/
window_us``, ``/ stall_rate``, ``/ mu``), which XLA compiles to a product with
the constant's float32 reciprocal; both versions here make that product, so
that they step on the reference's window edges.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..slot_sweep.ops import STAT_NAMES, _f32, _sum, check_columns, energy_arm_cost
from . import philox
from .kernel import launch_adaptive_sweep

__all__ = ["SUM_NAMES", "AdaptiveParams", "reference_adaptive_sweep", "adaptive_sweep"]

# the per-point sums, in the order of the reference's _AdaptiveStats
SUM_NAMES = (*STAT_NAMES, "n_steps", "forced_steps")
_CHUNK_ELEMS = 1 << 18   # point-steps of draws the plain version makes at once
_INF = float("inf")


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded on every device (PyTorch's
    vectorised float32 sqrt on the CPU is not; the kernel's ``sqrtf`` is).
    The float64 root rounded to float32 is the float32 root: 53 >= 2 * 24 +
    2 bits, so the double rounding is innocuous."""
    return torch.sqrt(x.double()).float()


def _recip(x: float) -> float:
    """The float32 reciprocal XLA substitutes for a division by ``x``."""
    return float(np.float32(1.0) / np.float32(x))


@dataclass(frozen=True)
class AdaptiveParams:
    """The batch-wide constants of one event-jump sweep (the reference's
    static ``_build_adaptive_sweep`` arguments).  ``max_steps`` is the step
    budget: its last eighth paces the remaining time evenly, so a point's
    steps depend on it.  ``run_steps`` (default: all) stops every point
    after that many steps, a prefix of the run for finding where two
    versions part.  ``n_windows > 0`` accumulates per-window sums into a
    step's window ``min(int(now * (1 / window_us)), n_windows - 1)``."""

    max_steps: int
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
    window_us: float = 0.0
    run_steps: int | None = None

    @property
    def flags(self) -> dict[str, bool]:
        """Which noise families the batch draws from (uniform across it)."""
        return {"sigma": self.sigma_us > 0.0, "tail": self.tail_prob > 0.0,
                "intf": self.interference_prob > 0.0, "stall": self.stall_rate_per_us > 0.0}

    @property
    def steps(self) -> int:
        """Steps the loop may run: the budget, or the prefix ``run_steps``."""
        return self.max_steps if self.run_steps is None else min(self.run_steps,
                                                                 self.max_steps)

    def constants(self) -> dict[str, float]:
        """The float32 constants of the step, each rounded once from its
        double value (the reference's weakly typed Python floats); the
        reference's boundary epsilons (``_RATE_EPS``, ``_WAKE_EPS_US``,
        ``_FILL_SLACK_PKTS``) and release threshold are its own."""
        inv = (lambda x: _recip(x) if x else 0.0)   # noqa: E731
        return {
            "floor": _f32(self.slot_us), "duration": _f32(self.duration_us),
            "mu": _f32(self.service_rate_mpps), "inv_mu": inv(self.service_rate_mpps),
            "cap": _f32(self.queue_capacity), "cap_fill": _f32(self.queue_capacity - 1.0),
            "wake_cost": _f32(self.wake_cost_us), "base": _f32(self.base_us),
            "sigma": _f32(self.sigma_us), "slope1": _f32(1.0 + self.slope),
            "tail_prob": _f32(self.tail_prob), "tail_mean": _f32(self.tail_mean_us),
            "intf_prob": _f32(self.interference_prob),
            "intf_mean": _f32(self.interference_mean_us),
            "inv_stall": inv(self.stall_rate_per_us), "stall_mean": _f32(self.stall_mean_us),
            "active_power": _f32(self.active_power_w), "window": _f32(self.window_us),
            "inv_window": inv(self.window_us), "steps": _f32(self.max_steps),
            "tail_steps": _f32(max(self.max_steps // 8, 2)),
            "eps_rate": _f32(1e-9), "eps_wake": _f32(1e-6), "release": _f32(1e-6)}


def _step_inputs(d: dict, ts1, tl1, c: dict, fl: dict, n_m: int) -> dict:
    """The state-free parts of a chunk of steps, made for all its steps at
    once with the reference's float32 operations: re-sleep lengths (base +
    sigma |z| + tail and interference hits), stall lengths and gaps."""
    shape = d["z_q"].shape[:2] + (n_m,)
    over = torch.full(shape, c["base"], dtype=torch.float32, device=d["z_q"].device)
    if fl["sigma"]:
        over = over + c["sigma"] * d["z_m"].abs()
    if fl["tail"]:
        over = over + (d["tail_u"] < c["tail_prob"]).to(torch.float32) * c["tail_mean"] \
            * d["tail_e"]
    if fl["intf"]:
        over = over + (d["intf_u"] < c["intf_prob"]).to(torch.float32) * c["intf_mean"] \
            * d["intf_e"]
    out = {"z_q": d["z_q"], "slp_s": ts1 + over, "slp_l": tl1 + over}
    if fl["stall"]:
        out["stall_len"] = c["stall_mean"] * d["stall_len_e"]
        out["stall_gap"] = d["stall_gap_e"] * c["inv_stall"]
        out["jitter"] = d["stall_jitter"]
    return out


def reference_adaptive_sweep(t_s, t_l, m, nq, lam, seed_lo, seed_hi, sched_edges, sched_scales,
                             params: AdaptiveParams, draws=None) -> dict[str, torch.Tensor]:
    """Plain version: the reference's per-step update, vectorised over the
    points, with the steps in a Python loop that ends when every point has
    reached the run's duration (the reference's later steps are inert).
    Every value is float32 and every sum runs in the kernel's order.

    Per point (P,): ``t_s``, ``t_l``, ``lam`` float32; ``m``, ``nq``,
    ``seed_lo``, ``seed_hi`` integer (the seed's 32-bit words);
    ``sched_edges`` and ``sched_scales`` float32 (P, n_seg), or ``None`` for
    a stationary batch.  ``draws`` (default: the Philox contract) supplies
    the noise; see ``philox.StepDraws``.  Returns float32 tensors: each of
    ``SUM_NAMES`` (P,), ``"win"`` (P, n_windows, 5) of [offered, served,
    lat_area, awake, energy], ``"backlog"`` (P,), the backlog left at the
    end, and ``"sim_time"`` (P,), the simulated time ``duration - remaining``."""
    p = params
    c = p.constants()
    fl = p.flags
    dev, f32 = t_s.device, torch.float32
    n_pts = t_s.shape[0]
    n_m, n_q = int(m.max()), int(nq.max())
    if draws is None:
        draws = philox.StepDraws(seed_lo, seed_hi, m=n_m, q=n_q, **fl)

    def const(x: float) -> torch.Tensor:
        # a tensor, not a Python number: PyTorch divides a CUDA tensor by a
        # Python number as a product with its reciprocal, the kernel divides
        return torch.tensor(x, dtype=f32, device=dev)

    mu, inf = const(c["mu"]), const(_INF)
    eps_rate, eps_wake = c["eps_rate"], c["eps_wake"]
    tmask = torch.arange(n_m, device=dev)[None, :] < m[:, None]
    qidx = torch.arange(n_q, device=dev)
    qmask = qidx[None, :] < nq[:, None]
    nq_f = nq.to(f32)
    e_arm_s = energy_arm_cost(t_s, p.sleep_states)
    e_arm_l = energy_arm_cost(t_l, p.sleep_states)
    ts1, tl1 = (t_s * c["slope1"])[:, None], (t_l * c["slope1"])[:, None]
    lam_fixed = torch.where(qmask, (lam / nq_f)[:, None], 0.0)
    if sched_edges is not None:
        n_seg = sched_edges.shape[1]
        sched_edges = sched_edges.contiguous()

    init = draws.initial()
    sleep_rem = torch.where(tmask, (init["sleep_u"] * t_s[:, None]).clamp(min=c["floor"]),
                            _INF)
    next_stall = (init["stall_e"] * c["inv_stall"] if fl["stall"]
                  else torch.full((n_pts,), _INF, dtype=f32, device=dev))
    attached = torch.full((n_pts, n_m), -1, dtype=torch.int64, device=dev)
    backlog = torch.zeros((n_pts, n_q), dtype=f32, device=dev)
    vac = torch.zeros_like(backlog)
    arr_res = torch.zeros_like(backlog)
    stall_end = torch.full((n_pts,), -1.0, dtype=f32, device=dev)
    rem = torch.full((n_pts,), c["duration"], dtype=f32, device=dev)
    duration = const(c["duration"])
    acc = torch.zeros((n_pts, len(SUM_NAMES)), dtype=f32, device=dev)
    win = torch.zeros((n_pts, max(p.n_windows, 1), 5), dtype=f32, device=dev)
    rows = torch.arange(n_pts, device=dev)
    steps_f, tail_steps = np.float32(c["steps"]), np.float32(c["tail_steps"])

    n_run = p.steps
    chunk = max(16, min(512, _CHUNK_ELEMS // max(n_pts, 1)))
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
            prev = (sleep_rem, attached, backlog, vac, arr_res, stall_end, next_stall)
            now = duration - rem
            occ = (attached[:, :, None] == qidx).any(1)
            sleeping = tmask & (attached < 0)

            # ---- the jump: distance to the next boundary, the reference's
            # guards in the reference's order
            wake_dt = torch.where(sleeping, sleep_rem.clamp(min=0.0), inf).amin(1)
            if sched_edges is not None:
                si = (torch.searchsorted(sched_edges, now[:, None], right=True) - 1).clamp(
                    0, n_seg - 1)
                scale = sched_scales.gather(1, si)[:, 0]
                nxt = sched_edges.gather(1, (si + 1).clamp(max=n_seg - 1))[:, 0]
                seg_dt = torch.where(si[:, 0] + 1 < n_seg, nxt - now, inf)
                lam_q = torch.where(qmask, (lam * scale / nq_f)[:, None], 0.0)
            else:
                lam_q = lam_fixed
            net_out = torch.where(occ, mu - lam_q, 0.0)
            drain_q = torch.where(occ & (net_out > eps_rate),
                                  backlog.clamp(min=0.0) / net_out.clamp(min=eps_rate), inf)
            drain_dt = drain_q.amin(1)
            net_in = lam_q - torch.where(occ, mu, 0.0)
            fill_dt = torch.where(qmask & (net_in > eps_rate) & (backlog < c["cap_fill"]),
                                  (c["cap"] - backlog) / net_in.clamp(min=eps_rate),
                                  inf).amin(1)
            dt_b = torch.minimum(wake_dt, drain_dt)
            dt_b2 = fill_dt if sched_edges is None else torch.minimum(fill_dt, seg_dt)
            dt_b = torch.minimum(dt_b, dt_b2)
            dt_b3 = next_stall - now if fl["stall"] else rem
            if p.n_windows:
                win_dt = (torch.floor(now * c["inv_window"]) + 1.0) * c["window"] - now
                dt_b3 = torch.minimum(win_dt, dt_b3)
            if fl["stall"]:
                dt_b3 = torch.minimum(dt_b3, rem)
            dt_b = torch.minimum(dt_b, dt_b3)
            steps_left = steps_f - np.float32(t)
            floor_eff = torch.minimum(wake_dt, drain_dt).clamp(min=eps_wake).clamp(
                max=c["floor"])
            if steps_left <= tail_steps:
                pace = rem / const(float(steps_left))
                floor_eff = torch.maximum(floor_eff, pace)
            dt = torch.minimum(torch.maximum(dt_b, floor_eff), rem)
            forced = (dt > dt_b.clamp(min=c["floor"]) + eps_wake) & live
            t_new = now + dt

            # 1. arrivals over dt (a queue draining out inside the step takes
            # them deterministically); 2. drain; 3. Little integral, vacations
            drain_now = occ & (drain_q <= (dt + eps_wake)[:, None])
            mu_a = lam_q * dt[:, None]
            z = torch.where(drain_now, 0.0, z_q[k])
            raw = arr_res + mu_a + _sqrt(mu_a) * z
            a = raw.clamp(min=0.0)
            arr_res = raw.clamp(max=0.0)
            mu_dt = (mu * dt)[:, None]
            room = (c["cap"] - backlog).clamp(min=0.0) + torch.where(occ, mu_dt, 0.0)
            adm = torch.minimum(a, room)
            offered, dropped = _sum(a), _sum(a - adm)
            serve = torch.where(occ, torch.minimum(backlog + adm, mu_dt), 0.0)
            b_new = (backlog + adm - serve).clamp(min=0.0, max=c["cap"])
            served = _sum(serve)
            lat_area = 0.5 * (_sum(backlog) + _sum(b_new)) * dt
            vac = vac + torch.where(qmask & ~occ, dt[:, None], 0.0)
            backlog = b_new

            # 4. the stall process at the boundary
            if fl["stall"]:
                fire = (next_stall <= t_new) & live
                w_end = next_stall + st_len[k]
                stall_end = torch.where(fire, torch.maximum(stall_end, w_end), stall_end)
                next_stall = torch.where(fire, next_stall + st_gap[k], next_stall)

            # 5. wakes at the boundary (an open stall window defers them)
            sleep_rem = torch.where(sleeping, sleep_rem - dt[:, None], sleep_rem)
            woken = sleeping & (sleep_rem <= eps_wake) & live[:, None]
            if fl["stall"]:
                push = woken & (t_new < stall_end)[:, None]
                woken = woken & ~push
                sleep_rem = torch.where(push, (stall_end - t_new)[:, None] + jitter[k],
                                        sleep_rem)
            n_wake = woken.sum(1, dtype=f32)

            # 6. queues drained out release their thread (fresh T_S sleep)
            q_done = occ & (backlog <= c["release"])
            t_done = (attached >= 0) & q_done.gather(1, attached.clamp(0, n_q - 1))
            sleep_rem = torch.where(t_done, slp_s[k], sleep_rem)
            attached = torch.where(t_done, -1, attached)
            occ = occ & ~q_done
            tsa = t_done.sum(1, dtype=f32)

            # 7. claims, threads in index order: the longest free backlog >= 1
            # (ties to the lowest index), else an empty win (re-sleep T_S
            # onto the expired timer's residual), else a busy try (T_L)
            busy = cyc = vacs = nvs = torch.zeros((n_pts,), dtype=f32, device=dev)
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

            # sums: a finished point holds its carry (the reference gates
            # every step after the run's end)
            rem = rem - dt
            awake = n_wake * c["wake_cost"] + served * c["inv_mu"]
            energy = c["active_power"] * awake + tsa * e_arm_s + busy * e_arm_l
            vals = torch.stack([offered, dropped, served, n_wake, busy, cyc, awake, lat_area,
                                vacs, nvs, tsa, energy, torch.ones_like(dt),
                                forced.to(f32)], dim=1)
            acc = acc + torch.where(live[:, None], vals, 0.0)
            if p.n_windows:
                wi = (now * c["inv_window"]).to(torch.int32).clamp(0, p.n_windows - 1).long()
                wv = torch.where(live[:, None],
                                 torch.stack([offered, served, lat_area, awake, energy], 1),
                                 0.0)
                win[rows, wi] = win[rows, wi] + wv
            if not bool(live.all()):
                nxt = (sleep_rem, attached, backlog, vac, arr_res, stall_end, next_stall)
                (sleep_rem, attached, backlog, vac, arr_res, stall_end, next_stall) = (
                    torch.where(live.view(-1, *[1] * (new.dim() - 1)), new, old)
                    for new, old in zip(nxt, prev, strict=True))
        if done:
            break

    out = dict(zip(SUM_NAMES, acc.unbind(1)))
    out["win"] = win[:, :p.n_windows]
    out["backlog"] = _sum(backlog)
    out["sim_time"] = duration - rem
    return out


def _check(cols: dict, sched_edges, sched_scales, params: AdaptiveParams) -> None:
    check_columns(cols, sched_edges, sched_scales, params.sleep_states)
    if params.max_steps < 1 or params.duration_us <= 0.0:
        raise ValueError("the sweep needs max_steps >= 1 and duration_us > 0")
    if params.n_windows and not params.window_us > 0:
        raise ValueError("windows need window_us > 0")


def adaptive_sweep(t_s, t_l, m, nq, lam, seed_lo, seed_hi, sched_edges=None,
                   sched_scales=None, *, params: AdaptiveParams) -> dict[str, torch.Tensor]:
    """The event-jump sweep over P points: ``t_s``, ``t_l``, ``lam`` float32
    (P,), ``m``, ``nq``, ``seed_lo``, ``seed_hi`` int32 (P,) (the seed halves
    as int32 bit patterns), optional float32 (P, n_seg) schedule rows -> the
    dict of ``reference_adaptive_sweep``.

    CUDA tensors go through the kernel, one launch; CPU tensors through
    ``reference_adaptive_sweep``."""
    cols = {"t_s": t_s, "t_l": t_l, "m": m, "nq": nq, "lam": lam, "seed_lo": seed_lo,
            "seed_hi": seed_hi}
    _check(cols, sched_edges, sched_scales, params)
    if t_s.device.type == "cpu":
        return reference_adaptive_sweep(t_s, t_l, m, nq, lam, seed_lo, seed_hi, sched_edges,
                                        sched_scales, params)
    if t_s.device.type != "cuda":
        raise ValueError(f"adaptive_sweep runs on CUDA or CPU tensors, got {t_s.device}")
    cols = {k: v.contiguous() for k, v in cols.items()}
    if sched_edges is not None:
        sched_edges, sched_scales = sched_edges.contiguous(), sched_scales.contiguous()
    n = t_s.shape[0]
    sums = torch.empty((len(SUM_NAMES), n), dtype=torch.float32, device=t_s.device)
    win = torch.empty((n, params.n_windows, 5), dtype=torch.float32, device=t_s.device)
    ends = torch.empty((2, n), dtype=torch.float32, device=t_s.device)
    build = launch_adaptive_sweep(cols, sched_edges, sched_scales, params, sums, win, ends,
                                  m_max=int(cols["m"].max()), q_max=int(cols["nq"].max()))
    adaptive_sweep.launches += 1
    adaptive_sweep.launches_by_build[build] = adaptive_sweep.launches_by_build.get(build, 0) + 1
    out = dict(zip(SUM_NAMES, sums.unbind(0)))
    out["win"] = win
    out["backlog"], out["sim_time"] = ends.unbind(0)
    return out


adaptive_sweep.launches = 0
adaptive_sweep.launches_by_build = {}  # (M_MAX, Q_MAX) -> launches
