"""Adaptive macro-slot (event-jump) variant of the batched engine.

The port's counterpart of ``repro.runtime.batched_adaptive``.  The
fixed-slot sweep spends compute proportional to *simulated time*: at the
paper's own operating points (T_S ~ 50us, threads asleep most of the time)
~99% of its 0.5us slots advance a slot in which no thread wakes and no queue
drains.  This engine advances each step by a *variable* ``dt``, the
distance to the next "interesting" boundary (the earliest pending wake, a
locked queue's drain-out, a queue's fill to capacity, the load schedule's
segment end, the next window edge, the next correlated-stall start, the end
of the run), with closed-form multi-slot aggregates over the step: one
arrival draw of variance ``lam*dt``, drain ``min(backlog + admitted,
mu*dt)``, the trapezoid latency area.  The model, its approximations
against the event engine and its parity bands are the reference's
(``src/repro/runtime/batched_adaptive.py``'s docstring gives them); the
step runs in ONE launch of the hand-written CUDA kernel
``repro_torch.kernels.adaptive_sweep`` (one GPU thread a point), or in its
plain PyTorch version with ``device="cpu"``.

What differs from the reference: the noise comes from the Philox contract
of ``repro_torch.kernels.adaptive_sweep.philox`` (same grid, other sample
paths, same bands); nothing is compiled per shape (so no compile cache),
and a point's thread stops at the step where it reaches the duration.  The
step budget is the reference's: ``estimate_adaptive_steps`` rounded up by
``bucket_steps``, the maximum over the grid, and its last eighth paces
every point still running, so a point's outputs depend on the grid it sits
in, as in the reference.
"""

from __future__ import annotations

import math

import numpy as np

from ..kernels.adaptive_sweep import AdaptiveParams, adaptive_sweep
from ..kernels.adaptive_sweep.ops import SUM_NAMES
from .simcore import SimRunConfig

__all__ = ["estimate_adaptive_steps", "adaptive_sweep_inputs", "adaptive_sweep_arrays"]

# SimRunConfig fields this engine deliberately does NOT read — the same
# declarations batched.py makes, proven complete by the engine-parity
# static check (repro.analysis PARITY001/002, which treats this module
# exactly like batched.py):
#   - grid-supplied: seed / n_queues come per-point from the SweepGrid
#     row (the grid axis IS the sweep surface);
#   - event-engine-only: binned time series stay with simulate_run
#     (validate_batched_config rejects them before this module runs);
#   - sample-path detail: no latency reservoir exists in a fluid engine.
_GRID_SUPPLIED_FIELDS = ("seed", "n_queues")
_EVENT_ENGINE_ONLY_FIELDS = ("timeseries_bin_us",)
_NO_SAMPLE_PATH_FIELDS = ("latency_reservoir",)

_WAKE_EPS_US = 1e-6      # timer-expiry threshold after a macro-jump
_RATE_EPS = 1e-9         # net-rate floor for drain/fill boundaries
_FILL_SLACK_PKTS = 1.0   # stop chasing the fill boundary this close to cap


def estimate_adaptive_steps(grid, cfg: SimRunConfig, slot_us: float,
                            n_windows: int) -> int:
    """Conservative scan-length budget for the adaptive kernel.

    Boundaries per point: each thread wake is one step, and each busy
    period ends in exactly one drain-out step (the drain-boundary step
    takes its arrivals deterministically, so the prediction lands on
    empty with no corrective jumps), so ``3x`` the wake budget
    ``m * duration / primary_cycle`` covers wake + drain + fill + claim
    slack; schedule segments, window edges and the expected stall-start
    count add linearly.  Clamped at the fixed engine's own slot count —
    adaptive never scans more than fixed would have."""
    sm = cfg.sleep_model
    ts_us = np.maximum(np.asarray(grid.t_s_us, dtype=np.float64),
                       2.0 * slot_us)
    cycle = ts_us * (1.0 + sm.slope) + sm.base_us
    wake_budget = (np.asarray(grid.m, dtype=np.float64)
                   * cfg.duration_us / cycle)
    n_bound = 0
    scheds = list(grid.schedules) if grid.schedules else []
    if cfg.schedule is not None:
        scheds.append(cfg.schedule)
    for s in scheds:
        if s is not None:
            n_bound = max(n_bound, len(s.jump_boundaries(cfg.duration_us)))
    extras = (n_bound + n_windows
              + cfg.stall_rate_per_us * cfg.duration_us + 64)
    n_slots = max(int(math.ceil(cfg.duration_us / slot_us)), 1)
    return int(min(math.ceil(3.0 * float(wake_budget.max()) + extras),
                   n_slots))


def adaptive_sweep_inputs(grid, cfg: SimRunConfig, slot_us: float,
                          device) -> tuple[tuple, AdaptiveParams]:
    """The arguments of ``adaptive_sweep`` for ``grid`` in ``cfg`` on
    ``device``: the per-point columns (and schedule rows, or ``None``) and
    the batch's ``AdaptiveParams``, whose step budget is the reference's
    (``bucket_steps(estimate_adaptive_steps(...))``)."""
    # the fixed sweep's module supplies the grid preparation both
    # steppings share; imported here, as the reference does, so that the
    # two modules stay import-order independent
    from .batched import _schedule_rows, bucket_steps, grid_columns

    n_windows = (int(math.ceil(cfg.duration_us / cfg.window_us))
                 if cfg.window_us > 0 else 0)
    n_seg, sched_edges, sched_scales = _schedule_rows(grid, cfg)
    max_steps = bucket_steps(
        estimate_adaptive_steps(grid, cfg, slot_us, n_windows))
    sm = cfg.sleep_model
    em = cfg.energy_model
    params = AdaptiveParams(
        max_steps=max_steps, slot_us=float(slot_us), duration_us=float(cfg.duration_us),
        service_rate_mpps=float(cfg.service_rate_mpps),
        queue_capacity=float(cfg.queue_capacity), wake_cost_us=float(cfg.wake_cost_us),
        base_us=float(sm.base_us), slope=float(sm.slope), sigma_us=float(sm.sigma_us),
        tail_prob=float(sm.tail_prob), tail_mean_us=float(sm.tail_mean_us),
        interference_prob=float(cfg.interference_prob),
        interference_mean_us=float(cfg.interference_mean_us),
        stall_rate_per_us=float(cfg.stall_rate_per_us),
        stall_mean_us=float(cfg.stall_mean_us),
        active_power_w=float(em.active_power_w), sleep_states=em.sleep_states,
        n_windows=n_windows, window_us=float(cfg.window_us))
    return grid_columns(grid, n_seg, sched_edges, sched_scales, device), params


def adaptive_sweep_arrays(grid, cfg: SimRunConfig, slot_us: float, device):
    """Run ``grid`` through the event-jump sweep on ``device`` (one kernel
    launch on a CUDA device, the plain version on the CPU).

    Returns ``(vals, win, final_backlog, sim_time_us, scan_len)`` in the
    array conventions ``simulate_batch`` assembles into ``BatchStats``, as
    the reference's does."""
    args, params = adaptive_sweep_inputs(grid, cfg, slot_us, device)
    out = adaptive_sweep(*args, params=params)
    vals = {k: out[k].cpu().numpy().astype(np.float64) for k in SUM_NAMES}
    win = (out["win"].cpu().numpy().astype(np.float64) if params.n_windows
           else np.empty(0))
    return (vals, win, out["backlog"].cpu().numpy().astype(np.float64),
            out["sim_time"].cpu().numpy().astype(np.float64), params.max_steps)
