"""ctypes binding of ``csrc/adaptive_sweep.cu`` (counterpart of the
reference's ``_build_adaptive_sweep``, which jits the vmapped ``lax.scan``
over the step budget)."""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from ..slot_sweep.kernel import NVCC_EXTRA

__all__ = ["STAGES", "STAGE_STEPS", "build", "launch_adaptive_sweep", "layout"]

_SOURCE = "adaptive_sweep.cu"
# the kernel's ring: stages, and steps a stage (kStages and kStageSteps of
# the source); a stage holds a step's fields for the 32 points (kPoints)
# of a block
STAGES = 3
STAGE_STEPS = 32
_POINTS = 32
_M_MAX = 4          # the builds' M_MAX
_P, _I = ctypes.c_void_p, ctypes.c_int
_FP = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    # t_s, t_l, m, nq, lam, seed_lo, seed_hi, sched_edges, sched_scales, sums,
    # win, ends, n_points, n_run, m_max, q_max, n_seg, n_windows, flags,
    # fparams, n_fparams, states, n_states, device, build (2 ints out), stream
    "adaptive_sweep_fwd": (_I, [_P] * 12 + [_I] * 7
                           + [_FP, _I, _FP, _I, _I, ctypes.POINTER(_I), _P]),
    "adaptive_sweep_error_string": (ctypes.c_char_p, [_I]),
}
# AdaptiveParams.constants() in the order of the source's fparams
_FPARAMS = ("floor", "duration", "mu", "inv_mu", "cap", "cap_fill", "wake_cost", "base",
            "sigma", "slope1", "tail_prob", "tail_mean", "intf_prob", "intf_mean", "inv_stall",
            "stall_mean", "active_power", "window", "inv_window", "steps", "tail_steps")


def build(source: str = _SOURCE):
    """Build (once) and load the kernel's library, with the fixed-slot
    sweep's ``-fmad=false``: every product and sum rounds as the plain
    version's separate PyTorch operations do.  ``source`` may name another
    file with the same launch interface (an absolute path), for an A/B of
    two versions of the kernel in one process."""
    return load_library(source, _SIGNATURES, NVCC_EXTRA)


def layout(params, q_max: int) -> dict[str, int]:
    """The kernel's ring for a sweep with ``params`` and up to ``q_max``
    queues a point (the build's Q_MAX: 1 or 4), as the source's ``Layout``
    counts it: stages, steps a stage, the fields of a step (the queues'
    normals, the threads' overshoots and, with stalls on, the stall
    window's length and gap and the threads' re-arm jitters; one word a
    lane each) and the ring's bytes of dynamic shared memory."""
    fields = (1 if q_max == 1 else 4) + _M_MAX + (2 + _M_MAX if params.flags["stall"] else 0)
    return {"stages": STAGES, "stage_steps": STAGE_STEPS, "fields": fields,
            "smem_bytes": 4 * STAGES * STAGE_STEPS * fields * _POINTS}


def _floats(values) -> ctypes.Array:
    return (ctypes.c_float * len(values))(*values)


def launch_adaptive_sweep(cols: dict, sched_edges, sched_scales, params, sums, win, ends, *,
                          m_max: int, q_max: int, lib=None) -> tuple[int, int]:
    """Launch the sweep on the current stream of the inputs' device and
    return the (M_MAX, Q_MAX) build it launched.  Shapes, types and devices
    are checked by the caller (``ops``); ``lib`` is a library from
    ``build`` (default: this checkout's kernel)."""
    lib = build() if lib is None else lib
    p = params
    flags = p.flags
    bits = flags["sigma"] | flags["tail"] << 1 | flags["intf"] << 2 | flags["stall"] << 3
    consts = p.constants()
    fparams = _floats([consts[k] for k in _FPARAMS])
    states = _floats([x for s in p.sleep_states for x in s])
    t_s = cols["t_s"]
    device = t_s.device.index if t_s.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(t_s.device).cuda_stream
    n_seg = 0 if sched_edges is None else sched_edges.shape[1]
    launched = (_I * 2)()
    err = lib.adaptive_sweep_fwd(
        *(cols[k].data_ptr() for k in ("t_s", "t_l", "m", "nq", "lam", "seed_lo", "seed_hi")),
        None if sched_edges is None else sched_edges.data_ptr(),
        None if sched_scales is None else sched_scales.data_ptr(),
        sums.data_ptr(), win.data_ptr() if win.numel() else None, ends.data_ptr(),
        t_s.shape[0], p.steps, m_max, q_max, n_seg, p.n_windows, bits,
        fparams, len(fparams), states, len(p.sleep_states), device, launched, stream)
    if err != 0:
        msg = lib.adaptive_sweep_error_string(err).decode()
        raise RuntimeError(f"adaptive_sweep kernel launch failed: {msg} ({err})")
    return launched[0], launched[1]
