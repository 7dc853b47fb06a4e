"""ctypes binding of ``csrc/adaptive_sweep.cu`` (counterpart of the
reference's ``_build_adaptive_sweep``, which jits the vmapped ``lax.scan``
over the step budget)."""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from ..slot_sweep.kernel import NVCC_EXTRA

__all__ = ["build", "launch_adaptive_sweep"]

_SOURCE = "adaptive_sweep.cu"
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


def build():
    """Build (once) and load the kernel's library, with the fixed-slot
    sweep's ``-fmad=false``: every product and sum rounds as the plain
    version's separate PyTorch operations do."""
    return load_library(_SOURCE, _SIGNATURES, NVCC_EXTRA)


def _floats(values) -> ctypes.Array:
    return (ctypes.c_float * len(values))(*values)


def launch_adaptive_sweep(cols: dict, sched_edges, sched_scales, params, sums, win, ends, *,
                          m_max: int, q_max: int) -> tuple[int, int]:
    """Launch the sweep on the current stream of the inputs' device and
    return the (M_MAX, Q_MAX) build it launched.  Shapes, types and devices
    are checked by the caller (``ops``)."""
    lib = build()
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
