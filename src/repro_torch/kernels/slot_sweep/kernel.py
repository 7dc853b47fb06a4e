"""ctypes binding of ``csrc/slot_sweep.cu`` (counterpart of the reference's
``_build_sweep``, which jits the vmapped ``lax.scan`` over slots)."""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

__all__ = ["build", "launch_slot_sweep"]

_SOURCE = "slot_sweep.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_FP = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    # t_s, t_l, m, nq, lam, seed_lo, seed_hi, sched_edges, sched_scales, stats,
    # win, backlog, n_points, n_slots, m_max, q_max, n_seg, n_windows,
    # n_win_pad, flags, fparams, n_fparams, states, n_states, device,
    # build (2 ints out), stream
    "slot_sweep_fwd": (_I, [_P] * 12 + [_I] * 8
                       + [_FP, _I, _FP, _I, _I, ctypes.POINTER(_I), _P]),
    "slot_sweep_error_string": (ctypes.c_char_p, [_I]),
}
# no contraction of a * b + c into one fma: the kernel rounds every product
# and sum as the plain version's separate PyTorch operations do
NVCC_EXTRA = ("-fmad=false",)


def build():
    """Build (once) and load the kernel's library."""
    return load_library(_SOURCE, _SIGNATURES, NVCC_EXTRA)


def _floats(values) -> ctypes.Array:
    return (ctypes.c_float * len(values))(*values)


def launch_slot_sweep(cols: dict, sched_edges, sched_scales, params, stats, win, backlog, *,
                      m_max: int, q_max: int) -> tuple[int, int]:
    """Launch the sweep on the current stream of the inputs' device and
    return the (M_MAX, Q_MAX) build it launched.  Shapes, types and devices
    are checked by the caller (``ops``)."""
    lib = build()
    p = params
    flags = p.flags
    bits = flags["sigma"] | flags["tail"] << 1 | flags["intf"] << 2 | flags["stall"] << 3
    # float32 constants, each rounded once from its double value (the
    # reference's weakly typed Python floats)
    fparams = _floats((p.slot_us, p.duration_us, p.service_rate_mpps,
                       p.service_rate_mpps * p.slot_us, p.queue_capacity, p.wake_cost_us,
                       p.base_us, p.sigma_us, 1.0 + p.slope, p.tail_prob, p.tail_mean_us,
                       p.interference_prob, p.interference_mean_us, p.stall_p,
                       p.stall_mean_us, p.active_power_w, p.window_us))
    states = _floats([x for s in p.sleep_states for x in s])
    t_s = cols["t_s"]
    device = t_s.device.index if t_s.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(t_s.device).cuda_stream
    n_seg = 0 if sched_edges is None else sched_edges.shape[1]
    launched = (_I * 2)()
    err = lib.slot_sweep_fwd(
        *(cols[k].data_ptr() for k in ("t_s", "t_l", "m", "nq", "lam", "seed_lo", "seed_hi")),
        None if sched_edges is None else sched_edges.data_ptr(),
        None if sched_scales is None else sched_scales.data_ptr(),
        stats.data_ptr(), win.data_ptr() if win.numel() else None, backlog.data_ptr(),
        t_s.shape[0], p.n_slots, m_max, q_max, n_seg, p.n_windows, p.n_win_pad, bits,
        fparams, len(fparams), states, len(p.sleep_states), device, launched, stream)
    if err != 0:
        msg = lib.slot_sweep_error_string(err).decode()
        raise RuntimeError(f"slot_sweep kernel launch failed: {msg} ({err})")
    return launched[0], launched[1]
