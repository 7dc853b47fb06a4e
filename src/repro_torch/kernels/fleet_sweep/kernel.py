"""ctypes binding of ``csrc/fleet_sweep.cu`` (counterpart of the reference's
``_build_fleet_sweep``, which jits the point-vmapped, host-vmapped
``lax.scan`` over slots)."""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from ..slot_sweep.kernel import NVCC_EXTRA

__all__ = ["build", "launch_fleet_sweep", "layout"]

_SOURCE = "fleet_sweep.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_FP = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    # t_s, t_l, m, nq, lam, seed_lo, seed_hi, hedge_d, sched_edges, sched_scales,
    # shares, stats, scratch, n_points, n_hosts, n_slots, m_max, q_max, n_seg, lb,
    # stale_every, far_count, flags, fparams, n_fparams, states, n_states, device,
    # build (2 ints out), stream
    "fleet_sweep_fwd": (_I, [_P] * 13 + [_I] * 10
                        + [_FP, _I, _FP, _I, _I, ctypes.POINTER(_I), _P]),
    "fleet_sweep_layout": (None, [_I, _I, ctypes.POINTER(_I)]),
    "fleet_sweep_error_string": (ctypes.c_char_p, [_I]),
}
# FleetParams.constants() in the order of the source's fparams, after the
# sweep's own
_FLEET_FPARAMS = ("inv_soft", "near_cost", "far_cost", "link_rate", "link_floor", "inv_dt",
                  "inv_mu", "hedge_eps")


def build():
    """Build (once) and load the kernel's library, with the fixed-slot
    sweep's ``-fmad=false``: every product and sum rounds as the plain
    version's separate PyTorch operations do."""
    return load_library(_SOURCE, _SIGNATURES, NVCC_EXTRA)


def layout(n_hosts: int, q_max: int) -> dict[str, int]:
    """The kernel's launch layout for points of ``n_hosts`` hosts with up to
    ``q_max`` queues: threads a block (one block a point), lanes of the
    host reductions, hosts a lane, and the float32 words of a host's state
    that a lane keeps in global scratch when it holds more than one host
    (0 when each lane holds at most one, in registers)."""
    out = (_I * 4)()
    build().fleet_sweep_layout(n_hosts, q_max, out)
    return dict(zip(("threads", "lanes", "hosts_per_lane", "scratch_words"), out))


def _floats(values) -> ctypes.Array:
    return (ctypes.c_float * len(values))(*values)


def launch_fleet_sweep(cols: dict, sched_edges, sched_scales, params, fleet, stats, *,
                       m_max: int, q_max: int) -> tuple[int, int]:
    """Launch the fleet sweep on the current stream of the inputs' device
    and return the (M_MAX, Q_MAX) build it launched.  Shapes, types and
    devices are checked by the caller (``ops``)."""
    lib = build()
    p, fp = params, fleet
    fl = p.flags
    bits = (fl["sigma"] | fl["tail"] << 1 | fl["intf"] << 2 | fl["stall"] << 3
            | fp.topo_on << 4 | fp.link_on << 5)
    c = fp.constants(p)
    # float32 constants, each rounded once from its double value (the
    # reference's weakly typed Python floats)
    fparams = _floats((p.slot_us, p.duration_us, p.service_rate_mpps,
                       p.service_rate_mpps * p.slot_us, p.queue_capacity, p.wake_cost_us,
                       p.base_us, p.sigma_us, 1.0 + p.slope, p.tail_prob, p.tail_mean_us,
                       p.interference_prob, p.interference_mean_us, p.stall_p,
                       p.stall_mean_us, p.active_power_w, *(c[k] for k in _FLEET_FPARAMS)))
    states = _floats([x for s in p.sleep_states for x in s])
    t_s = cols["t_s"]
    n, dev = t_s.shape[0], t_s.device
    lay = layout(fp.n_hosts, q_max)
    scratch = torch.empty(max(n * fp.n_hosts * lay["scratch_words"], 1), dtype=torch.float32,
                          device=dev)
    shares = torch.tensor(fp.shares if fp.lb_code != 2 else [0.0] * fp.n_hosts,
                          dtype=torch.float32, device=dev)
    device = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_seg = 0 if sched_edges is None else sched_edges.shape[1]
    launched = (_I * 2)()
    err = lib.fleet_sweep_fwd(
        *(cols[k].data_ptr() for k in ("t_s", "t_l", "m", "nq", "lam", "seed_lo", "seed_hi",
                                       "hedge_d")),
        None if sched_edges is None else sched_edges.data_ptr(),
        None if sched_scales is None else sched_scales.data_ptr(),
        shares.data_ptr(), stats.data_ptr(), scratch.data_ptr(),
        n, fp.n_hosts, p.n_slots, m_max, q_max, n_seg, fp.lb_code, fp.stale_every_slots,
        fp.far_count, bits, fparams, len(fparams), states, len(p.sleep_states), device,
        launched, stream)
    if err != 0:
        msg = lib.fleet_sweep_error_string(err).decode()
        raise RuntimeError(f"fleet_sweep kernel launch failed: {msg} ({err})")
    return launched[0], launched[1]
