"""ctypes binding of ``csrc/fleet_adaptive_sweep.cu`` (counterpart of the
reference's ``_build_fleet_sweep`` with ``stepping="adaptive"``, which jits
the point-vmapped ``lax.scan`` of ``fleet_step_a`` over the step budget)."""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from ..slot_sweep.kernel import NVCC_EXTRA

__all__ = ["CLUSTER_BLOCKS", "MAX_HOSTS_PER_LANE", "STAGES", "STAGE_STEPS", "ROUTES", "build",
           "launch_fleet_adaptive_sweep", "layout", "ring_bytes", "route"]

_SOURCE = "fleet_adaptive_sweep.cu"
# the ring of the kernel's ring and cluster routes: stages, and steps a stage
# (kStages and kStageSteps of the source)
STAGES = 2
STAGE_STEPS = 8
ROUTES = ("ring", "scratch", "cluster")   # the build's third word, the layout's last
_MAX_LANES = 256    # kMaxLanes: one block a point up to here (the ring route)
CLUSTER_BLOCKS = 8        # kClusterBlocks: a point's blocks on the cluster route
MAX_HOSTS_PER_LANE = 7    # kMaxHostsPerLane: the cluster route's largest K
_M_MAX = 4          # the builds' M_MAX
_P, _I = ctypes.c_void_p, ctypes.c_int
_FP = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    # t_s, t_l, m, nq, lam, seed_lo, seed_hi, hedge_d, sched_edges, sched_scales,
    # shares, stats, ends, scratch, n_points, n_hosts, n_run, m_max, q_max, n_seg,
    # lb, far_count, flags, fparams, n_fparams, states, n_states, device, build
    # (3 ints out), stream
    "fleet_adaptive_sweep_fwd": (_I, [_P] * 14 + [_I] * 9
                                 + [_FP, _I, _FP, _I, _I, ctypes.POINTER(_I), _P]),
    "fleet_adaptive_sweep_layout": (None, [_I, _I, _I, ctypes.POINTER(_I)]),
    "fleet_adaptive_sweep_error_string": (ctypes.c_char_p, [_I]),
}
# AdaptiveParams.constants(), then ops.fleet_constants(), in the order of
# the source's fparams
_FPARAMS = ("floor", "duration", "mu", "inv_mu", "cap", "cap_fill", "wake_cost", "base",
            "sigma", "slope1", "tail_prob", "tail_mean", "intf_prob", "intf_mean", "inv_stall",
            "stall_mean", "active_power", "steps", "tail_steps")
_FLEET_FPARAMS = ("inv_soft", "near_cost", "far_cost", "link_rate", "link_floor", "hedge_eps",
                  "stale", "inv_stale")


def build(source: str = _SOURCE):
    """Build (once) and load the kernel's library, with the fixed-slot
    sweep's ``-fmad=false``: every product and sum rounds as the plain
    version's separate PyTorch operations do.  ``source`` may name another
    file with the same C interface (an absolute path:
    ``fleet_adaptive_sweep_fwd``, ``fleet_adaptive_sweep_layout``, by which
    its own scratch is sized, and ``fleet_adaptive_sweep_error_string``), for
    an A/B of two versions of the kernel in one process."""
    return load_library(source, _SIGNATURES, NVCC_EXTRA)


def _flag_bits(params, fleet) -> int:
    """The source's flags: 1 sigma, 2 tail, 4 interference, 8 stalls, 16
    topology, 32 the bottleneck link."""
    fl = params.flags
    return (fl["sigma"] | fl["tail"] << 1 | fl["intf"] << 2 | fl["stall"] << 3
            | fleet.topo_on << 4 | fleet.link_on << 5)


def route(n_hosts: int) -> str:
    """The kernel's route for points of ``n_hosts`` hosts: ``"ring"`` up to
    256 (one block a point, a host a consumer lane), ``"cluster"`` up to 256
    ``MAX_HOSTS_PER_LANE`` (a cluster of ``CLUSTER_BLOCKS`` blocks a point,
    K = ceil(H / 256) consumer warps a block, a host a thread), else
    ``"scratch"`` (one block a point, the hosts' states in global memory)."""
    k = -(-n_hosts // _MAX_LANES)
    return "ring" if k == 1 else "cluster" if k <= MAX_HOSTS_PER_LANE else "scratch"


def ring_bytes(n_hosts: int, q_max: int, stalls: bool) -> int:
    """Bytes of a block's ring in shared memory for points of ``n_hosts``
    hosts with up to ``q_max`` queues (the build's Q_MAX: 1 or 4), counted
    as the source lays it out: ``STAGES`` stages of ``STAGE_STEPS`` steps, a
    step the arrival normals (Q_MAX) and overshoots (M_MAX) and, with stalls
    on, the stall window's length and gap and the re-arm jitters (M_MAX) of
    each host lane (S2's fields): W lanes on the ring route, the block's 32
    K on the cluster route; 0 on the scratch route."""
    r = route(n_hosts)
    if r == "scratch":
        return 0
    lanes = (1 << (n_hosts - 1).bit_length() if r == "ring"   # the least power of two >= H
             else 32 * -(-n_hosts // _MAX_LANES))
    q = 1 if q_max == 1 else 4
    fields = q + _M_MAX + (2 + _M_MAX if stalls else 0)
    return 4 * STAGES * STAGE_STEPS * fields * lanes


def layout(n_hosts: int, q_max: int, flags: int, lib=None) -> dict[str, int]:
    """The kernel's launch layout for points of ``n_hosts`` hosts with up to
    ``q_max`` queues and the source's ``flags`` (``_flag_bits``), as the
    library ``lib`` (default: this checkout's) gives it: threads a block,
    lanes of the host reductions, hosts a lane, the float32 words of a
    host's state in global scratch (0 where a thread holds its host in
    registers), producer warps a block, the ring's stages, steps a stage and
    bytes a block (0 on the scratch route), blocks a point and the route
    (``ROUTES``).  A library built from a source before the cluster route
    gives the first eight (the last two read as 0)."""
    out = (_I * 10)()
    (build() if lib is None else lib).fleet_adaptive_sweep_layout(n_hosts, q_max, flags, out)
    lay = dict(zip(("threads", "lanes", "hosts_per_lane", "scratch_words", "producer_warps",
                    "stages", "stage_steps", "ring_bytes", "blocks", "route"), out))
    lay["route"] = ROUTES[lay["route"]]
    return lay


def _floats(values) -> ctypes.Array:
    return (ctypes.c_float * len(values))(*values)


def launch_fleet_adaptive_sweep(cols: dict, sched_edges, sched_scales, params, fleet, stats,
                                ends, *, m_max: int, q_max: int,
                                lib=None) -> tuple[int, int, str]:
    """Launch the sweep on the current stream of the inputs' device and
    return the (M_MAX, Q_MAX, route) build it launched.  Shapes, types and
    devices are checked by the caller (``ops``)."""
    from .ops import fleet_constants

    lib = build() if lib is None else lib
    p, fp = params, fleet
    bits = _flag_bits(p, fp)
    c, fc = p.constants(), fleet_constants(fp, p)
    fparams = _floats([c[k] for k in _FPARAMS] + [fc[k] for k in _FLEET_FPARAMS])
    states = _floats([x for s in p.sleep_states for x in s])
    t_s = cols["t_s"]
    n, dev = t_s.shape[0], t_s.device
    lay = layout(fp.n_hosts, q_max, bits, lib)   # each source's own scratch
    scratch = torch.empty(max(n * fp.n_hosts * lay["scratch_words"], 1), dtype=torch.float32,
                          device=dev)
    shares = torch.tensor(fp.shares if fp.lb_code != 2 else [0.0] * fp.n_hosts,
                          dtype=torch.float32, device=dev)
    device = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_seg = 0 if sched_edges is None else sched_edges.shape[1]
    launched = (_I * 3)()
    err = lib.fleet_adaptive_sweep_fwd(
        *(cols[k].data_ptr() for k in ("t_s", "t_l", "m", "nq", "lam", "seed_lo", "seed_hi",
                                       "hedge_d")),
        None if sched_edges is None else sched_edges.data_ptr(),
        None if sched_scales is None else sched_scales.data_ptr(),
        shares.data_ptr(), stats.data_ptr(), ends.data_ptr(), scratch.data_ptr(),
        n, fp.n_hosts, p.steps, m_max, q_max, n_seg, fp.lb_code, fp.far_count, bits, fparams,
        len(fparams), states, len(p.sleep_states), device, launched, stream)
    if err != 0:
        msg = lib.fleet_adaptive_sweep_error_string(err).decode()
        raise RuntimeError(f"fleet_adaptive_sweep kernel launch failed: {msg} ({err})")
    return launched[0], launched[1], ROUTES[launched[2]]
