"""ctypes binding of ``csrc/fleet_sweep.cu`` (counterpart of the reference's
``_build_fleet_sweep``, which jits the point-vmapped, host-vmapped
``lax.scan`` over slots)."""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from ..slot_sweep.kernel import NVCC_EXTRA

__all__ = ["CLUSTER_BLOCKS", "MAX_HOSTS_PER_LANE", "ROUTES", "STAGES", "STAGE_SLOTS", "build",
           "exchange_probe", "launch_fleet_sweep", "layout", "ring_bytes", "route"]

_SOURCE = "fleet_sweep.cu"
# the ring of the kernel's ring and cluster routes: stages, and slots a stage
# (kStages and kStageSlots of the source)
STAGES = 2
STAGE_SLOTS = 8
ROUTES = ("ring", "scratch", "cluster")   # the build's third word, the layout's last
_MAX_LANES = 256    # kMaxLanes: one block a point up to here (the ring route)
CLUSTER_BLOCKS = 8        # kClusterBlocks: a point's blocks on the cluster route
MAX_HOSTS_PER_LANE = 8    # kMaxHostsPerLane: the cluster route's largest K
_M_MAX = 4          # the builds' M_MAX
_P, _I = ctypes.c_void_p, ctypes.c_int
_FP = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    # t_s, t_l, m, nq, lam, seed_lo, seed_hi, hedge_d, sched_edges, sched_scales,
    # shares, stats, scratch, n_points, n_hosts, n_slots, m_max, q_max, n_seg, lb,
    # stale_every, far_count, flags, fparams, n_fparams, states, n_states, device,
    # build (3 ints out), stream
    "fleet_sweep_fwd": (_I, [_P] * 13 + [_I] * 10
                        + [_FP, _I, _FP, _I, _I, ctypes.POINTER(_I), _P]),
    "fleet_sweep_layout": (None, [_I, _I, _I, ctypes.POINTER(_I)]),
    "fleet_sweep_error_string": (ctypes.c_char_p, [_I]),
    # mode, hosts_per_lane, n, out, device, stream
    "fleet_cluster_exchange_probe": (_I, [_I, _I, _I, _P, _I, _P]),
}
# FleetParams.constants() in the order of the source's fparams, after the
# sweep's own
_FLEET_FPARAMS = ("inv_soft", "near_cost", "far_cost", "link_rate", "link_floor", "inv_dt",
                  "inv_mu", "hedge_eps")


def build(source: str = _SOURCE):
    """Build (once) and load the kernel's library, with the fixed-slot
    sweep's ``-fmad=false``: every product and sum rounds as the plain
    version's separate PyTorch operations do.  ``source`` may name another
    file with the same C interface (an absolute path: ``fleet_sweep_fwd``,
    ``fleet_sweep_layout``, by which its own scratch is sized, and
    ``fleet_sweep_error_string``), for an A/B of two versions of the kernel
    in one process."""
    sigs = _SIGNATURES if source == _SOURCE else {
        k: v for k, v in _SIGNATURES.items() if k != "fleet_cluster_exchange_probe"}
    return load_library(source, sigs, NVCC_EXTRA)


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
    as the source lays it out: ``STAGES`` stages of ``STAGE_SLOTS`` slots, a
    slot the arrival normals (Q_MAX), overshoots (M_MAX) and, with stalls
    on, re-arm jitters (M_MAX) and the stall end of each host lane (W lanes
    on the ring route, the block's 32 K on the cluster route), then the
    slot's scale; 0 on the scratch route."""
    r = route(n_hosts)
    if r == "scratch":
        return 0
    lanes = (1 << (n_hosts - 1).bit_length() if r == "ring"   # the least power of two >= H
             else 32 * -(-n_hosts // _MAX_LANES))
    q = 1 if q_max == 1 else 4
    fields = q + _M_MAX + (_M_MAX + 1 if stalls else 0)
    return 4 * STAGES * STAGE_SLOTS * (fields * lanes + 1)


def layout(n_hosts: int, q_max: int, flags: int, lib=None) -> dict[str, int]:
    """The kernel's launch layout for points of ``n_hosts`` hosts with up to
    ``q_max`` queues and the source's ``flags`` (``_flag_bits``), as the
    library ``lib`` (default: this checkout's) gives it: threads a block,
    lanes of the host reductions, hosts a lane, the float32 words of a
    host's state that a thread keeps in global scratch (0 where a thread
    holds its host in registers), producer warps a block, the ring's stages,
    slots a stage and bytes a block (0 on the scratch route), blocks a point
    and the route (``ROUTES``).  A library built from a source before the
    cluster route gives the first eight (the last two read as 0)."""
    out = (_I * 10)()
    (build() if lib is None else lib).fleet_sweep_layout(n_hosts, q_max, flags, out)
    lay = dict(zip(("threads", "lanes", "hosts_per_lane", "scratch_words", "producer_warps",
                    "stages", "stage_slots", "ring_bytes", "blocks", "route"), out))
    lay["route"] = ROUTES[lay["route"]]
    return lay


def _floats(values) -> ctypes.Array:
    return (ctypes.c_float * len(values))(*values)


def launch_fleet_sweep(cols: dict, sched_edges, sched_scales, params, fleet, stats, *,
                       m_max: int, q_max: int, lib=None) -> tuple[int, int, str]:
    """Launch the fleet sweep on the current stream of the inputs' device
    and return the (M_MAX, Q_MAX, route) build it launched.  Shapes, types and
    devices are checked by the caller (``ops``); ``lib`` is a library from
    ``build`` (default: this checkout's kernel)."""
    lib = build() if lib is None else lib
    p, fp = params, fleet
    bits = _flag_bits(p, fp)
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
    lay = layout(fp.n_hosts, q_max, bits, lib)   # each source's own scratch
    scratch = torch.empty(max(n * fp.n_hosts * lay["scratch_words"], 1), dtype=torch.float32,
                          device=dev)
    shares = torch.tensor(fp.shares if fp.lb_code != 2 else [0.0] * fp.n_hosts,
                          dtype=torch.float32, device=dev)
    device = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_seg = 0 if sched_edges is None else sched_edges.shape[1]
    launched = (_I * 3)()
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
    return launched[0], launched[1], ROUTES[launched[2]]


def exchange_probe(mode: int, hosts_per_lane: int, n: int, out: torch.Tensor) -> torch.Tensor:
    """Launch the cluster route's exchange probe on the current stream of
    ``out`` (float32 on the card, 8 x the block's threads: 32, or 32
    ``hosts_per_lane`` in modes 1 and 2): one cluster of 8 blocks runs ``n``
    exchanges in turn, mode 0 the bare push of a 16-byte record with the
    cluster barrier, 1 the route's reduction of a sum, 2 of the hedge
    record.  For timing the exchange alone (``chip_smoke.py``)."""
    lib = build()
    dev = out.device
    err = lib.fleet_cluster_exchange_probe(
        mode, hosts_per_lane, n, out.data_ptr(), dev.index if dev.index is not None else
        torch.cuda.current_device(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.fleet_sweep_error_string(err).decode()
        raise RuntimeError(f"fleet_cluster_exchange_probe launch failed: {msg} ({err})")
    return out
