"""Three-term roofline from a traced step, PyTorch port of
``repro.roofline.analysis``.

Per (arch x shape x mesh) cell, from one eager run of the step on
``DTensor`` inputs over ``meta`` storage (``launch.inputs.Cell.lower``)
under ``CostTrace``, which sees each device's own ops:

    compute    = FLOPs_per_device      / peak_FLOP/s_per_card
    memory     = bytes_per_device      / HBM_byte/s_per_card
    collective = coll_bytes_per_device / link_byte/s_per_card

``CostTrace`` is a dispatch mode that hands every op on DTensors to
DTensor first (as ``CommDebugMode`` does), so what comes back to it is
the rank's local ops on its local shards and the ``_c10d_functional``
collectives that DTensor issues between them; DTensor's own sharding
propagation (on ``FakeTensor``s) is skipped.  On a fake process group
every rank is rank 0, so the numbers are rank 0's: the per-device counts
of the reference's SPMD-partitioned module, with uneven shards at their
largest.  Replicated work counts in full on every device, which is what
``useful_flops_ratio`` shows.

  - FLOPs: ``torch.utils.flop_counter``'s registry on the local shapes
    (matmuls, convolutions, attention; elementwise ops count 0, by that
    registry's convention).
  - Bytes: each op that is not a view reads its tensor inputs and writes
    its outputs once.  This is eager traffic, op by op, with nothing
    fused: above what a compiler's cost model would count.
  - Collectives: each collective's operand bytes on the device, by the
    reference's five kinds; a collective that is not a dispatched op
    (``sharding.pipeline``'s ppermute over ``batch_isend_irecv``) reports
    itself through ``record_collective``.
  - Memory: argument bytes are the local shards' (exact, from the
    placements); the peak adds the most bytes that tensors allocated during
    the run held at once, tracked storage by storage.  This is eager's
    peak with PyTorch's own lifetimes, not a compiler's schedule.

Hardware constants (``HW``): NVIDIA H100 SXM datasheet values, not
measurements: 989 TFLOP/s dense bf16 (tensor cores) and 3.35 TB/s HBM3 a
card; ``link_bw`` is 50 GB/s a card, one 400 Gb/s NDR InfiniBand
(ConnectX-7) port a GPU in a DGX H100-class node.  It assumes that a
16-wide mesh axis spans more than one 8-GPU NVLink node, so a collective
over it is bound by the inter-node link, not by NVLink 4's 450 GB/s a
direction inside a node.  All three assume the card's full 700 W.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves as _pytree_leaves

from repro_torch.train.tree import tree_items

__all__ = ["HW", "CellReport", "CostTrace", "analyze_cell", "collective_bytes",
           "count_params", "model_flops", "record_collective", "roofline_terms"]

HW = {
    "peak_flops": 989e12,     # bf16 FLOP/s per card (H100 SXM, dense)
    "hbm_bw": 3.35e12,        # bytes/s per card (HBM3)
    "link_bw": 50e9,          # bytes/s per card (400 Gb/s NDR InfiniBand)
}

_COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")

# the c10d functional collectives (eager and autograd namespaces) by kind
_FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_FUNCOL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
# ops that allocate without touching the data
_NO_TRAFFIC = ("empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in _pytree_leaves(tree) if isinstance(t, torch.Tensor)]


class CostTrace(TorchDispatchMode):
    """Counts what a device does while it is on (see the module doc):
    ``flops``, ``bytes``, ``collectives`` as (kind, operand bytes, dtype)
    records, and ``live`` / ``peak``, the bytes that tensors allocated
    under it hold now and held at most.  With ``device`` (a device type)
    only ops whose tensors all lie there count: ``"meta"`` for the dry
    run, whose model lives there while DTensor computes shard sizes on
    small CPU tensors.  ``live`` and ``peak`` change under a lock: a
    storage's finalizer (``_free``) runs on whichever thread drops the last
    reference, also on the tracing thread when a collection runs inside the
    dispatch (so a reentrant lock)."""

    def __init__(self, device: str | None = None):
        super().__init__()
        self.device = device
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        self._dtensor, self._fake, self._flop_registry = DTensor, FakeTensor, flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: list[tuple[str, int, torch.dtype]] = []
        self.live = 0
        self.peak = 0
        self._lock = threading.RLock()

    def _free(self, nbytes: int) -> None:
        with self._lock:
            self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented        # DTensor first; its local ops come back here
        out = func(*args, **kwargs)
        inputs, outputs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, self._fake) for t in inputs + outputs):
            return out                   # DTensor's sharding propagation
        if self.device is not None and any(t.device.type != self.device
                                           for t in inputs + outputs):
            return out
        name = func._overloadpacket.__name__
        if func.namespace in _FUNCOL_NAMESPACES:
            kind = _FUNCOL_KIND.get(name.removesuffix("_coalesced"))
            if kind is not None:
                for t in inputs:
                    self.collectives.append((kind, _nbytes(t), t.dtype))
        else:
            count = self._flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
        fresh = [r.alias_info is None for r in func._schema.returns]
        if not any(fresh) and not any(r.alias_info.is_write for r in func._schema.returns):
            return out                   # a view: no bytes, no allocation
        if func.namespace not in _FUNCOL_NAMESPACES and name not in _NO_TRAFFIC:
            self.bytes += sum(map(_nbytes, inputs)) + sum(map(_nbytes, outputs))
        if all(fresh):
            for t in outputs:
                n = t.untyped_storage().nbytes()
                with self._lock:
                    self.live += n
                    self.peak = max(self.peak, self.live)
                weakref.finalize(t.untyped_storage(), self._free, n)
        return out


def record_collective(kind: str, nbytes: int, dtype: torch.dtype) -> None:
    """Report a collective that is not a dispatched op to every active
    ``CostTrace``."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, CostTrace):
            mode.collectives.append((kind, nbytes, dtype))


def collective_bytes(records) -> dict:
    """Per-collective-type operand bytes (per device) + counts, from
    ``CostTrace.collectives``."""
    out = {op: 0 for op in _COLL_OPS}
    counts = {op: 0 for op in _COLL_OPS}
    for kind, nbytes, _ in records:
        out[kind] += nbytes
        counts[kind] += 1
    out["total"] = sum(out[o] for o in _COLL_OPS)
    out["counts"] = counts
    return out


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict:
    t_c = flops_per_dev / HW["peak_flops"]
    t_m = bytes_per_dev / HW["hbm_bw"]
    t_x = coll_bytes_per_dev / HW["link_bw"]
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.replace("_s", "")
    terms["bound_s"] = max(t_c, t_m, t_x)
    # roofline fraction: how much of the binding resource the useful
    # (compute) work occupies if perfectly overlapped
    terms["roofline_fraction"] = t_c / max(terms["bound_s"], 1e-30)
    return terms


def count_params(params_tree) -> tuple[int, int]:
    """(total, active) parameter counts from an eval_shape params tree."""
    total = active = 0
    for path, leaf in tree_items(params_tree):
        n = int(np.prod(leaf.shape))
        total += n
    return total, active


def model_flops(cfg, shape, params_tree) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (forward) with N = active params.

    Active params: MoE expert weights count k/E of their size (top-k of E
    experts touched per token); everything else counts fully.  The
    reference's sum over its leaves, in the same order.
    """
    total = 0.0
    for path, leaf in tree_items(params_tree):
        names = list(path)
        n = float(np.prod(leaf.shape))
        stacked = 1 if "blocks" in names else 0
        is_moe_w = (cfg.n_experts and leaf.ndim - stacked == 3
                    and names[-1] in ("w_gate", "w_up", "w_down"))
        if is_moe_w:
            n *= cfg.experts_per_token / cfg.n_experts
        if names[-1] in ("embed", "pos_embed"):
            continue  # gather, not matmul
        total += n
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * total * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * total * tokens
    # decode: one token per sequence
    return 2.0 * total * shape.global_batch


@dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    flops_per_dev: float = 0.0
    bytes_per_dev: float = 0.0
    coll_bytes_per_dev: float = 0.0
    coll_detail: dict = field(default_factory=dict)
    terms: dict = field(default_factory=dict)
    model_flops_global: float = 0.0
    arg_bytes: int = 0
    temp_bytes: int = 0
    peak_bytes: int = 0
    out_bytes: int = 0
    compile_s: float = 0.0
    n_devices: int = 0

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (HLO flops aggregated over chips)."""
        agg = self.flops_per_dev * max(self.n_devices, 1)
        return self.model_flops_global / agg if agg else 0.0

    def row(self) -> dict:
        t = self.terms
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": t.get("compute_s", 0), "memory_s": t.get("memory_s", 0),
            "collective_s": t.get("collective_s", 0),
            "dominant": t.get("dominant", "?"),
            "roofline_fraction": t.get("roofline_fraction", 0),
            "useful_flops_ratio": self.useful_flops_ratio,
            "arg_gb": self.arg_bytes / 1e9, "temp_gb": self.temp_bytes / 1e9,
            "peak_gb": self.peak_bytes / 1e9,
            "compile_s": self.compile_s,
        }


def analyze_cell(arch, shape_name, mesh_name, trace: CostTrace, *,
                 model_flops_global: float, n_devices: int, arg_bytes: int,
                 out_bytes: int = 0, compile_s: float = 0.0) -> CellReport:
    """The report of one traced step (``Cell.lower``'s trace); ``arg_bytes``
    and ``out_bytes`` are the local bytes of its inputs and outputs.  The
    trace's seconds go where the reference puts its compile time."""
    coll = collective_bytes(trace.collectives)
    rep = CellReport(
        arch=arch, shape=shape_name, mesh=mesh_name,
        flops_per_dev=float(trace.flops),
        bytes_per_dev=float(trace.bytes),
        coll_bytes_per_dev=float(coll["total"]),
        coll_detail=coll,
        model_flops_global=model_flops_global,
        arg_bytes=arg_bytes, temp_bytes=trace.peak, peak_bytes=arg_bytes + trace.peak,
        out_bytes=out_bytes, n_devices=n_devices, compile_s=compile_s,
    )
    rep.terms = roofline_terms(rep.flops_per_dev, rep.bytes_per_dev,
                               rep.coll_bytes_per_dev)
    return rep
