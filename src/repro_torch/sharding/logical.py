"""Logical-axis sharding annotations (MaxText-style logical->physical
rules), PyTorch port of ``repro.sharding.logical``.

Model code annotates activations with *logical* axis names
(``shard(x, ("batch", None, "model"))``); the launcher installs a rule set
mapping logical names to physical mesh axes for the active parallelism
strategy.  Outside any rule context, or on a plain tensor, the annotations
are the identity (``shard`` returns ``x`` itself), so model code runs
unchanged on one device.  Inside one, ``shard`` redistributes a ``DTensor``
to the placements of the spec: the eager counterpart of the reference's
``with_sharding_constraint``, whose collectives DTensor issues there and
then.

The reference's thread-local ``attn`` rule is not read here: in the port
``Model(attn=...)`` picks the attention route.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["logical_axis_rules", "shard", "current_rules", "to_pspec", "splittable",
           "merge_last", "take_rows"]

_state = threading.local()


def current_rules():
    return getattr(_state, "rules", None), getattr(_state, "mesh", None)


@contextlib.contextmanager
def logical_axis_rules(mesh, rules: dict[str, tuple[str, ...] | str | None]):
    """rules: logical axis name -> physical mesh axis (or tuple, or None).

    Active while the step runs: wrap the call (``Cell.lower``)."""
    prev = current_rules()
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev


def to_pspec(spec: tuple, rules: dict) -> tuple:
    return tuple(None if ax is None else rules.get(ax) for ax in spec)


def _divisible(shape, pspec, mesh) -> bool:
    from repro_torch.launch.mesh import mesh_shape

    sizes = mesh_shape(mesh)
    for dim, ax in zip(shape, tuple(pspec) + (None,) * len(shape)):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = 1
        for a in axes:
            n *= sizes[a]
        if dim % n:
            return False
    return True


def shard(x, spec: tuple):
    """Redistribute a DTensor to ``spec``'s placements if logical rules are
    active; ``x`` itself otherwise."""
    rules, mesh = current_rules()
    if rules is None or mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    from .policy import to_placements

    if not isinstance(x, DTensor):
        return x
    pspec = to_pspec(spec, rules)
    if not _divisible(x.shape, pspec, mesh):
        return x  # replicate rather than force uneven sharding
    placements = to_placements(pspec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def splittable(x, inner: int, dim: int = -1):
    """``x`` ready for dim ``dim`` to be split into (-1, inner): a DTensor
    whose shards of that dim are not whole multiples of ``inner`` (8 heads
    of 256 over a 16-wide "model" axis) comes to Replicate along it first,
    as DTensor cannot unflatten an uneven shard (the all-gather is issued
    and counted); anything else is ``x`` itself."""
    if type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    mesh = x.device_mesh
    on_dim = [isinstance(p, Shard) and p.dim % x.ndim == dim for p in x.placements]
    n = 1
    for i, hit in enumerate(on_dim):
        n *= mesh.size(i) if hit else 1
    if x.shape[dim] % (n * inner) == 0:
        return x
    return x.redistribute(mesh, [Replicate() if hit else p
                                 for p, hit in zip(x.placements, on_dim)])


class _GradAsForward(torch.autograd.Function):
    """Identity; its backward brings the gradient to the placements the
    forward's output had."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements)


def merge_last(x):
    """``x`` (..., n, d) as (..., n·d) (attention heads into the output
    projection's input).  On a DTensor the gradient of the result comes
    back in the result's own placements, so the backward's split of it
    never meets a shard of the merged dim that is not whole rows of d (8
    heads over a 16-wide "model" axis)."""
    y = x.reshape(*x.shape[:-2], -1)
    return y if type(y) is torch.Tensor else _GradAsForward.apply(y)


def take_rows(table, ids):
    """``table[ids]``: rows of a 2-D table (an embedding).  On a DTensor
    table the port looks the rows up itself, as GSPMD's masked gather does
    the reference's.  On a mesh dim that shards the rows the ids come
    whole, each rank takes those inside its own block of rows (zero rows
    elsewhere), and the result is their sum (``Partial``); a dim that
    shards the columns keeps them sharded in the result, unless it shards
    the ids too, where the columns are gathered first (FSDP's gather on
    use).  DTensor's own rules for this lookup differ between torch
    releases, and one fails in the backward."""
    if type(table) is torch.Tensor:
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = table.device_mesh
    out_shape = (*ids.shape, table.shape[1])
    tp = list(table.placements)
    ip = list(ids.placements) if isinstance(ids, DTensor) else [Replicate()] * mesh.ndim
    op = list(ip)
    for i, p in enumerate(tp):
        if isinstance(p, Shard) and p.dim == 0:
            ip[i], op[i] = Replicate(), Partial()
        elif isinstance(p, Shard) and isinstance(ip[i], Shard):
            tp[i] = Replicate()
        elif isinstance(p, Shard):
            op[i] = Shard(len(out_shape) - 1)
    table = table.redistribute(mesh, tp)
    local_ids = ids.redistribute(mesh, ip).to_local() if isinstance(ids, DTensor) else ids
    shape, offset = compute_local_shape_and_global_offset(table.shape, mesh, table.placements)
    i = local_ids - offset[0]
    inside = (i >= 0) & (i < shape[0])
    rows = table.to_local()[i.clamp(0, shape[0] - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    stride = [1] * len(out_shape)
    for d in range(len(out_shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * out_shape[d + 1]
    return DTensor.from_local(rows, mesh, op, run_check=False, shape=out_shape,
                              stride=tuple(stride))
