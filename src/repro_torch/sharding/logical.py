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
           "query_split", "merge_last", "take_rows"]

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
    active; ``x`` itself otherwise.  A pending sum (``Partial``: a
    row-parallel projection's output) is reduced there, as GSPMD reduces
    it before the value's next use, also where a dim does not divide and
    the spec is not applied.  The gradient of that reduction comes back at
    the reduced placements, as ``with_sharding_constraint``'s transpose
    constrains the cotangent: DTensor's own backward would leave a
    ``Partial`` gradient as it is, and the projection's backward would
    then gather its weight whole."""
    rules, mesh = current_rules()
    if rules is None or mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    from .policy import to_placements

    if not isinstance(x, DTensor):
        return x
    pspec = to_pspec(spec, rules)
    if _divisible(x.shape, pspec, mesh):
        placements = to_placements(pspec, mesh)
    elif any(p.is_partial() for p in x.placements):
        placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    else:
        return x  # replicate rather than force uneven sharding
    if tuple(x.placements) == placements:
        return x
    if any(p.is_partial() for p in x.placements):
        return _GradAsForward.apply(x.redistribute(mesh, placements))
    return x.redistribute(mesh, placements)


def query_split(x, kv_heads: int):
    """The mesh dim over which attention on ``x`` (B, S, D) splits its
    queries' sequence, or None.  Inside rules, where the "model" mesh dim's
    n ranks do not divide the ``kv_heads`` (gemma-2b's one KV head of 8 query
    heads over 16): there DTensor cannot split a head group and gathers
    every head whole on each rank.  Each rank then takes S / n queries with
    all heads, which is 1/n of the scores, as GSPMD's split of the heads'
    columns gives the reference.  None also where n does not divide S (a
    decode step) or on a plain tensor."""
    rules, _ = current_rules()
    if rules is None or type(x) is torch.Tensor:
        return None
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return None
    names = x.device_mesh.mesh_dim_names or ()
    axis = rules.get("model")
    if not isinstance(axis, str) or axis not in names:
        return None
    d = names.index(axis)
    n = x.device_mesh.size(d)
    if n == 1 or kv_heads % n == 0 or x.shape[1] % n:
        return None
    return d


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
    use).  The lookup is one ``autograd.Function`` (``_TakeRows``) whose
    backward scatters the rank's gradient rows into its block of the
    table: the table's gradient is ``Partial`` on the mesh dims that split
    the ids over a whole (or gathered) table, each rank holding its ids'
    share, and placed as the table elsewhere.  DTensor's own rules for
    this lookup differ between torch releases: 2.11's backward of the
    column gather asks for a ``Shard(1)`` -> ``Partial`` it does not have,
    and a gradient brought back to ``Shard(1)`` meets the tied output
    head's ``Partial`` one in a sum that 2.11 cannot place either."""
    if type(table) is torch.Tensor:
        return table[ids]
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, table.device_mesh, [Replicate()] * table.device_mesh.ndim,
                                 run_check=False)
    return _TakeRows.apply(table, ids)


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        from .local import contiguous_stride

        mesh = table.device_mesh
        out_shape = (*ids.shape, table.shape[1])
        tp = list(table.placements)
        ip = list(ids.placements)
        op = list(ip)
        for i, p in enumerate(tp):
            if isinstance(p, Shard) and p.dim == 0:
                ip[i], op[i] = Replicate(), Partial()
            elif isinstance(p, Shard) and isinstance(ip[i], Shard):
                tp[i] = Replicate()
            elif isinstance(p, Shard):
                op[i] = Shard(len(out_shape) - 1)
        table = table.redistribute(mesh, tp)
        local_ids = ids.redistribute(mesh, ip).to_local()
        shape, offset = compute_local_shape_and_global_offset(table.shape, mesh, table.placements)
        i = local_ids - offset[0]
        inside = (i >= 0) & (i < shape[0])
        i = i.clamp(0, shape[0] - 1)
        rows = table.to_local()[i]
        rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        # the gradient's blocks: a rank's share of the sum where its ids are
        # a part of all (a mesh dim that splits them over a whole table)
        gp = [p if not isinstance(p, Replicate) else
              Partial() if isinstance(ip[k], Shard) else p for k, p in enumerate(tp)]
        ctx.save_for_backward(i, inside)
        ctx.mesh, ctx.gp = mesh, tuple(gp)
        ctx.op = tuple(Replicate() if isinstance(p, Partial) else p for p in op)
        ctx.table_shape, ctx.local_shape = tuple(table.shape), tuple(shape)
        return DTensor.from_local(rows, mesh, op, run_check=False, shape=out_shape,
                                  stride=contiguous_stride(out_shape))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor

        from .local import contiguous_stride

        i, inside = ctx.saved_tensors
        g = grad.redistribute(ctx.mesh, ctx.op).to_local()
        g = torch.where(inside[..., None], g, torch.zeros_like(g))
        block = g.new_zeros(ctx.local_shape).index_put_(
            (i.reshape(-1),), g.reshape(-1, g.shape[-1]), accumulate=True)
        return DTensor.from_local(block, ctx.mesh, ctx.gp, run_check=False,
                                  shape=ctx.table_shape,
                                  stride=contiguous_stride(ctx.table_shape)), None
