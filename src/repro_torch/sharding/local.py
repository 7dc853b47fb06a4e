"""Per-shard code over a ``DeviceMesh``: the port's counterpart of the
reference's ``shard_map`` (``repro.compat.shard_map`` with
``check_vma=False``).

A function written for one shard takes plain local tensors and talks to
the other shards through explicit collectives.  ``enter`` brings a
``DTensor`` to the placements of an input spec and hands back its local
shard; ``leave`` wraps a local result back into a ``DTensor``; ``psum``
and ``all_to_all`` are the reference's ``jax.lax.psum`` and tiled
``jax.lax.all_to_all`` over named mesh dims, on the ``_c10d_functional``
collectives (so ``roofline.CostTrace`` records them).

Gradients follow the rules of the reference's ``shard_map`` transpose, so
a train step differentiates through the per-shard code as ``jax.grad``
does through the reference's:

  - an output's gradient is divided by the number of ranks that hold it
    whole (the mesh dims its spec does not name, ``leave(scale=)``);
  - ``psum``'s backward is ``psum``, and ``all_to_all``'s is the inverse
    exchange;
  - an input's gradient is summed over the mesh dims its spec does not
    name (``enter(grad=)``: ``Partial`` there), then brought back to the
    placements the input came in with.

Each piece is an ``autograd.Function`` whose backward names its own
collectives: which redistributions DTensor's own autograd asks for differs
between torch releases (2.11 has no ``Shard`` -> ``Partial``).
"""

from __future__ import annotations

import torch

__all__ = ["enter", "leave", "psum", "all_to_all", "spec_grad", "replicated",
           "contiguous_stride"]


def contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _group(mesh, axis: str):
    return mesh.get_group(mesh_dim=axis)


def _wait(t):
    from torch.distributed._functional_collectives import AsyncCollectiveTensor

    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, placements, grad):
        ctx.mesh, ctx.src, ctx.grad = x.device_mesh, tuple(x.placements), grad
        ctx.shape = tuple(x.shape)
        local = x.redistribute(x.device_mesh, placements).to_local()
        return local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate

        gd = DTensor.from_local(g.contiguous(), ctx.mesh, ctx.grad, run_check=False,
                                shape=ctx.shape, stride=contiguous_stride(ctx.shape))
        # a Partial input was summed on entry: its gradient is the whole one
        # on every rank (DTensor's own rule; it refuses a move to Partial)
        src = tuple(Replicate() if p.is_partial() else p for p in ctx.src)
        return gd.redistribute(ctx.mesh, src), None, None


def replicated(t, mesh):
    """``t`` as a DTensor over ``mesh``: a plain tensor is taken as the
    whole value, held by every rank (``Replicate`` on each mesh dim)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def enter(x, placements, grad=None):
    """The local shard of DTensor ``x`` at ``placements`` (redistributed
    there first).  ``grad``: the placements the local gradient is read in
    (``Partial`` where each rank holds a share of it; default
    ``placements``); the gradient goes back to ``x``'s own placements."""
    placements = tuple(placements)
    return _Enter.apply(x, placements, tuple(grad) if grad is not None else placements)


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, placements, shape, scale):
        from torch.distributed.tensor import DTensor

        ctx.mesh, ctx.placements, ctx.scale = mesh, placements, scale
        return DTensor.from_local(local.view_as(local), mesh, placements, run_check=False,
                                  shape=shape, stride=contiguous_stride(shape))

    @staticmethod
    def backward(ctx, g):
        g = g.redistribute(ctx.mesh, ctx.placements).to_local()
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None, None, None


def leave(local, mesh, placements, shape, scale: float = 1.0):
    """``local`` (contiguous) as the shard of a DTensor of global ``shape``
    at ``placements``; its gradient's local shard is multiplied by
    ``scale``."""
    return _Leave.apply(local.contiguous(), mesh, tuple(placements), tuple(shape), float(scale))


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _psum(g.contiguous(), ctx.mesh, ctx.axes), None, None


def _psum(x, mesh, axes):
    import torch.distributed._functional_collectives as funcol

    for a in axes:
        x = _wait(funcol.all_reduce(x, "sum", _group(mesh, a)))
    return x


def psum(x, mesh, axes):
    """``jax.lax.psum(x, axes)``: the sum of ``x`` over the ranks of the
    named mesh dims (one all-reduce a dim); its backward is ``psum``."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return _Psum.apply(x.contiguous(), mesh, axes) if axes else x


def _exchange(x, mesh, axis: str, split_axis: int, concat_axis: int):
    import torch.distributed._functional_collectives as funcol

    n = mesh.size(mesh.mesh_dim_names.index(axis))
    shape = list(x.shape)
    # dim 0 the destination rank: (n, ..., shape[split] / n, ...)
    piece = shape[:split_axis] + [n, shape[split_axis] // n] + shape[split_axis + 1:]
    send = x.reshape(piece).movedim(split_axis, 0).contiguous()
    recv = _wait(funcol.all_to_all_single(send, None, None, _group(mesh, axis)))
    # dim 0 the source rank: joined in rank order along concat_axis
    shape_out = list(recv.shape[1:])
    shape_out[concat_axis] *= n
    return recv.movedim(0, concat_axis).reshape(shape_out)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = mesh, axis, concat_axis, split_axis
        return _exchange(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), *ctx.args), None, None, None, None


def all_to_all(x, mesh, axis: str, split_axis: int, concat_axis: int):
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over mesh dim ``axis``: ``x`` cut into n pieces along ``split_axis``,
    piece j sent to rank j, the pieces received joined in rank order along
    ``concat_axis``; one ``all_to_all_single``.  Its backward is the
    inverse exchange."""
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def spec_grad(placements, mesh, names) -> tuple:
    """Gradient placements of an input at ``placements`` whose spec names
    the mesh dims ``names``: ``Partial`` on every other mesh dim (each rank
    of it holds a share of the gradient), the placement itself on those."""
    from torch.distributed.tensor import Partial

    return tuple(p if d in names else Partial()
                 for d, p in zip(mesh.mesh_dim_names, placements))
