"""GPipe-style pipeline parallelism over a "pipe" mesh axis, PyTorch port
of ``repro.sharding.pipeline``.

The production mesh is DP×TP (16×16 / 2×16×16), so PP ships as an optional
substrate: ``gpipe`` runs a layer stack split into S = |pipe| stages over M
microbatches, the classic (M + S - 1)-step ramp and drain.  Each rank runs
its own stage, its coordinate on ``pipe_axis``: stage i holds layers
[i·L/S, (i+1)·L/S).  Activations stream stage to stage over the pipe
group's ring (``_ppermute``: ``batch_isend_irecv``, the reference's
``ppermute``), and an all-reduce brings the last stage's outputs to every
stage (the reference's final ``psum``).

The schedule is one ``torch.autograd.Function`` (``_GPipe``) with both
directions written out, so that every rank makes the same exchanges in the
same order: forward, the ramp and drain; backward, the same steps in
reverse, each stage recomputing its layers from its saved inputs and
sending the gradient of its input to the stage before.  (Left to autograd,
a rank would run the backward of only those exchanges its own loss
reaches, and its neighbours would wait for the others.)  The output is
replicated, and so is its gradient: the last stage takes it as it is.

A stage knows its coordinate, so its bubbles (steps with no microbatch)
run no layer, where the reference's SPMD body computes and masks them; a
bubble passes its input on, which no active stage reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.roofline.analysis import record_collective
from repro_torch.train.tree import tree_items, tree_unflatten

__all__ = ["gpipe"]


def _ppermute(x, group, shift: int):
    """Send ``x`` to the rank ``shift`` places on in ``group``'s ring and
    return what the rank ``shift`` places back sent."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    record_collective("collective-permute", x.numel() * x.element_size(), x.dtype)
    return out


def _ppermute(x, group, shift: int):
    """Send ``x`` to the rank ``shift`` places on in ``group``'s ring and
    return what the rank ``shift`` places back sent."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    record_collective("collective-permute", x.numel() * x.element_size(), x.dtype)
    return out


@dataclass(frozen=True)
class _Schedule:
    block_fn: object
    paths: tuple
    group: object
    s: int          # stages
    stage: int      # this rank's
    m: int          # microbatches
    per_stage: int  # layers a stage

    def run_stage(self, leaves, y):
        """This stage's layers on ``y``; ``leaves`` are the stage's slices."""
        for l in range(self.per_stage):
            y = self.block_fn(tree_unflatten(zip(self.paths, (p[l] for p in leaves))), y)
        return y

    def slices(self, leaves):
        lo = self.stage * self.per_stage
        return [p[lo:lo + self.per_stage] for p in leaves]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sch: _Schedule, xmb, *leaves):
        s, stage, m = sch.s, sch.stage, sch.m
        mine = sch.slices(leaves)
        carry = torch.zeros_like(xmb[0])
        outs = torch.zeros_like(xmb)
        inputs = {}
        for t in range(m + s - 1):
            mb = t - stage                      # microbatch at this stage
            inp = xmb[min(t, m - 1)] if stage == 0 else carry
            y = inp
            if 0 <= mb < m:
                inputs[t] = inp
                y = sch.run_stage(mine, inp)
                if stage == s - 1:
                    outs[mb] = y
            if s > 1:
                carry = _ppermute(y, sch.group, 1)
        if s > 1:
            # broadcast final outputs from the last stage to all stages
            dist.all_reduce(outs, group=sch.group)
            record_collective("all-reduce", outs.numel() * outs.element_size(), outs.dtype)
        ctx.sch, ctx.inputs = sch, inputs
        ctx.save_for_backward(*leaves)
        return outs

    @staticmethod
    def backward(ctx, gout):
        sch, inputs, leaves = ctx.sch, ctx.inputs, ctx.saved_tensors
        s, stage, m = sch.s, sch.stage, sch.m
        grads = [torch.zeros_like(p) for p in leaves]
        mine_grads = sch.slices(grads)
        gx = torch.zeros_like(gout)
        g_next = torch.zeros_like(gout[0])     # grad of this stage's input at t + 1
        for t in reversed(range(m + s - 1)):
            # forward step t sent y to the next stage, whose input at t + 1 it was
            g_y = _ppermute(g_next, sch.group, -1) if s > 1 else torch.zeros_like(g_next)
            mb = t - stage
            if 0 <= mb < m:
                if stage == s - 1:
                    g_y = g_y + gout[mb]
                with torch.enable_grad():
                    inp = inputs[t].detach().requires_grad_(True)
                    mine = [p.detach().requires_grad_(True) for p in sch.slices(leaves)]
                    y = sch.run_stage(mine, inp)
                    g = torch.autograd.grad(y, [inp, *mine], g_y, allow_unused=True)
                g_inp = g[0]
                for acc, gp in zip(mine_grads, g[1:]):
                    if gp is not None:
                        acc.add_(gp)
                if stage == 0:
                    gx[t] += g_inp
            else:
                g_inp = g_y                     # a bubble passed its input on
            # stage 0's input is the microbatch, not what the last stage sent
            g_next = torch.zeros_like(g_inp) if stage == 0 else g_inp
        return (None, gx, *grads)


def gpipe(block_fn, stacked_params, x, mesh, *, pipe_axis: str = "pipe",
          n_microbatches: int):
    """Run ``y = block_fn(params_l, y)`` for every layer l, pipelined.

    stacked_params: nested dict of tensors with leading layer dim L on
                    every leaf (L % n_stages == 0), the same on every rank;
    x: (B, ...) with B % n_microbatches == 0, the same on every rank.
    Returns y with x's shape, the same on every rank.  Differentiable: a
    rank's gradients are its own stage's share (its layers' slice of each
    leaf, and x on stage 0), zero elsewhere; their sum over the pipe group
    is the whole gradient.
    """
    names = tuple(mesh.mesh_dim_names)
    s = mesh.size(names.index(pipe_axis))
    m = n_microbatches
    b = x.shape[0]
    assert b % m == 0, (b, m)
    paths, leaves = zip(*tree_items(stacked_params))
    lead = leaves[0].shape[0]
    assert lead % s == 0, (lead, s)
    sch = _Schedule(block_fn, paths, mesh.get_group(pipe_axis), s,
                    mesh.get_local_rank(pipe_axis), m, lead // s)
    xmb = x.reshape((m, b // m) + x.shape[1:])
    return _GPipe.apply(sch, xmb, *leaves).reshape(x.shape)
