"""AdamW (from scratch) with global-norm clipping and configurable moment
dtype, PyTorch port of ``repro.train.optimizer``.

The arithmetic is the reference's, in f32: the clip scale, the bias
corrections and each moment are computed in f32, and the moments are
stored in ``moment_dtype``.  Trees are nested dicts of tensors, walked in
sorted key order at every level, which is the order ``jax.tree.leaves``
gives, so ``global_norm`` sums the leaves as the reference does.

The reference's train step takes params and optimizer state by donation
(``repro.train.loop``: ``donate_argnums=(0, 1)``); the port's counterpart
is an update in place under ``torch.no_grad()``, so a step holds one copy
of each.  A leaf is updated a slice of its leading axis at a time, so the
f32 temporaries of a large leaf (gemma-2b's 524 M-element embedding:
2.1 GB each) stay small; the arithmetic is elementwise, so the result
does not depend on the slicing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .tree import tree_leaves, tree_map

__all__ = ["OptConfig", "init_opt", "apply_updates", "global_norm"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# elements a slice of a leaf holds at most while it is updated: 4 f32
# temporaries of 256 MB
_SLICE_ELEMENTS = 1 << 26


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def init_opt(params, cfg: OptConfig):
    dt = _DTYPES[cfg.moment_dtype]
    count = tree_leaves(params)[0].new_zeros((), dtype=torch.int32)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "count": count}


def _slices(*leaves):
    """Views of ``leaves`` (one shape) a slice of the leading axis at a
    time, each of at most ``_SLICE_ELEMENTS`` elements (one row at least);
    a 0-d leaf whole."""
    if leaves[0].dim() == 0:
        yield leaves
        return
    n = leaves[0].shape[0]
    step = max(1, _SLICE_ELEMENTS // max(leaves[0][0].numel(), 1))
    for lo in range(0, n, step):
        yield tuple(t[lo:lo + step] for t in leaves)


def global_norm(tree):
    total = 0
    for leaf in tree_leaves(tree):
        for (g,) in _slices(leaf):
            total = total + g.float().square().sum()
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptConfig):
    """Returns (params, state, grad_norm), ``params`` and ``state`` updated
    in place (the same dicts, the same tensors)."""
    gnorm = global_norm(grads)
    # a true f32 division (``number / tensor`` multiplies by the reciprocal)
    scale = torch.clamp_max(torch.full_like(gnorm, cfg.grad_clip) / (gnorm + 1e-12), 1.0)
    state["count"].add_(1)
    count = state["count"].float()
    c1 = 1.0 - torch.pow(torch.full_like(count, cfg.b1), count)
    c2 = 1.0 - torch.pow(torch.full_like(count, cfg.b2), count)

    def upd(p, g, m, v):
        g32 = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g32)
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - cfg.lr * step)
        m.copy_(m32)
        v.copy_(v32)

    for leaves in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                      tree_leaves(state["v"])):
        for views in _slices(*leaves):
            upd(*views)
    return params, state, gnorm
