"""Train / serve step functions, PyTorch port of ``repro.train.steps``.

The reference's ``jax.value_and_grad`` becomes ``torch.autograd.grad``
over detached aliases of the parameter leaves (``_value_and_grad``): the
caller's tensors never require grad, so serving calls on the same
parameters build no graph, and the optimizer then updates the same
storage in place.  A leaf the loss does not reach gets a zero gradient,
as JAX gives.
"""

from __future__ import annotations

import torch

from repro_torch.models import Model
from .optimizer import OptConfig, apply_updates
from .tree import tree_items, tree_leaves, tree_unflatten

__all__ = ["make_loss_fn", "make_train_step", "make_prefill_step", "make_serve_step"]


def make_loss_fn(model: Model, *, remat: bool = True):
    cfg = model.cfg

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch, remat=remat)
        extra = cfg.frontend_len if cfg.frontend else 0
        logits = logits[:, extra:]
        labels = batch["labels"]
        # lse - gold in f32, as the reference.  Its gold is a one-hot
        # contraction (a gather along a vocab-sharded axis would make GSPMD
        # all-gather the logits); every other term of that contraction is
        # an exact zero, so the gather here gives the same value without a
        # (B, S, V) f32 one-hot.
        logits32 = logits.float()
        lse = torch.logsumexp(logits32, dim=-1)
        gold = _gold(logits32, labels.long())
        ce = (lse - gold).mean()
        loss = ce + cfg.router_aux_coef * aux["moe_aux"]
        return loss, {"ce": ce, "moe_aux": aux["moe_aux"]}

    return loss_fn


def _gold(logits, labels):
    """``logits[..., labels]``, a gather along the vocab axis.  On a DTensor
    each rank gathers the labels that fall in its own block of the vocab
    (0 elsewhere) and the gold logit is their sum over the vocab shards: the
    masked partial DTensor's own gather rule builds, whose reduction fails
    on this shape."""
    if type(logits) is torch.Tensor:
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, last = logits.device_mesh, logits.ndim - 1
    on_vocab = [isinstance(p, Shard) and p.dim == last for p in logits.placements]
    labels = labels.redistribute(mesh, [Replicate() if hit else p
                                        for p, hit in zip(logits.placements, on_vocab)])
    shape, offset = compute_local_shape_and_global_offset(logits.shape, mesh, logits.placements)
    lab = labels.to_local() - offset[-1]
    inside = (lab >= 0) & (lab < shape[-1])
    gold = torch.gather(logits.to_local(), -1, lab.clamp(0, shape[-1] - 1)[..., None])[..., 0]
    gold = torch.where(inside, gold, torch.zeros_like(gold))
    return DTensor.from_local(gold, mesh, [Partial() if hit else p
                                           for p, hit in zip(labels.placements, on_vocab)],
                              run_check=False, shape=labels.shape, stride=labels.stride())


def _value_and_grad(loss_fn, params, batch):
    """((loss, aux), grads): ``jax.value_and_grad(loss_fn, has_aux=True)``
    on a dict of tensors; grads in the parameters' dtypes."""
    paths, leaves = zip(*tree_items(params))
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, aux = loss_fn(tree_unflatten(zip(paths, live)), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), tree_unflatten(zip(paths, grads))


def make_train_step(model: Model, opt_cfg: OptConfig, *, remat: bool = True,
                    accum_steps: int = 1):
    """One optimizer step, ``params`` and ``opt_state`` updated in place.
    ``accum_steps > 1`` splits the global batch into contiguous
    microbatches and sums their gradients in f32, in order, as the
    reference's ``lax.scan`` does (each microbatch's backward frees before
    the next)."""
    loss_fn = make_loss_fn(model, remat=remat)

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            (loss, metrics), grads = _value_and_grad(loss_fn, params, batch)
        else:
            mb = {k: v.reshape((accum_steps, v.shape[0] // accum_steps) + v.shape[1:])
                  for k, v in batch.items()}
            gsum = None
            lsum = asum = torch.zeros((), dtype=torch.float32, device=model.device)
            ces = []
            for i in range(accum_steps):
                (l, mets), g = _value_and_grad(loss_fn, params,
                                               {k: v[i] for k, v in mb.items()})
                g = tree_leaves(g)
                gsum = ([x.float() for x in g] if gsum is None
                        else [a.add_(b.float()) for a, b in zip(gsum, g)])
                lsum = lsum + l
                asum = asum + mets["moe_aux"]
                ces.append(mets["ce"])
            paths = [path for path, _ in tree_items(params)]
            grads = tree_unflatten(zip(paths, [g / accum_steps for g in gsum]))
            loss = lsum / accum_steps
            metrics = {"ce": torch.stack(ces).mean(), "moe_aux": asum / accum_steps}
        params, opt_state, gnorm = apply_updates(params, grads, opt_state, opt_cfg)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step


def _argmax(logits):
    """argmax over the vocab axis (the last).  A DTensor's vocab shards are
    all-gathered first: DTensor's own argmax over a sharded dim fails where
    the rows are replicated over another mesh axis (a batch of one)."""
    if type(logits) is not torch.Tensor:
        from torch.distributed.tensor import Replicate, Shard

        last = logits.ndim - 1
        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == last else p
            for p in logits.placements])
    return torch.argmax(logits, dim=-1)


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        logits, cache = model.prefill(params, batch)
        next_tok = _argmax(logits[:, -1].float())
        return next_tok, logits, cache

    return prefill_step


def make_serve_step(model: Model):
    """One decode step: token in, token out, cache updated in place."""

    def serve_step(params, tokens, cache, pos):
        logits, cache = model.decode_step(params, tokens, cache, pos)
        next_tok = _argmax(logits.float())
        return next_tok, cache

    return serve_step
