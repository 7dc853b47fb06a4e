"""Mixture-of-Experts FFN: top-k router + capacity-based scatter dispatch.
PyTorch port of ``repro.models.moe``, single-device path.

Dispatch (the reference's baseline): tokens are scattered into per-expert
buffers of capacity ``C = tokens*k/E * capacity_factor`` (GShard/Switch
style, "dropping": an assignment past its expert's capacity is dropped).
Slot positions come from a cumsum over the flat (T*k) assignment order,
token-major then rank, so which assignments drop depends on every token of
the call, as in the reference.  The scatter is static in shape: every one
of the T*k rows is added into a zeroed (E, C, D) buffer, a dropped row as
zeros, so no step waits on the host for a count.

The expert products are ``torch.bmm`` over the buffer, as the reference's
``jnp.einsum`` outside any kernel: ``moe.py`` has no Pallas kernel.

On DTensors (the dry run, a mesh) the buffers carry the reference's
``shard(..., ("expert", "expert_capacity", None))`` annotations and the
scatter runs replicated (``_dispatch``).  Not ported: the reference's
expert-parallel path (``_moe_shard_map``, ``_moe_sharding_ok``: ``shard_map``
with all-to-all exchanges behind the ``moe=shard_map`` rule).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.logical import shard
from .layers import dense_init, mlp_apply, mlp_init

__all__ = ["moe_init", "moe_apply"]


def _expert_leaf(gen: torch.Generator, groups: tuple, e: int, fan_in: int, fan_out: int,
                 dtype):
    """A ``(*groups, e, fan_in, fan_out)`` leaf drawn one expert at a time
    into its final dtype: a full-width leaf (dbrx-132b: 16 x 6144 x 10752 a
    group) then holds one expert's f32 temporary, not the whole leaf's."""
    leaf = torch.empty((*groups, e, fan_in, fan_out), dtype=dtype, device=gen.device)
    for w in leaf.view(-1, fan_in, fan_out):
        w.copy_(dense_init(gen, (fan_in, fan_out), dtype))
    return leaf


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, *, groups: tuple = ()):
    """The reference's leaves, each with a leading ``groups`` shape; the
    router stays f32 whatever ``dtype`` is."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": dense_init(gen, (*groups, d, e), torch.float32),
        "w_gate": _expert_leaf(gen, groups, e, d, f, dtype),
        "w_up": _expert_leaf(gen, groups, e, d, f, dtype),
        "w_down": _expert_leaf(gen, groups, e, f, d, dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, f * cfg.n_shared_experts, "swiglu", dtype,
                               groups=groups)
    return p


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest in descending order, the lower index
    first on a tie (a stable sort; ``torch.topk`` leaves ties unordered)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_logits(logits, k: int):
    """(probs (T,E), gate (T,k), idx (T,k)) from f32 router logits; the
    gates renormalised over the chosen k."""
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, idx


def _route(p, cfg: ModelConfig, xf):
    """Shared router math. xf: (T, D) -> (probs, gate (T,k), idx (T,k))."""
    return _route_logits(xf.float() @ p["router"], cfg.experts_per_token)


def _positions(idx, e: int):
    """Slot positions via cumsum over the flat (T*k,) assignment order:
    (one-hot assignments (T, k, E) in f32, positions (T*k,) int64).  The
    cumsum runs on integers, exact as the reference's f32 one is below
    2**24 assignments."""
    t, k = idx.shape
    flat = F.one_hot(idx.reshape(t * k), e)
    pos = ((flat.cumsum(0) - flat) * flat).sum(-1)
    return flat.reshape(t, k, e).float(), pos


def _capacity(cfg: ModelConfig, t: int) -> int:
    """Slots an expert holds for a call of ``t`` tokens (host arithmetic)."""
    return max(int(t * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor), 1)


def _expert_mlp(cfg: ModelConfig, p, buf):
    """Per-expert GLU MLP on a dispatch buffer (E, C, D)."""
    h_up = torch.bmm(buf, p["w_up"])
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = torch.bmm(buf, p["w_gate"])
        h = (F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(g, approximate="tanh")) * h_up
    else:
        h = F.gelu(h_up, approximate="tanh")
    return torch.bmm(h, p["w_down"])


def _dispatch(e: int, cap: int, eid, slot, contrib):
    """The (E, C, D) buffer with each row of ``contrib`` added at (eid, slot).
    DTensor has no sharding rule for ``index_put_(accumulate=True)``: on
    DTensors the operands come to Replicate (the all-gathers that costs are
    issued, as the reference's GSPMD lowers this scatter to full-buffer
    collectives), the local op runs, and the buffer is wrapped back,
    replicated."""
    if type(contrib) is not torch.Tensor:
        from torch.distributed.tensor import DTensor, Replicate

        mesh = contrib.device_mesh
        rep = [Replicate()] * mesh.ndim
        local = _dispatch(e, cap, *(t.redistribute(mesh, rep).to_local()
                                    for t in (eid, slot, contrib)))
        return DTensor.from_local(local, mesh, rep, run_check=False)
    buf = torch.zeros((e, cap, contrib.shape[-1]), dtype=contrib.dtype, device=contrib.device)
    return buf.index_put_((eid, slot), contrib, accumulate=True)


def moe_apply(p, cfg: ModelConfig, x):
    """x: (B, S, D) -> (y, aux_loss).  Top-k routing, renormalized weights."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d)

    probs, gate, idx = _route(p, cfg, xf)

    # Load-balancing aux loss (Switch §2.2): E * sum_e f_e * P_e.
    assign, pos = _positions(idx, e)
    f_e = assign.sum(dim=(0, 1)) / (t * k)
    p_e = probs.mean(dim=0)
    aux = e * (f_e * p_e).sum()

    # --- capacity-based scatter dispatch ---------------------------------
    cap = _capacity(cfg, t)
    eid = idx.reshape(t * k)
    keep = pos < cap
    slot = pos.clamp_max(cap - 1)
    xk = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    contrib = torch.where(keep[:, None], xk, 0).to(x.dtype)
    buf = shard(_dispatch(e, cap, eid, slot, contrib), ("expert", "expert_capacity", None))

    out_buf = shard(_expert_mlp(cfg, p, buf), ("expert", "expert_capacity", None))

    # --- combine ----------------------------------------------------------
    gathered = out_buf[eid, slot]                                  # (T*k, D)
    w = (gate.reshape(t * k) * keep).to(x.dtype)
    y = (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)

    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], xf, "swiglu")
    return y.reshape(b, s, d), aux
