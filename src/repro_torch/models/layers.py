"""Shared neural net layers (functional, dict params), PyTorch port of
``repro.models.layers``.

Weights are ``(in, out)`` matrices used as ``x @ w``, as in the reference.
Initializers draw from an explicit ``torch.Generator`` on the generator's
device; the numbers differ from ``jax.random`` for the same seed, so tests
carry the reference's parameters across with ``models.convert``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "dense_init", "rmsnorm_init", "rmsnorm", "softcap", "rope_freqs",
    "apply_rope", "mlp_init", "mlp_apply", "embed_init",
]


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=gen.device)


def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None):
    """Lecun-normal by fan-in (first dim for (in, out) matrices; the
    second-to-last for stacked ``(G, in, out)`` leaves)."""
    fan_in = shape[0] if len(shape) == 2 else shape[-2]
    std = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    return (_normal(gen, shape) * std).to(dtype)


def embed_init(gen: torch.Generator, vocab, d, dtype):
    return (_normal(gen, (vocab, d)) * 0.02).to(dtype)


def rmsnorm_init(d, dtype, device=None, groups: tuple = ()):
    return torch.ones((*groups, d), dtype=dtype, device=device)


def rmsnorm(x, scale, eps: float):
    """Multiplies by ``scale`` (not ``1 + scale``), in f32 inside."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def softcap(x, cap: float):
    """gemma2-style logit soft capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def apply_rope(x, positions, theta: float):
    """Half-split RoPE.  x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    ang = positions.float()[..., None] * freqs                       # (..., S, hd/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (dense FFN): swiglu / geglu / gelu
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str,
             dtype, groups: tuple = ()):
    p = {"w_up": dense_init(gen, (*groups, d_model, d_ff), dtype),
         "w_down": dense_init(gen, (*groups, d_ff, d_model), dtype)}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (*groups, d_model, d_ff), dtype)
    return p


def mlp_apply(p, x, mlp_type: str):
    up = x @ p["w_up"]
    if mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * up
    elif mlp_type == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * up
    elif mlp_type == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return h @ p["w_down"]
