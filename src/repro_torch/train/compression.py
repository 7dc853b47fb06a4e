"""Per-tensor int8 quantization for gradient compression, PyTorch port of
``repro.train.compression``'s math.

``quantize_int8`` maps a tensor to int8 with one f32 scale (max|x| / 127),
rounding to nearest (half to even, as ``jnp.round``) or, given a
``torch.Generator``, stochastically (floor(y + U[0, 1)), unbiased), in
place of the reference's jax key.

Not ported: ``compressed_psum_int8`` and ``make_dp_grad_fn``, the
reference's int8 all-gather over a data axis inside ``shard_map``.  They
are collectives across devices and have no meaning on one; they wait for
the port's mesh.
"""

from __future__ import annotations

import torch

__all__ = ["quantize_int8", "dequantize_int8"]


def quantize_int8(x, generator: torch.Generator | None = None):
    """Per-tensor symmetric int8 with optional stochastic rounding."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().max(), 1e-20) / 127.0
    y = x32 / scale
    if generator is not None:
        y = torch.floor(y + torch.rand(y.shape, generator=generator, device=y.device))
    else:
        y = torch.round(y)
    return torch.clamp(y, -127, 127).to(torch.int8), scale


def dequantize_int8(q, scale):
    return q.float() * scale
