"""Public flash-attention wrapper and its plain PyTorch version.

``flash_attention`` takes the model's layout, q (B,S,H,hd) and k/v
(B,T,KV,hd), like the reference's ``ops.flash_attention``.  For CUDA
tensors it launches one of the two hand-written kernels of
``csrc/flash_attention.cu``, chosen by the input type:

* bf16 -> ``"wgmma"``: both products on the tensor cores (bf16 operands,
  f32 accumulation), tiles fed by TMA.  The one rounding the reference
  does not make is the probabilities P -> bf16 before P V.  At hd 128 from
  384 q rows on the entry point launches ``flash_fwd_pingpong_bf16`` (128
  q rows a work item, two consumer warpgroups in ping-pong, 128-key tiles,
  one persistent block an SM), otherwise ``flash_fwd_wgmma_bf16`` (64 rows
  a block, 64-key tiles).
* f32 -> ``"mma"``: both products on the tensor cores as split TF32
  (``mma.sync``): each f32 operand is hi + lo, hi rounded to TF32, and each
  product hi.hi + hi.lo + lo.hi, the passes summed from zero over short
  steps (16 deep in q k^T, a tile's keys in P V) and added in f32.  One
  TF32 pass keeps about three decimal digits and would miss the
  reference's 2e-5; the split meets it.

Each launch counts in ``flash_attention.launches``, in
``flash_attention.launches_by_route[route]`` and in
``flash_attention.launches_by_kernel[kernel]``.  For CPU tensors it computes
``flash_attention_ref`` and counts nothing.  It never falls back from a
kernel to another route or to the plain version.  The kernels have no
backward: on CUDA tensors a call under grad mode with an input that
requires grad raises.
"""

from __future__ import annotations

import torch

from .._grad import refuse_grad
from .kernel import BF16_KERNELS, bf16_rows, launch_flash_attention

__all__ = ["flash_attention", "flash_attention_ref"]

NEG_INF = -2.3819763e38
HEAD_DIMS = (64, 128, 256)
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "mma"}
KERNELS = (*BF16_KERNELS.values(), "flash_fwd_mma_f32")


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: float | None = None):
    """Plain version: the reference's ``ref.reference_attention`` in the
    model layout.  q: (B,S,H,hd); k, v: (B,T,KV,hd) -> (B,S,H,hd), f32 math
    (f64 for f64 inputs), output in q's dtype."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = hd ** -0.5 if scale is None else scale
    math = torch.promote_types(q.dtype, torch.float32)
    qg = q.to(math).reshape(b, s, kv, group, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(math)) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(math))
    return out.reshape(b, s, h, hd).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,hd) and k, v (B,T,KV,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    bk, t, kv, hdk = k.shape
    if bk != b or hdk != hd or kv == 0 or h % kv or s == 0 or t == 0:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"want float32 or bfloat16 for all of q, k, v; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None):
    """q: (B,S,H,hd); k, v: (B,T,KV,hd) -> (B,S,H,hd) in q's dtype.

    CUDA tensors go through the kernel of their type's route (hd in
    {64, 128, 256}, bf16 -> "wgmma", f32 -> "mma", contiguous); CPU
    tensors through ``flash_attention_ref``."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    _check(q, k, v)
    refuse_grad("flash_attention", q, k, v)
    out = torch.empty_like(q)
    launch_flash_attention(q, k, v, out, causal=causal, window=window,
                           softcap=softcap, scale=scale)
    flash_attention.launches += 1
    flash_attention.launches_by_route[ROUTES[q.dtype]] += 1
    b, s, h, hd = q.shape
    kernel = (BF16_KERNELS[bf16_rows(b, s, h, hd)] if q.dtype == torch.bfloat16
              else "flash_fwd_mma_f32")
    flash_attention.launches_by_kernel[kernel] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES.values(), 0)
flash_attention.launches_by_kernel = dict.fromkeys(KERNELS, 0)
