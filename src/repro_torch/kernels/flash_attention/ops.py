"""Public flash-attention wrapper and its plain PyTorch version.

``flash_attention`` takes the model's layout, q (B,S,H,hd) and k/v
(B,T,KV,hd), like the reference's ``ops.flash_attention``.  For CUDA
tensors it launches the hand-written kernel (``csrc/flash_attention.cu``)
and counts the launch in ``flash_attention.launches``; for CPU tensors it
computes ``flash_attention_ref``.  It never falls back from the kernel to
the plain version.
"""

from __future__ import annotations

import torch

from .kernel import launch_flash_attention

__all__ = ["flash_attention", "flash_attention_ref"]

NEG_INF = -2.3819763e38
HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: float | None = None):
    """Plain version: the reference's ``ref.reference_attention`` in the
    model layout.  q: (B,S,H,hd); k, v: (B,T,KV,hd) -> (B,S,H,hd), f32 math,
    output in q's dtype."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = hd ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, s, kv, group, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
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
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
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
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
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

    CUDA tensors go through the kernel (hd in {64, 128, 256}, f32 or bf16,
    contiguous); CPU tensors through ``flash_attention_ref``."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    _check(q, k, v)
    out = torch.empty_like(q)
    launch_flash_attention(q, k, v, out, causal=causal, window=window,
                           softcap=softcap, scale=scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
