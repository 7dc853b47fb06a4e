"""Public decode-attention wrapper and its plain PyTorch version.

``decode_attention`` takes the reference's layout: q (B,H,hd), the
sequence-major cache k/v (B,T,KV,hd) and pos (B,), the last visible
position of each sequence.  For CUDA tensors it launches the hand-written
kernels of ``csrc/decode_attention.cu``, chosen by the input type:

* bf16 -> ``"mma"``: a split over T, then a combine; q kᵀ and P V on the
  tensor cores (``mma.sync``, bf16 operands, f32 accumulation), K/V tiles
  fed by ``cp.async``.  The one rounding the reference does not make is
  the probabilities P -> bf16 before P V.
* f32 -> ``"simt"``: one launch, f32 FMAs on the CUDA cores.  The route is
  bound by bytes (4 FLOPs a byte at most, against the CUDA cores' 20), so
  its design moves bytes: the visible rows spread evenly over one wave of
  blocks from ``pos`` on the card, K/V through a shared-memory ring, keys
  on lanes in q kᵀ (no shuffle chain a key), and the blocks that share a
  unit merged inside the launch, in a fixed order (outputs bit-identical
  from call to call).  The merge's counters live in a scratch the wrapper
  keeps per stream (``kernel._f32_scratch``).

Each launch counts in ``decode_attention.launches`` and in
``decode_attention.launches_by_route[route]``.  For CPU tensors it
computes ``reference_decode_attention`` and counts nothing.  It never falls
back from a kernel to another route or to the plain version.
"""

from __future__ import annotations

import torch

from .._grad import refuse_grad
from .kernel import launch_decode_attention

__all__ = ["decode_attention", "reference_decode_attention"]

NEG_INF = -2.3819763e38
HEAD_DIMS = (64, 128, 256)
ROUTES = {torch.bfloat16: "mma", torch.float32: "simt"}
_POS_DTYPES = (torch.int32, torch.int64)


def reference_decode_attention(q, k, v, pos, *, softcap: float = 0.0,
                               window: int = 0, scale: float | None = None):
    """Plain version, the reference's ``ref.reference_decode_attention``:
    q (B,H,hd); k, v (B,T,KV,hd); pos (B,) -> (B,H,hd), f32 math, output in
    q's dtype.  A row with no visible key averages v (the kernel gives 0)."""
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(b, kv, group, hd).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    kpos = torch.arange(t, device=q.device)[None, :]
    last = pos.to(q.device)[:, None]
    mask = kpos <= last
    if window:
        mask &= kpos > last - window
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v.float())
    return out.reshape(b, h, hd).to(q.dtype)


def _check(q, k, v, pos) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,hd) and k, v (B,T,KV,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, hd = q.shape
    bk, t, kv, hdk = k.shape
    if bk != b or hdk != hd or kv == 0 or h % kv or t == 0:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, k {tuple(k.shape)} "
                         "(want equal B and hd, and H a multiple of KV)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"want float32 or bfloat16 for all of q, k, v; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not isinstance(pos, torch.Tensor) or pos.shape != (b,) or pos.dtype not in _POS_DTYPES:
        raise TypeError(f"want pos an int32 or int64 tensor of shape ({b},)")
    for name, x in (("k", k), ("v", v), ("pos", pos)):
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")


def decode_attention(q, k, v, pos, *, softcap: float = 0.0, window: int = 0,
                     scale: float | None = None):
    """q: (B,H,hd); k, v: (B,T,KV,hd); pos: (B,) int -> (B,H,hd) in q's dtype.

    Key t of sequence b is visible when t <= pos[b] and, for window > 0,
    t > pos[b] - window.  CUDA tensors go through the kernel (hd in {64,
    128, 256}, bf16 -> "mma", f32 -> "simt", contiguous); CPU tensors
    through ``reference_decode_attention``."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    _check(q, k, v, pos)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return reference_decode_attention(q, k, v, pos, softcap=softcap, window=window,
                                          scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or CPU tensors, got {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    refuse_grad("decode_attention", q, k, v)
    pos32 = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    launch_decode_attention(q, k, v, pos32, out, window=window, softcap=softcap,
                            scale=scale)
    decode_attention.launches += 1
    decode_attention.launches_by_route[ROUTES[q.dtype]] += 1
    return out


decode_attention.launches = 0
decode_attention.launches_by_route = dict.fromkeys(ROUTES.values(), 0)
