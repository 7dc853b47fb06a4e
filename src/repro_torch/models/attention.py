"""Attention: MHA/GQA/MQA, causal + local-window, softcap, KV-cache decode.
PyTorch port of ``repro.models.attention``.

The attention route is an explicit argument, ``impl``, that the ``Model``
fixes at construction (the reference reads a thread-local ``attn`` rule
while tracing; eager PyTorch would read it on every call, from whichever
poller thread pumps the engine):

  None       straightforward masked sdpa (the reference's default)
  "chunked"  online-softmax over KV chunks (the reference's ``chunked``)
  "kernel"   the hand-written flash-attention kernel (the reference's
             ``pallas``); on CPU tensors its plain version

Layouts as in the reference: activations (B,S,H,hd), caches (B,T,KV,hd),
weights (in, out) used as ``x @ w``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.sharding.logical import merge_last, splittable
from .layers import apply_rope, dense_init, rmsnorm, rmsnorm_init, softcap

__all__ = ["ATTN_IMPLS", "attn_init", "attn_apply", "attn_prefill", "attn_decode",
           "init_kv_cache"]

NEG_INF = -2.3819763e38  # bf16-safe large negative
ATTN_IMPLS = (None, "chunked", "kernel")


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype, *, cross: bool = False,
              groups: tuple = ()):
    """A cross-attention block (``cross``) gives K and V ``n_heads`` heads,
    as the reference's does, whatever ``n_kv_heads`` is."""
    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads, (cfg.n_heads if cross else cfg.n_kv_heads)
    p = {
        "wq": dense_init(gen, (*groups, cfg.d_model, h * hd), dtype),
        "wk": dense_init(gen, (*groups, cfg.d_model, kv * hd), dtype),
        "wv": dense_init(gen, (*groups, cfg.d_model, kv * hd), dtype),
        "wo": dense_init(gen, (*groups, h * hd, cfg.d_model), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, gen.device, groups)
        p["k_norm"] = rmsnorm_init(hd, dtype, gen.device, groups)
    return p


def _project_qkv(p, cfg: ModelConfig, xq, xkv):
    hd = cfg.resolved_head_dim
    q = splittable(xq @ p["wq"], hd).reshape(*xq.shape[:-1], -1, hd)
    k = splittable(xkv @ p["wk"], hd).reshape(*xkv.shape[:-1], -1, hd)
    v = splittable(xkv @ p["wv"], hd).reshape(*xkv.shape[:-1], -1, hd)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _sdpa(cfg: ModelConfig, q, k, v, mask, *, k_scale=None, v_scale=None):
    """q: (B,S,H,hd); k,v: (B,T,KV,hd); mask: (B,1,1,S,T) or None.

    k_scale/v_scale: (B,T,KV) dequant scales for int8 KV — they factor out
    of the contraction over hd (k) and fold into probs (v), so no
    dequantized cache is materialized.
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    groups = h // kv
    qg = splittable(q, groups, 2).reshape(b, s, kv, groups, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(q.dtype)).float()
    if k_scale is not None:
        logits = logits * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    logits = logits * hd ** -0.5
    if cfg.attn_softcap:
        logits = softcap(logits, cfg.attn_softcap)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    probs = probs.to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(q.dtype))
    return out.reshape(b, s, h, hd)


def _sdpa_chunked(cfg: ModelConfig, q, k, v, *, causal: bool, window: int,
                  chunk: int = 1024):
    """Flash-style online-softmax attention: a loop over KV chunks, never
    materializing the (S, T) score matrix.  Returns None when T is not a
    multiple of the chunk (the caller falls back)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    ck = min(chunk, t)
    if t % ck:
        return None
    f32 = torch.float32
    qg = splittable(q, g, 2).reshape(b, s, kvh, g, hd).float() * hd ** -0.5
    qpos = torch.arange(s, device=q.device)
    m = torch.full((b, kvh, g, s), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, kvh, g, s), dtype=f32, device=q.device)
    acc = torch.zeros((b, kvh, g, s, hd), dtype=f32, device=q.device)
    for j in range(t // ck):
        kj = k[:, j * ck:(j + 1) * ck].float()
        vj = v[:, j * ck:(j + 1) * ck].float()
        logits = torch.einsum("bskgd,bckd->bkgsc", qg, kj)
        if cfg.attn_softcap:
            logits = softcap(logits, cfg.attn_softcap)
        kpos = j * ck + torch.arange(ck, device=q.device)
        mask = torch.ones((s, ck), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgsc,bckd->bkgsd", p, vj)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    out = out.movedim(-2, 1).reshape(b, s, h, hd)
    return out.to(q.dtype)


def _attention(cfg: ModelConfig, q, k, v, mask, *, causal: bool, window: int,
               impl: str | None):
    """Dispatch on ``impl`` (see the module docstring); the conditions are
    the reference's, so the same shapes reach the kernel."""
    if impl == "chunked" and causal:
        out = _sdpa_chunked(cfg, q, k, v, causal=causal, window=window)
        if out is not None:
            return out
    if impl == "kernel" and causal:
        s, t = q.shape[1], k.shape[1]
        bq, bk = min(512, s), min(512, t)
        if s % bq == 0 and t % bk == 0:
            return flash_attention(q, k, v, causal=True, window=window,
                                   softcap=cfg.attn_softcap)
    return _sdpa(cfg, q, k, v, mask)


def _causal_mask(s: int, t: int, q_offset, local_window: int, device=None):
    """(s,t) bool mask; q position i attends kv position j<=i (+window)."""
    qpos = torch.arange(s, device=device) + q_offset
    kpos = torch.arange(t, device=device)
    m = kpos[None, :] <= qpos[:, None]
    if local_window:
        m &= kpos[None, :] > qpos[:, None] - local_window
    return m


def attn_apply(p, cfg: ModelConfig, x, positions, *, local: bool = False,
               causal: bool = True, xkv=None, impl: str | None = None):
    """Full-sequence attention (train / encoder / cross).  ``causal=False``
    attends every position (the encoder; no mask); ``xkv`` is the memory
    that keys and values come from (cross-attention; RoPE only when the
    keys come from ``x`` itself).  As in the reference, only a causal call
    takes ``impl``'s route: the encoder and cross-attention always run the
    plain sdpa."""
    xkv = x if xkv is None else xkv
    q, k, v = _project_qkv(p, cfg, x, xkv)
    if cfg.use_rope and xkv is x:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    mask = None
    window = cfg.local_window if local else 0
    if causal:
        mask = _causal_mask(x.shape[1], xkv.shape[1], 0, window, x.device)[None, None, None]
    out = _attention(cfg, q, k, v, mask, causal=causal, window=window, impl=impl)
    return merge_last(out) @ p["wo"]


# ---------------------------------------------------------------------------
# KV-cache paths
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
                  *, local: bool = False, groups: tuple = ()):
    hd = cfg.resolved_head_dim
    if local and cfg.kv_ring and cfg.local_window:
        max_len = min(max_len, cfg.local_window)
    shape = (*groups, batch, max_len, cfg.n_kv_heads, hd)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv(x):
    """x: (..., hd) -> (int8 codes, per-row scale)."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1) / 127.0
    scale = torch.clamp_min(scale, 1e-20)
    codes = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return codes, scale


def attn_prefill(p, cfg: ModelConfig, x, positions, *, local: bool = False,
                 impl: str | None = None):
    """Like attn_apply but also returns the cache entry for decode."""
    q, k, v = _project_qkv(p, cfg, x, x)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.local_window if local else 0
    mask = _causal_mask(x.shape[1], x.shape[1], 0, window, x.device)[None, None, None]
    out = _attention(cfg, q, k, v, mask, causal=True, window=window, impl=impl)
    y = merge_last(out) @ p["wo"]
    if cfg.kv_quant:
        k8, ks = _quantize_kv(k)
        v8, vs = _quantize_kv(v)
        return y, {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
    return y, {"k": k, "v": v}


def _write_rows(cache, bi, pos, value):
    """``cache[bi, pos] = value`` in place, ``bi`` = arange(B): one row a
    sequence.  On a DTensor cache (DTensor has no rule for ``index_put_``)
    each rank writes into its own block: its batch rows, each at its
    position where that lies in the rank's part of the sequence, the
    others rewritten with what they hold."""
    if type(cache) is torch.Tensor:
        cache[bi, pos] = value
        return
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = cache.device_mesh
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh, cache.placements)

    def rows(x):
        """x's rows of this rank's batch block, replicated first."""
        if isinstance(x, DTensor):
            x = x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        return x[offset[0]:offset[0] + shape[0]]

    local = cache.to_local()
    t = rows(pos) - offset[1]
    inside = (t >= 0) & (t < shape[1])
    b, t = torch.arange(shape[0], device=local.device), t.clamp(0, shape[1] - 1)
    inside = inside.view(-1, *([1] * (local.dim() - 2)))
    local[b, t] = torch.where(inside, rows(value), local[b, t])


def attn_decode(p, cfg: ModelConfig, x, cache, pos, *, local: bool = False):
    """Single-token decode. x: (B,1,D); pos: (B,) int; cache k/v (B,T,KV,hd).

    Returns (y, cache).  Unlike the reference, which returns a new cache,
    the port writes the new token's KV into ``cache`` in place (a
    per-sequence scatter, so ragged batches work).  Supports int8 caches
    (cfg.kv_quant) and ring-buffer local-window caches (cfg.kv_ring: cache
    length == window, writes at pos % window).
    """
    b = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, x)                   # q: (B,1,H,hd)
    if cfg.use_rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    bi = torch.arange(b, device=x.device)
    t = cache["k"].shape[1]
    ring = local and cfg.kv_ring and cfg.local_window and t == cfg.local_window
    wpos = pos % t if ring else pos
    scales = {}
    if cfg.kv_quant:
        k8, ks = _quantize_kv(k[:, 0])
        v8, vs = _quantize_kv(v[:, 0])
        _write_rows(cache["k"], bi, wpos, k8)
        _write_rows(cache["v"], bi, wpos, v8)
        _write_rows(cache["k_scale"], bi, wpos, ks)
        _write_rows(cache["v_scale"], bi, wpos, vs)
        scales = {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}
    else:
        _write_rows(cache["k"], bi, wpos, k[:, 0].to(cache["k"].dtype))
        _write_rows(cache["v"], bi, wpos, v[:, 0].to(cache["v"].dtype))
    kpos = torch.arange(t, device=x.device)[None, :]      # (1,T)
    if ring:
        # every slot holds the latest position congruent to it (<= pos);
        # before the window fills, only slots <= pos are valid.  Stored k
        # carry their absolute-position RoPE, so order doesn't matter.
        mask = (kpos <= pos[:, None]) | (pos[:, None] >= t)
    else:
        mask = kpos <= pos[:, None]
        if local and cfg.local_window:
            mask &= kpos > (pos[:, None] - cfg.local_window)
    out = _sdpa(cfg, q, cache["k"], cache["v"], mask[:, None, None, None, :],
                k_scale=scales.get("k_scale"), v_scale=scales.get("v_scale"))
    y = out.reshape(b, 1, -1) @ p["wo"]
    return y, cache
