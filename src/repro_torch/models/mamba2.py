"""Mamba2 / SSD (state-space duality) block — arXiv:2405.21060.  PyTorch
port of ``repro.models.mamba2``.

Chunked SSD forward for prefill (quadratic within a chunk, linear
recurrence across chunks) and an O(1)-per-token recurrent decode step.
As in the reference, the model path calls no kernel: the products are
``torch.einsum`` / ``torch.matmul``, and the ``ssd_scan`` kernel is reached
only through ``repro_torch.kernels``.

Math (per head h, state dim N):
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t  x_t^T      (A < 0 scalar/head)
    y_t = C_t . h_t + D x_t
Chunked over Q-length chunks with inclusive in-chunk log-decay cumsum
``cum``:
    y_intra[i] = sum_{j<=i} exp(cum_i - cum_j) (C_i.B_j) dt_j x_j
    y_inter[i] = exp(cum_i) C_i . h_chunk_start
    S_chunk    = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
    h_next     = exp(cum_last) h_prev + S_chunk
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.logical import splittable
from .layers import dense_init, rmsnorm, rmsnorm_init

__all__ = ["ssm_init", "ssm_dims", "ssm_forward", "ssm_decode", "init_ssm_state",
           "ssd_chunked"]

_F32, _F64 = np.float32, np.float64
_LOG_P = [_F32(c) for c in (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
                            -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
                            2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)]


def _fma(a, b, c):
    """float32 a * b + c rounded once (the f32 product is exact in f64)."""
    return (np.asarray(a, _F64) * np.asarray(b, _F64) + np.asarray(c, _F64)).astype(_F32)


def _log_f32(u: np.ndarray) -> np.ndarray:
    """float32 log of positive normal ``u`` as the reference computes
    ``jnp.log`` on the CPU (XLA's Cephes polynomial, evaluated in three
    parts with fused multiply-adds), so the port's ``A_log`` carries the
    reference's bits; a correctly rounded log differs from it by one ulp
    in about 6% of values."""
    m, e = np.frexp(np.asarray(u, _F32))
    m, e = m.astype(_F32), e.astype(_F32)
    low = m < _F32(0.707106781186547524)            # shift [0.5, 1) to [sqrt(1/2), sqrt(2))
    x = (m - _F32(1)) + np.where(low, m, _F32(0)).astype(_F32)
    e = e - low.astype(_F32)
    x2 = x * x
    x3 = x2 * x
    y = _fma(_fma(x, _LOG_P[0], _LOG_P[1]), x, _LOG_P[2])
    y1 = _fma(_fma(x, _LOG_P[3], _LOG_P[4]), x, _LOG_P[5])
    y2 = _fma(_fma(x, _LOG_P[6], _LOG_P[7]), x, _LOG_P[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _F32(-2.12194440e-4) * e)
    x = (x - x2 * _F32(0.5)) + y
    return x + _F32(0.693359375) * e


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_state
    return d_in, nh, conv_dim


def ssm_init(gen: torch.Generator, cfg: ModelConfig, dtype, *, groups: tuple = ()):
    """The reference's leaves, each with a leading ``groups`` shape.
    ``dt_bias``, ``A_log`` and ``D`` do not depend on ``gen``: they are the
    reference's numpy draws (``RandomState(0)`` and ``(1)``), equal in
    every group and to the reference's bit for bit."""
    d, ds = cfg.d_model, cfg.ssm_state
    d_in, nh, conv_dim = ssm_dims(cfg)
    dev = gen.device
    # dt bias: inverse-softplus of dt ~ U[1e-3, 1e-1] (mamba2 reference init)
    dt = np.exp(np.random.RandomState(0).uniform(np.log(1e-3), np.log(1e-1), nh))
    dt_bias = dt + np.log(-np.expm1(-dt))
    a_log = _log_f32(np.random.RandomState(1).uniform(1.0, 16.0, nh).astype(_F32))

    def per_head(values):
        return torch.as_tensor(values, dtype=torch.float32, device=dev).expand(
            *groups, nh).contiguous()

    return {
        "wz": dense_init(gen, (*groups, d, d_in), dtype),
        "wx": dense_init(gen, (*groups, d, d_in), dtype),
        "wB": dense_init(gen, (*groups, d, ds), dtype),
        "wC": dense_init(gen, (*groups, d, ds), dtype),
        "wdt": dense_init(gen, (*groups, d, nh), dtype),
        "dt_bias": per_head(dt_bias),
        "A_log": per_head(a_log),
        "D": per_head(np.ones(nh)),
        "conv_w": dense_init(gen, (*groups, cfg.ssm_conv_width, conv_dim), dtype, scale=0.1),
        "conv_b": torch.zeros((*groups, conv_dim), dtype=dtype, device=dev),
        "gate_norm": rmsnorm_init(d_in, dtype, dev, groups),
        "out": dense_init(gen, (*groups, d_in, d), dtype),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv via shifted sums. x: (B,L,C); w: (W,C)."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(width))
    return F.silu(out + b[None, None, :])


def _conv_tail(x, width):
    """Last (W-1) raw inputs — the decode-time conv state."""
    pad = F.pad(x, (0, 0, max(width - 1 - x.shape[1], 0), 0))
    return pad[:, -(width - 1):, :]


def _segsum_exp(cum):
    """exp(cum_i - cum_j) masked to i >= j. cum: (..., Q). -> (..., Q, Q).

    The masked entries' exponent is set to 0 before the exp, so their
    exp cannot overflow: the values are the reference's bit for bit, but
    the gradient stays finite.  The reference takes exp of every entry
    (``jnp.where(mask, jnp.exp(seg), 0)``); above the diagonal
    cum_i - cum_j is the decay of the positions between, which overflows
    once a chunk is long (mamba2-370m's 256), and the masked zero then
    meets exp's inf in the backward: 0 * inf, a NaN gradient."""
    q = cum.shape[-1]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=cum.device))
    seg = torch.where(mask, cum[..., :, None] - cum[..., None, :], 0.0)
    return torch.where(mask, torch.exp(seg), 0.0)


def ssd_chunked(x, dt, a, bmat, cmat, chunk: int, h0=None):
    """Chunked SSD scan (fp32 internals).

    x:    (B, L, nh, hd)   inputs
    dt:   (B, L, nh)       positive step sizes
    a:    (nh,)            negative decay rates (A = -exp(A_log))
    bmat: (B, L, N)        input  projections (G=1 group, shared over heads)
    cmat: (B, L, N)        output projections
    h0:   (B, nh, hd, N)   initial state (None -> zeros)
    Returns (y: (B,L,nh,hd), h_final: (B,nh,hd,N)).
    """
    bsz, length, nh, hd = x.shape
    n = bmat.shape[-1]
    if length % chunk:
        raise ValueError(f"length {length} is not a multiple of chunk {chunk}")
    nc = length // chunk
    xc = x.reshape(bsz, nc, chunk, nh, hd).float()
    dtc = dt.reshape(bsz, nc, chunk, nh).float()
    bc = bmat.reshape(bsz, nc, chunk, n).float()
    cc = cmat.reshape(bsz, nc, chunk, n).float()
    da = dtc * a[None, None, None, :]                      # (B,nc,Q,nh) log-decay
    cum = torch.cumsum(da, dim=2)                          # inclusive

    # Intra-chunk (the quadratic, attention-like term).
    decay = _segsum_exp(cum.movedim(-1, 2))                # (B,nc,nh,Q,Q)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)       # (B,nc,Q,Q)
    att = scores[:, :, None] * decay * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhd->bcihd", att, xc)

    # Chunk summary states.
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)         # (B,nc,Q,nh)
    s_chunk = torch.einsum("bcqh,bcqn,bcqhd->bchdn",
                           decay_out * dtc, bc, xc)        # (B,nc,nh,hd,N)
    total = torch.exp(cum[:, :, -1, :])                    # (B,nc,nh)

    # Inter-chunk recurrence (the reference's lax.scan over chunks); each
    # chunk reads the state *before* it.
    h = (torch.zeros((bsz, nh, hd, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = total[:, c, :, None, None] * h + s_chunk[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                  # (B,nc,nh,hd,N)

    y_inter = torch.einsum("bcqn,bchdn->bcqhd", cc, h_prevs) * \
        torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, length, nh, hd)
    return y.to(x.dtype), h


def ssm_forward(p, cfg: ModelConfig, x):
    """Full-sequence Mamba2 block. x: (B,L,D) -> (y, state_dict)."""
    d_in, nh, conv_dim = ssm_dims(cfg)
    hd, ds, width = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv_width
    z = x @ p["wz"]
    raw = torch.cat([x @ p["wx"], x @ p["wB"], x @ p["wC"]], dim=-1)
    conv_out = _causal_conv(raw, p["conv_w"], p["conv_b"])
    xs, bmat, cmat = torch.split(conv_out, [d_in, ds, ds], dim=-1)
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"][None, None, :])
    a = -torch.exp(p["A_log"])
    xh = splittable(xs, hd).reshape(*xs.shape[:-1], nh, hd)
    y, h_final = ssd_chunked(xh.float(), dt, a, bmat, cmat,
                             min(cfg.ssm_chunk, x.shape[1]))
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(*x.shape[:-1], d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    state = {"conv": _conv_tail(raw, width), "ssm": h_final.float()}
    return y @ p["out"], state


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device, *, groups: tuple = ()):
    d_in, nh, conv_dim = ssm_dims(cfg)
    return {
        "conv": torch.zeros((*groups, batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((*groups, batch, nh, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def ssm_decode(p, cfg: ModelConfig, x, state):
    """Single-token recurrent step. x: (B,1,D) -> (y: (B,1,D), new state).
    ``state`` is read, not written: the caller stores the new state."""
    d_in, nh, conv_dim = ssm_dims(cfg)
    hd, ds = cfg.ssm_head_dim, cfg.ssm_state
    b = x.shape[0]
    z = x @ p["wz"]                                         # (B,1,d_in)
    raw = torch.cat([x @ p["wx"], x @ p["wB"], x @ p["wC"]], dim=-1)
    window = torch.cat([state["conv"].to(raw.dtype), raw], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)[:, None, :]                 # (B,1,convdim)
    xs, bmat, cmat = torch.split(conv_out, [d_in, ds, ds], dim=-1)
    dt = F.softplus((x @ p["wdt"]).float() +
                    p["dt_bias"][None, None, :])[:, 0]      # (B,nh)
    a = -torch.exp(p["A_log"])
    xh = splittable(xs[:, 0], hd).reshape(b, nh, hd).float()
    decay = torch.exp(dt * a[None, :])                      # (B,nh)
    h = state["ssm"] * decay[..., None, None] + torch.einsum(
        "bh,bn,bhd->bhdn", dt, bmat[:, 0].float(), xh)
    y = torch.einsum("bn,bhdn->bhd", cmat[:, 0].float(), h)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(b, 1, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out"], {"conv": window[:, 1:, :], "ssm": h}
