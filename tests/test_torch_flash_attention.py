"""The port's flash attention against the JAX package's: the same numpy
inputs through JAX ``flash_attention`` (the Pallas kernel in interpret
mode) and the port's wrapper, which on CPU tensors computes its plain
version.  Sweep and tolerances are those of tests/test_kernels.py (f32
2e-5, bf16 2e-2).  Both routes' arithmetic is emulated here and held
against the same JAX kernel: bf16 operands on the tensor cores with P
rounded to bf16 before P V, and f32 as split TF32 on its tile sizes (also
against an f64 reference).  The kernels themselves run only on a card:
their test is marked ``gpu`` and skips here."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(seed, shapes, dtype):
    """Same values for both packages: f32 numpy normals, cast by each."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(x).astype(jdt) for x in xs],
            [torch.from_numpy(x).to(tdt) for x in xs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,hd,bq,bk", [
    (1, 128, 4, 4, 64, 64, 64),       # MHA
    (2, 256, 8, 2, 64, 128, 64),      # GQA 4:1
    (1, 192, 4, 1, 128, 64, 96),      # MQA, uneven blocks
    (1, 64, 2, 2, 256, 64, 64),       # gemma-style hd=256
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_kernel(dtype, b, s, h, kv, hd, bq, bk, causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        hash((b, s, h, kv, hd, causal)) % 2**31,
        [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)], dtype)
    ref = jax_flash_attention(jq, jk, jv, causal=causal, block_q=bq, block_k=bk)
    out = flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("window,softcap", [(32, 0.0), (0, 20.0), (64, 30.0)])
def test_flash_attention_window_and_softcap_match_jax(window, softcap):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        7, [(2, 128, 4, 64), (2, 128, 2, 64), (2, 128, 2, 64)], "float32")
    ref = jax_flash_attention(jq, jk, jv, window=window, softcap=softcap,
                              block_q=64, block_k=32)
    out = flash_attention(tq, tk, tv, window=window, softcap=softcap)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["float32"])


def test_flash_attention_matches_jax_model_sdpa():
    """The port's kernel route agrees with the reference model's _sdpa
    (the path it replaces), as tests/test_kernels.py holds the Pallas
    kernel (3e-5 there)."""
    from repro.configs import get_config
    from repro.models import attention as A

    cfg = get_config("gemma2-2b").reduced()
    b, s, h, kv, hd = 2, 64, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        3, [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)], "float32")
    mask = A._causal_mask(s, s, 0, 0)[None, None, None]
    ref = A._sdpa(cfg, jq, jk, jv, mask)
    out = flash_attention(tq, tk, tv, causal=True, softcap=cfg.attn_softcap)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=3e-5, atol=3e-5)


NEG_INF = -2.3819763e38
LOG2E = 1.4426950408889634


# (q rows a block, keys a K/V tile) of the bf16 route's two kernels
WGMMA_TILES = (64, 64)        # flash_fwd_wgmma_bf16
PINGPONG_TILES = (128, 128)   # flash_fwd_pingpong_bf16 (hd 128)
PP_MIN_S = 384                # csrc/flash_attention.cu: the ping-pong kernel from this S on


def _bf16_tiles(s, hd):
    """The tiles of the bf16 kernel that ``flash_attention_fwd`` launches at
    this shape (the source's ``bf16_rows``, pinned by
    ``test_bf16_kernel_rule_is_the_sources``)."""
    return PINGPONG_TILES if hd == 128 and s >= PP_MIN_S else WGMMA_TILES


def _wgmma_emulation(q, k, v, *, causal, window, softcap, tiles=WGMMA_TILES):
    """The bf16 route's arithmetic on the CPU, tile by tile as its kernel
    walks it: ``tiles`` = (q rows a block, keys a tile) against K/V tiles
    from the first one the block's rows can see, f32 logits from the bf16
    operands, scale, softcap and mask, an online softmax in log2 units, P
    rounded to bf16 before P V, f32 accumulators, and 0 for a row that sees
    no key (the l == 0 guard).  The ping-pong kernel forms the same exponent
    as s sl - m sl in one fma (sl = scale log2(e)), a rounding apart."""
    rows, keys = tiles
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // kv, dim=2)
    vf = v.float().repeat_interleave(h // kv, dim=2)
    scale = hd ** -0.5
    out = torch.zeros(b, s, h, hd)
    for q0 in range(0, s, rows):
        qf = q[:, q0:q0 + rows].float()
        qpos = torch.arange(q0, q0 + qf.shape[1])[:, None]
        k_lo = max(0, q0 - window + 1) if window else 0
        k_hi = min(t, q0 + rows) if causal else t
        m = torch.full((b, h, qf.shape[1]), NEG_INF)
        l = torch.zeros(b, h, qf.shape[1])
        acc = torch.zeros(b, h, qf.shape[1], hd)
        for k0 in range(k_lo // keys * keys, k_hi, keys):
            x = torch.einsum("bshd,bthd->bhst", qf, kf[:, k0:k0 + keys]) * scale
            if softcap:
                x = softcap * torch.tanh(x / softcap)
            kpos = torch.arange(k0, k0 + x.shape[-1])[None, :]
            ok = torch.ones(x.shape[-2:], dtype=torch.bool)
            if causal:
                ok &= kpos <= qpos
            if window:
                ok &= kpos > qpos - window
            x = torch.where(ok, x * LOG2E, NEG_INF)
            m_new = torch.maximum(m, x.amax(-1))
            p = torch.where(ok, torch.exp2(x - m_new[..., None]), 0.0)
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhst,bthd->bhsd", p.bfloat16().float(), vf[:, k0:k0 + keys])
            m = m_new
        l = torch.where(l == 0, 1.0, l)
        out[:, q0:q0 + rows] = (acc / l[..., None]).permute(0, 2, 1, 3)
    return out.to(q.dtype)


WGMMA_CASES = [
    *[(*shape, causal, 0, 0.0)
      for shape in ((1, 128, 4, 4, 64, 64, 64), (2, 256, 8, 2, 64, 128, 64),
                    (1, 192, 4, 1, 128, 64, 96), (1, 64, 2, 2, 256, 64, 64))
      for causal in (True, False)],
    (2, 128, 4, 2, 64, 64, 32, True, 32, 0.0),     # the reference's window/softcap cases
    (2, 128, 4, 2, 64, 64, 32, True, 0, 20.0),
    (2, 128, 4, 2, 64, 64, 32, True, 64, 30.0),
    (1, 100, 4, 2, 64, 100, 100, True, 0, 0.0),    # ragged: rows past S and T
    (1, 192, 8, 2, 128, 64, 96, True, 100, 0.0),   # a window that cuts tiles
]


@pytest.mark.parametrize("b,s,h,kv,hd,bq,bk,causal,window,softcap", WGMMA_CASES)
def test_wgmma_arithmetic_matches_jax_kernel(b, s, h, kv, hd, bq, bk, causal, window,
                                             softcap):
    """Rounding P to bf16 is the one step the reference's kernel does not
    take; with it the bf16 route stays inside the reference's 2e-2."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        hash((b, s, h, kv, hd, causal, window)) % 2**31,
        [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)], "bfloat16")
    ref = jax_flash_attention(jq, jk, jv, causal=causal, window=window, softcap=softcap,
                              block_q=bq, block_k=bk)
    out = _wgmma_emulation(tq, tk, tv, causal=causal, window=window, softcap=softcap)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["bfloat16"])


# hd-128 cases for both walks: GQA groups 4 and 12, a ragged S, a window
# of 100 that cuts a 128-key tile, and S=16 (b, s, h, kv, hd, bq, bk,
# causal, window, softcap)
HD128_CASES = [
    (1, 256, 8, 2, 128, 128, 128, True, 0, 0.0),      # GQA group 4
    (1, 256, 12, 1, 128, 128, 128, True, 0, 0.0),     # GQA group 12
    (1, 200, 8, 2, 128, 100, 100, True, 0, 0.0),      # ragged: rows past S and T
    (1, 384, 4, 1, 128, 128, 128, True, 100, 0.0),    # a window that cuts 128-key tiles
    (1, 16, 8, 2, 128, 16, 16, True, 0, 0.0),         # S=16
    (2, 256, 4, 2, 128, 128, 64, True, 64, 30.0),     # window and softcap, batch 2
]


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("tiles,b,s,h,kv,hd,bq,bk,causal,window,softcap", [
    *[(PINGPONG_TILES, *case) for case in WGMMA_CASES],
    *[(tiles, *case) for case in HD128_CASES for tiles in (WGMMA_TILES, PINGPONG_TILES)],
])
def test_bf16_walks_match_jax_kernel(tiles, b, s, h, kv, hd, bq, bk, causal, window,
                                     softcap):
    """The ping-pong kernel's tile walk (128 q rows x 128 keys) on the 64x64
    walk's cases, and both walks on the hd-128 cases, keep the bf16 route
    inside the reference's 2e-2 of the Pallas kernel: which keys share a
    tile moves only the rounding of P and the order of the sums."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        hash((b, s, h, kv, hd, causal, window, softcap)) % 2**31,
        [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)], "bfloat16")
    ref = jax_flash_attention(jq, jk, jv, causal=causal, window=window, softcap=softcap,
                              block_q=bq, block_k=bk)
    out = _wgmma_emulation(tq, tk, tv, causal=causal, window=window, softcap=softcap,
                           tiles=tiles)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["bfloat16"])


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("s", [16, 128, 512])
@pytest.mark.parametrize("h,kv", [(8, 2), (12, 1)])
def test_served_bf16_walk_matches_jax_kernel(s, h, kv):
    """The walk the entry point picks at each hd-128 prefill length (the
    64-row kernel below ``PP_MIN_S`` rows, the ping-pong kernel from it on)
    against the Pallas kernel, GQA groups 4 and 12 with heads cut down."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        s + 7 * h, [(1, s, h, 128), (1, s, kv, 128), (1, s, kv, 128)], "bfloat16")
    ref = jax_flash_attention(jq, jk, jv, causal=True, block_q=min(s, 128),
                              block_k=min(s, 128))
    out = _wgmma_emulation(tq, tk, tv, causal=True, window=0, softcap=0.0,
                           tiles=_bf16_tiles(s, 128))
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["bfloat16"])


def test_bf16_kernel_rule_is_the_sources():
    """``_bf16_tiles`` mirrors the source's rule: the ping-pong kernel's
    tiles, its threshold and the expression that picks it."""
    from repro_torch.kernels import _build

    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["PP_MIN_S"]) == PP_MIN_S
    assert (int(consts["PP_ROWS"]), int(consts["PP_KEYS"])) == PINGPONG_TILES
    assert (int(consts["BQ"]), int(consts["BK"])) == WGMMA_TILES
    assert "return hd == 128 && S >= PP_MIN_S ? PP_ROWS : BQ;" in src
    assert fa_kernel.BF16_KERNELS == {64: "flash_fwd_wgmma_bf16",
                                      128: "flash_fwd_pingpong_bf16"}
    assert [_bf16_tiles(s, hd) for s, hd in ((16, 128), (383, 128), (384, 128), (4096, 128),
                                             (1024, 64), (1024, 256))] == [
        WGMMA_TILES, WGMMA_TILES, PINGPONG_TILES, PINGPONG_TILES, WGMMA_TILES, WGMMA_TILES]


def _tf32(v, rounded=True):
    """v onto TF32's 10 mantissa bits: rounded to nearest, ties away from
    zero (cvt.rna), or truncated, as the tensor cores read an f32 register."""
    bits = v.contiguous().view(torch.int32)
    return (((bits + 0x1000) if rounded else bits) & ~0x1FFF).view(torch.float32)


def _split(v):
    """v = hi + lo: hi rounded to TF32, lo the rest as the tensor cores read
    it (truncated)."""
    hi = _tf32(v)
    return hi, _tf32(v - hi, rounded=False)


def _steps(a, b, depth):
    """a @ b over the last axis of a as the f32 route runs it: for every
    ``depth``-deep step, hi.lo + lo.hi, then + hi.hi (lo.lo dropped),
    summed from zero in f32, and each step's sum added to the running sum
    in f32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    out = None
    for k0 in range(0, a.shape[-1], depth):
        k = slice(k0, k0 + depth)
        d = (ah[..., k] @ bl[..., k, :] + al[..., k] @ bh[..., k, :]) + ah[..., k] @ bh[..., k, :]
        out = d if out is None else out + d
    return out


MQ = 32   # the f32 route's q rows a tile


def _mma_f32_emulation(q, k, v, *, causal, window, softcap):
    """The f32 route's arithmetic on the CPU, tile by tile as the kernel
    walks it: 32 q rows against K/V tiles of 64 keys from the first
    visible one; split-TF32 logits (the passes of every 16-deep step
    of hd summed from zero), scale, softcap and mask, an online softmax in
    natural units, and a split-TF32 P V whose passes over the tile's keys
    start from zero and meet O as O corr + d; a row that sees no key gives 0
    (the l == 0 guard)."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // kv, dim=2).permute(0, 2, 3, 1)   # b h d t
    vf = v.float().repeat_interleave(h // kv, dim=2).permute(0, 2, 1, 3)   # b h t d
    scale = hd ** -0.5
    bkt = 64
    out = torch.zeros(b, s, h, hd)
    for q0 in range(0, s, MQ):
        qf = q[:, q0:q0 + MQ].float().permute(0, 2, 1, 3)                  # b h r d
        rows = qf.shape[2]
        qpos = torch.arange(q0, q0 + rows)[:, None]
        k_lo = max(0, q0 - window + 1) if window else 0
        k_hi = min(t, q0 + MQ) if causal else t
        m = torch.full((b, h, rows), NEG_INF)
        l = torch.zeros(b, h, rows)
        acc = torch.zeros(b, h, rows, hd)
        for ka in range(k_lo // bkt * bkt, k_hi, bkt):
            kb = min(ka + bkt, t)     # keys past T: zeros in the kernel, masked
            x = _steps(qf, kf[..., ka:kb], 16) * scale
            if softcap:
                x = softcap * torch.tanh(x / softcap)
            kpos = torch.arange(ka, kb)[None, :]
            ok = torch.ones(x.shape[-2:], dtype=torch.bool)
            if causal:
                ok &= kpos <= qpos
            if window:
                ok &= kpos > qpos - window
            x = torch.where(ok, x, NEG_INF)
            m_new = torch.maximum(m, x.amax(-1))
            p = torch.where(ok, torch.exp(x - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _steps(p, vf[:, :, ka:kb], bkt)
            m = m_new
        inv = 1.0 / torch.where(l == 0, 1.0, l)
        out[:, q0:q0 + MQ] = (acc * inv[..., None]).permute(0, 2, 1, 3)
    return out.to(q.dtype)


MMA_CASES = [
    *[(*shape, causal, 0, 0.0)
      for shape in ((1, 128, 4, 4, 64, 64, 64), (2, 256, 8, 2, 64, 128, 64),
                    (1, 192, 4, 1, 128, 64, 96), (1, 64, 2, 2, 256, 64, 64))
      for causal in (True, False)],
    (2, 128, 4, 2, 64, 64, 32, True, 32, 0.0),     # the reference's window/softcap cases
    (2, 128, 4, 2, 64, 64, 32, True, 0, 20.0),
    (2, 128, 4, 2, 64, 64, 32, True, 64, 30.0),
    (1, 100, 4, 2, 64, 100, 100, True, 0, 0.0),    # ragged: rows past S and T
    (1, 200, 2, 1, 256, 100, 100, True, 40, 0.0),  # hd 256, tiles cut by a window
    (1, 160, 4, 4, 128, 32, 32, False, 50, 10.0),  # a window and a softcap without causal
]


@pytest.fixture
def one_thread():
    """The emulations' small tensors gain nothing from intra-op threads;
    one keeps a parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("b,s,h,kv,hd,bq,bk,causal,window,softcap", MMA_CASES)
def test_mma_f32_arithmetic_matches_jax_kernel(b, s, h, kv, hd, bq, bk, causal, window,
                                               softcap):
    """Split TF32 with the passes of every 16-deep step of S (and of each
    64-key tile of P V) added in f32, on the kernel's 32-row q tiles and
    64-key K/V tiles, stays inside the reference's f32 2e-5."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        hash((b, s, h, kv, hd, causal, window)) % 2**31,
        [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)], "float32")
    ref = jax_flash_attention(jq, jk, jv, causal=causal, window=window, softcap=softcap,
                              block_q=bq, block_k=bk)
    out = _mma_f32_emulation(tq, tk, tv, causal=causal, window=window, softcap=softcap)
    assert out.dtype == torch.float32 and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["float32"])


def _attention_f64(q, k, v, *, causal, softcap):
    """The plain version's math in float64, written out apart from the
    port's ``flash_attention_ref``."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    kd, vd = (x.double().repeat_interleave(h // kv, dim=2) for x in (k, v))
    x = torch.einsum("bshd,bthd->bhst", q.double(), kd) * hd ** -0.5
    if softcap:
        x = softcap * torch.tanh(x / softcap)
    if causal:
        x = x.masked_fill(torch.arange(t)[None, :] > torch.arange(s)[:, None], -torch.inf)
    return torch.einsum("bhst,bthd->bshd", torch.softmax(x, dim=-1), vd).numpy()


def test_plain_version_computes_in_f64_for_f64_inputs():
    """``flash_attention_ref`` keeps f64 inputs in f64 (the card's check of
    a softcap that binds holds the f32 route against it), and matches the
    attention written out here."""
    _, (tq, tk, tv) = _inputs(7, [(1, 96, 4, 64), (1, 96, 2, 64), (1, 96, 2, 64)], "float32")
    q, k, v = (32 * tq).double(), tk.double(), tv.double()
    out = flash_attention_ref(q, k, v, causal=True, softcap=50.0)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), _attention_f64(q, k, v, causal=True, softcap=50.0),
                               rtol=1e-12, atol=1e-12)


F64_CASES = [*[(hd, causal, softcap) for hd in (64, 128, 256)
               for causal, softcap in ((True, 0.0), (False, 0.0), (False, 20.0))],
             (256, True, 50.0)]
F64_MAX_FACTOR = 1.25   # hd 64, not causal, softcap 20: 4.80e-7 against 4.22e-7


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("hd,causal,softcap", F64_CASES)
def test_mma_f32_arithmetic_is_no_further_from_f64_than_the_jax_kernel(hd, causal, softcap):
    """Against the attention in f64, the route's output is on average no
    further off than the reference kernel's (f32 products and sums), and
    its largest error is within ``F64_MAX_FACTOR`` of the kernel's: at a
    few elements a split-TF32 sum lands further from f64 than the f32 one
    (1.14x at hd 64, not causal, softcap 20), while its mean is 22-53%
    below over these cases."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        hd + causal, [(1, 256, 4, hd), (1, 256, 2, hd), (1, 256, 2, hd)], "float32")
    exact = _attention_f64(tq, tk, tv, causal=causal, softcap=softcap)
    ref = jax_flash_attention(jq, jk, jv, causal=causal, softcap=softcap, block_q=64,
                              block_k=64)
    out = _mma_f32_emulation(tq, tk, tv, causal=causal, window=0, softcap=softcap)
    err = np.abs(_np(out).astype(np.float64) - exact)
    err_jax = np.abs(np.asarray(ref, np.float64) - exact)
    assert err.max() <= F64_MAX_FACTOR * err_jax.max(), (err.max(), err_jax.max())
    assert err.mean() <= err_jax.mean(), (err.mean(), err_jax.mean())


def test_routes_by_dtype_and_cpu_calls_count_nothing():
    """bf16 goes to the wgmma kernel (dtype code 1), f32 to the split-TF32
    mma.sync kernel (code 0); a CPU call computes the plain version and
    leaves every counter at 0."""
    assert fa_ops.ROUTES == {torch.bfloat16: "wgmma", torch.float32: "mma"}
    assert {fa_ops.ROUTES[d]: fa_kernel._DTYPE_CODE[d] for d in fa_ops.ROUTES} == {
        "wgmma": 1, "mma": 0}
    assert flash_attention.launches_by_route == {"wgmma": 0, "mma": 0}
    for dtype in ("bfloat16", "float32"):
        (_, _, _), (tq, tk, tv) = _inputs(
            13, [(1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)], dtype)
        out = flash_attention(tq, tk, tv, window=16, softcap=10.0)
        assert torch.equal(out, flash_attention_ref(tq, tk, tv, window=16, softcap=10.0))
    assert flash_attention.launches == 0
    assert flash_attention.launches_by_route == {"wgmma": 0, "mma": 0}


def test_cpu_calls_count_no_kernel():
    """The per-kernel counter names the three kernels and a CPU call moves
    none of them."""
    assert tuple(flash_attention.launches_by_kernel) == fa_ops.KERNELS == (
        "flash_fwd_wgmma_bf16", "flash_fwd_pingpong_bf16", "flash_fwd_mma_f32")
    before = dict(flash_attention.launches_by_kernel)
    for dtype in ("bfloat16", "float32"):
        (_, _, _), (tq, tk, tv) = _inputs(
            17, [(1, 256, 4, 128), (1, 256, 2, 128), (1, 256, 2, 128)], dtype)
        flash_attention(tq, tk, tv)
    assert flash_attention.launches_by_kernel == before == dict.fromkeys(fa_ops.KERNELS, 0)


def test_flash_attention_on_cpu_is_the_plain_version_and_counts_nothing():
    (_, _, _), (tq, tk, tv) = _inputs(
        11, [(1, 32, 4, 64), (1, 32, 2, 64), (1, 32, 2, 64)], "float32")
    before = flash_attention.launches
    out = flash_attention(tq, tk, tv, window=8, softcap=10.0)
    ref = flash_attention_ref(tq, tk, tv, window=8, softcap=10.0)
    assert torch.equal(out, ref)
    assert flash_attention.launches == before == 0


def test_cpu_path_stays_differentiable():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 16, n, 64, generator=gen) for n in (4, 2, 2))
    q.requires_grad_(True)
    flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape and torch.isfinite(q.grad).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype):
    """Both routes (bf16 -> wgmma, f32 -> mma) at ragged S, windows that
    cut tiles, a softcap that binds (q scaled by 32) and a batch stride."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = DTYPES[dtype][1]
    route = fa_ops.ROUTES[tdt]
    gen = torch.Generator(cuda_device).manual_seed(0)
    for b, s, h, kv, hd, window, cap, q_scale in (
            (1, 100, 4, 2, 64, 0, 0.0, 1.0), (1, 192, 4, 1, 128, 100, 0.0, 1.0),
            (1, 256, 8, 1, 256, 0, 0.0, 1.0), (1, 512, 8, 4, 128, 64, 50.0, 1.0),
            (1, 512, 8, 4, 256, 256, 50.0, 32.0), (2, 192, 8, 2, 64, 0, 0.0, 1.0)):
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=cuda_device)
                   for n in (h, kv, kv))
        q, k, v = (q_scale * q).to(tdt), k.to(tdt), v.to(tdt)
        before = flash_attention.launches
        before_route = flash_attention.launches_by_route[route]
        out = flash_attention(q, k, v, causal=True, window=window, softcap=cap)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert flash_attention.launches_by_route[route] == before_route + 1
        ref = flash_attention_ref(q, k, v, causal=True, window=window, softcap=cap)
        np.testing.assert_allclose(_np(out.cpu()), _np(ref.cpu()), **TOL[dtype])


@pytest.mark.gpu
def test_pingpong_kernel_matches_plain_version_on_card(cuda_device):
    """The hd-128 bf16 kernels on the card, each counted under its name:
    the ping-pong kernel from ``PP_MIN_S`` rows on (a ragged S, a window
    that cuts 128-key tiles, a batch stride, GQA groups 4 and 12), the
    64-row kernel below, both within the reference's 2e-2."""
    gen = torch.Generator(cuda_device).manual_seed(2)
    for b, s, h, kv, window in ((1, 400, 8, 2, 0), (1, 1024, 32, 8, 300), (2, 512, 32, 8, 0),
                                (1, 1024, 48, 4, 0), (1, 16, 32, 8, 0), (1, 200, 8, 2, 0)):
        q, k, v = (torch.randn(b, s, n, 128, generator=gen, device=cuda_device).bfloat16()
                   for n in (h, kv, kv))
        name = fa_kernel.BF16_KERNELS[_bf16_tiles(s, 128)[0]]
        before = flash_attention.launches_by_kernel[name]
        out = flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        assert flash_attention.launches_by_kernel[name] == before + 1
        ref = flash_attention_ref(q, k, v, causal=True, window=window)
        np.testing.assert_allclose(_np(out.cpu()), _np(ref.cpu()), **TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_refuses_grad_on_card(cuda_device, dtype):
    """No backward kernel: under grad mode an input that requires grad
    raises instead of giving an output that autograd cannot see into."""
    tdt = DTYPES[dtype][1]
    gen = torch.Generator(cuda_device).manual_seed(1)
    q, k, v = (torch.randn(1, 64, n, 64, generator=gen, device=cuda_device).to(tdt)
               for n in (4, 2, 2))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v, causal=True)
    with torch.no_grad():
        out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
