"""The port's decode attention against the JAX package's: the same numpy
inputs through JAX ``decode_attention`` (the Pallas kernel in interpret
mode) and the port's wrapper, which on CPU tensors computes its plain
version.  Sweep and tolerances are those of tests/test_kernels.py (f32
2e-5, bf16 2e-2).  The bf16 kernel's arithmetic (the "mma" route: bf16
operands on the tensor cores, P rounded to bf16 before P V, warps that
split each tile's keys, pieces merged by the combine) is emulated here and
held against the same JAX kernel.  The kernels themselves run only on a
card: their test is marked ``gpu`` and skips here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.decode_attention import (
    reference_decode_attention as jax_reference_decode_attention,
)
from repro_torch.kernels import decode_attention, reference_decode_attention
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.kernel import piece_len

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(seed, b, h, kv, hd, t, dtype, pos=None, q_scale=1.0):
    """q, k, v (f32 numpy normals, q times ``q_scale``, cast by each
    package) and pos, for both."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((b, h, hd), (b, t, kv, hd), (b, t, kv, hd))]
    xs[0] *= np.float32(q_scale)
    p = rng.integers(0, t, b) if pos is None else np.asarray(pos)
    p = p.astype(np.int32)
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(x).astype(jdt) for x in xs] + [jnp.asarray(p)],
            [torch.from_numpy(x).to(tdt) for x in xs] + [torch.from_numpy(p)])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,hd,t,bk", [
    (2, 4, 4, 64, 256, 64),
    (3, 8, 2, 64, 512, 128),
    (1, 4, 1, 128, 256, 256),
])
def test_decode_attention_matches_jax_kernel(dtype, b, h, kv, hd, t, bk):
    jx, tx = _inputs(hash((b, h, kv, hd, t)) % 2**31, b, h, kv, hd, t, dtype)
    ref = jax_decode_attention(*jx, block_k=bk)
    out = decode_attention(*tx)
    assert out.dtype == tx[0].dtype and out.shape == tx[0].shape
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])


def test_decode_attention_ragged_positions_match_jax():
    """Each sequence has its own length; pos=0 attends to kv row 0 only."""
    b, h, kv, hd, t = 4, 4, 2, 64, 128
    jx, tx = _inputs(11, b, h, kv, hd, t, "float32", pos=[0, 1, 63, 127])
    ref = jax_decode_attention(*jx, block_k=32)
    out = decode_attention(*tx)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["float32"])
    got = _np(out[0]).reshape(kv, h // kv, hd)
    for g in range(kv):
        np.testing.assert_allclose(got[g], np.broadcast_to(_np(tx[2][0, 0, g]), got[g].shape),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [16, 64])
def test_decode_attention_local_window_matches_jax(window):
    jx, tx = _inputs(13, 2, 4, 4, 64, 128, "float32", pos=[100, 127])
    ref = jax_decode_attention(*jx, window=window, block_k=32)
    out = decode_attention(*tx, window=window)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["float32"])


def test_decode_attention_softcap_matches_jax():
    """q is scaled so that the logits (std 32) reach past the softcap."""
    jx, tx = _inputs(17, 2, 8, 4, 128, 256, "float32", q_scale=32.0)
    ref = jax_decode_attention(*jx, softcap=50.0, block_k=64)
    out = decode_attention(*tx, softcap=50.0)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["float32"])
    uncapped = decode_attention(*tx)
    assert np.abs(_np(uncapped) - _np(out)).max() > 0.1


def test_decode_attention_gemma_2b_heads_match_jax():
    """gemma-2b's heads (H=8, one KV head, hd=256) in bf16."""
    jx, tx = _inputs(19, 2, 8, 1, 256, 512, "bfloat16", pos=[511, 200])
    ref = jax_decode_attention(*jx, block_k=128)
    out = decode_attention(*tx)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["bfloat16"])


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (32, 30.0)])
def test_reference_decode_attention_matches_jax_reference(window, softcap):
    jx, tx = _inputs(23, 3, 8, 2, 64, 128, "float32")
    ref = jax_reference_decode_attention(*jx, window=window, softcap=softcap)
    out = reference_decode_attention(*tx, window=window, softcap=softcap)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["float32"])


def test_decode_attention_on_cpu_is_the_plain_version_and_counts_nothing():
    _, (q, k, v, pos) = _inputs(29, 2, 4, 2, 64, 64, "float32")
    before = decode_attention.launches
    out = decode_attention(q, k, v, pos.long(), window=8, softcap=10.0)
    ref = reference_decode_attention(q, k, v, pos, window=8, softcap=10.0)
    assert torch.equal(out, ref)
    assert decode_attention.launches == before == 0


@pytest.mark.parametrize("b,h,kv,t,piece", [
    (4, 8, 1, 2048, 64),      # gemma-2b decode: 128 blocks even at 64 positions
    (4, 8, 4, 8192, 512),     # gemma2-2b local layer
    (4, 8, 2, 8192, 256),     # kernels_bench's shape
    (1, 32, 1, 64, 64),       # four groups of 8 query heads, one piece
])
def test_piece_len_is_the_longest_that_fills_the_sms(b, h, kv, t, piece):
    assert piece_len(b, h, kv, t, 132) == piece


NEG_INF = -2.3819763e38
LOG2E = 1.4426950408889634
TILE, WARPS = 64, 4          # rows per shared-memory tile; warps that split them


def _mma_emulation(q, k, v, pos, *, window, softcap, piece):
    """The bf16 "mma" route's arithmetic on the CPU, as its two kernels walk
    it.  Split: a piece of ``piece`` positions keeps its visible rows
    [lo, hi) and walks them in 64-row tiles from lo; each of 4 warps takes
    16 rows of every tile and keeps its own online softmax in log2 units
    (f32 logits from the bf16 operands, scale, softcap, rows past hi
    masked, P rounded to bf16 before P V, f32 accumulators).  One merge over
    the warps gives the piece's (m, l, acc), m back in natural units; a
    piece with nothing visible is neutral.  Combine: the pieces that are not
    neutral, merged, divided by l (1 where l == 0, so a row that sees no key
    gives 0)."""
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    kf = k.float().repeat_interleave(h // kv, dim=2)
    vf = v.float().repeat_interleave(h // kv, dim=2)
    out = torch.zeros(b, h, hd)
    for bi in range(b):
        p = int(pos[bi])
        qf = q[bi].float()
        parts = []
        for base in range(0, t, piece):
            lo = max(p - window + 1 if window else 0, base)
            hi = min(p + 1, t, base + piece)
            if lo >= hi:
                continue
            warps = []
            for w in range(WARPS):
                m, l, acc = torch.full((h,), NEG_INF), torch.zeros(h), torch.zeros(h, hd)
                for t0 in range(lo, hi, TILE):
                    rows = torch.arange(t0 + 16 * w, t0 + 16 * w + 16)
                    ok = rows < hi             # rows past hi arrive as zeros
                    rows = rows.clamp(max=t - 1)
                    x = torch.einsum("hd,rhd->hr", qf, kf[bi, rows]) * scale
                    if softcap:
                        x = softcap * torch.tanh(x / softcap)
                    x = torch.where(ok, x * LOG2E, NEG_INF)
                    m_new = torch.maximum(m, x.amax(-1))
                    pr = torch.where(ok, torch.exp2(x - m_new[:, None]), 0.0)
                    corr = torch.exp2(m - m_new)
                    l = l * corr + pr.sum(-1)
                    acc = acc * corr[:, None] + torch.einsum(
                        "hr,rhd->hd", pr.bfloat16().float(), vf[bi, rows] * ok[:, None, None])
                    m = m_new
                warps.append((m, l, acc))
            ms = torch.stack([w[0] for w in warps])
            c = torch.exp2(ms - ms.amax(0))
            parts.append((ms.amax(0) / LOG2E, (c * torch.stack([w[1] for w in warps])).sum(0),
                          (c[..., None] * torch.stack([w[2] for w in warps])).sum(0)))
        if parts:
            ms = torch.stack([pt[0] for pt in parts])
            c = torch.exp(ms - ms.amax(0))
            big_l = (c * torch.stack([pt[1] for pt in parts])).sum(0)
            acc = (c[..., None] * torch.stack([pt[2] for pt in parts])).sum(0)
            out[bi] = acc / torch.where(big_l == 0, 1.0, big_l)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("b,h,kv,hd,t,bk,pos,window,softcap,q_scale", [
    (2, 4, 4, 64, 256, 64, None, 0, 0.0, 1.0),       # the bf16 sweep of the reference's tests
    (3, 8, 2, 64, 512, 128, None, 0, 0.0, 1.0),
    (1, 4, 1, 128, 256, 256, None, 0, 0.0, 1.0),
    (4, 4, 2, 64, 128, 32, (0, 1, 63, 127), 0, 0.0, 1.0),   # ragged pos, pos = 0
    (2, 4, 4, 64, 128, 32, (100, 127), 16, 0.0, 1.0),       # windows
    (2, 4, 4, 64, 128, 32, (100, 127), 64, 0.0, 1.0),
    (2, 8, 4, 128, 256, 64, None, 0, 50.0, 32.0),    # logits (std 32) past the softcap
    (2, 16, 1, 64, 192, 64, (191, 70), 0, 0.0, 1.0),  # 16 heads a group: two head chunks
    (2, 8, 2, 128, 200, 40, (199, 130), 0, 0.0, 1.0),  # T not a multiple of 64
    (2, 8, 1, 256, 512, 128, (511, 200), 0, 0.0, 1.0),  # gemma-2b heads
])
def test_mma_arithmetic_matches_jax_kernel(b, h, kv, hd, t, bk, pos, window, softcap, q_scale):
    """Rounding P to bf16 is the one step the reference's kernel does not
    take; with it the bf16 route stays inside the reference's 2e-2 at every
    piece length the wrapper can pick (1 to 8 tiles a piece)."""
    jx, tx = _inputs(hash((b, h, kv, hd, t, window)) % 2**31, b, h, kv, hd, t, "bfloat16",
                     pos=pos, q_scale=q_scale)
    ref = jax_decode_attention(*jx, window=window, softcap=softcap, block_k=bk)
    for piece in da_kernel.PIECES:
        out = _mma_emulation(*tx, window=window, softcap=softcap, piece=piece)
        assert out.dtype == torch.bfloat16 and out.shape == tx[0].shape
        np.testing.assert_allclose(_np(out), _np(ref), **TOL["bfloat16"])
    if pos is not None and pos[0] == 0:       # pos = 0 sees kv row 0 only
        got = _np(out[0]).reshape(kv, h // kv, hd)
        for g in range(kv):
            np.testing.assert_allclose(got[g], np.broadcast_to(_np(tx[2][0, 0, g]), got[g].shape))


def test_routes_by_dtype_and_cpu_calls_count_nothing():
    """bf16 goes to the mma kernel (dtype code 1), f32 to the CUDA-core
    kernel (code 0); a CPU call computes the plain version and leaves every
    counter at 0."""
    assert da_ops.ROUTES == {torch.bfloat16: "mma", torch.float32: "simt"}
    assert {da_ops.ROUTES[d]: da_kernel._DTYPE_CODE[d] for d in da_ops.ROUTES} == {
        "mma": 1, "simt": 0}
    for dtype in ("bfloat16", "float32"):
        _, (q, k, v, pos) = _inputs(37, 2, 8, 2, 64, 96, dtype)
        out = decode_attention(q, k, v, pos, window=16, softcap=10.0)
        assert torch.equal(out, reference_decode_attention(q, k, v, pos, window=16,
                                                           softcap=10.0))
    assert decode_attention.launches == 0
    assert decode_attention.launches_by_route == {"mma": 0, "simt": 0}


@pytest.mark.parametrize("case,error", [
    ("shape", ValueError), ("head_dim", ValueError), ("dtype", TypeError),
    ("heads", ValueError), ("pos", TypeError), ("window", ValueError)])
def test_decode_attention_rejects_bad_inputs(case, error):
    _, (q, k, v, pos) = _inputs(31, 2, 4, 2, 64, 32, "float32")
    kwargs = {}
    if case == "shape":
        q = q[:, None]
    elif case == "head_dim":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
    elif case == "dtype":
        k = k.double()
    elif case == "heads":
        q = q[:, :3]
    elif case == "pos":
        pos = pos.float()
    else:
        kwargs["window"] = -1
    with pytest.raises(error):
        decode_attention(q, k, v, pos, **kwargs)


def test_cpu_path_stays_differentiable():
    _, (q, k, v, pos) = _inputs(3, 2, 4, 2, 64, 32, "float32")
    q.requires_grad_(True)
    decode_attention(q, k, v, pos).sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape and torch.isfinite(q.grad).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype):
    """Both routes (bf16 -> mma, f32 -> simt), each launch counted on its
    route, at gemma-2b heads and a group of 16 with window and softcap."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = DTYPES[dtype][1]
    route = da_ops.ROUTES[tdt]
    gen = torch.Generator(cuda_device).manual_seed(0)
    for b, h, kv, hd, t, window, cap in ((2, 4, 4, 64, 256, 0, 0.0),
                                         (4, 8, 1, 256, 2048, 0, 0.0),
                                         (3, 16, 1, 128, 1000, 64, 50.0)):
        q_scale = 32.0 if cap else 1.0     # logits that reach past the softcap
        q = (q_scale * torch.randn(b, h, hd, generator=gen, device=cuda_device)).to(tdt)
        k, v = (torch.randn(b, t, kv, hd, generator=gen, device=cuda_device).to(tdt)
                for _ in range(2))
        pos = torch.randint(0, t, (b,), generator=gen, device=cuda_device)
        before = decode_attention.launches
        before_route = decode_attention.launches_by_route[route]
        out = decode_attention(q, k, v, pos, window=window, softcap=cap)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        assert decode_attention.launches_by_route[route] == before_route + 1
        ref = reference_decode_attention(q, k, v, pos, window=window, softcap=cap)
        # bf16: 5e-3 of max|ref| and one ulp of rounding, well below the
        # reference's 2e-2 for outputs that average thousands of rows
        tol = TOL[dtype] if dtype == "float32" else dict(
            atol=5e-3 * float(ref.float().abs().max()), rtol=1e-2)
        np.testing.assert_allclose(_np(out.cpu()), _np(ref.cpu()), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_refuses_grad_on_card(cuda_device, dtype):
    """No backward kernel: under grad mode an input that requires grad
    raises instead of giving an output that autograd cannot see into."""
    tdt = DTYPES[dtype][1]
    gen = torch.Generator(cuda_device).manual_seed(1)
    q = torch.randn(2, 8, 64, generator=gen, device=cuda_device).to(tdt)
    k, v = (torch.randn(2, 128, 2, 64, generator=gen, device=cuda_device).to(tdt)
            for _ in range(2))
    pos = torch.tensor([127, 40], device=cuda_device)
    k.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q, k, v, pos)
    with torch.no_grad():
        out = decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
