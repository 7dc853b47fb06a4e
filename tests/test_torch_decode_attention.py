"""The port's decode attention against the JAX package's: the same numpy
inputs through JAX ``decode_attention`` (the Pallas kernel in interpret
mode) and the port's wrapper, which on CPU tensors computes its plain
version.  Sweep and tolerances are those of tests/test_kernels.py (f32
2e-5, bf16 2e-2).  The kernel itself runs only on a card: its test is
marked ``gpu`` and skips here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.decode_attention import (
    reference_decode_attention as jax_reference_decode_attention,
)
from repro_torch.kernels import decode_attention, reference_decode_attention
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = DTYPES[dtype][1]
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
        out = decode_attention(q, k, v, pos, window=window, softcap=cap)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        ref = reference_decode_attention(q, k, v, pos, window=window, softcap=cap)
        # bf16: 5e-3 of max|ref| and one ulp of rounding, well below the
        # reference's 2e-2 for outputs that average thousands of rows
        tol = TOL[dtype] if dtype == "float32" else dict(
            atol=5e-3 * float(ref.float().abs().max()), rtol=1e-2)
        np.testing.assert_allclose(_np(out.cpu()), _np(ref.cpu()), **tol)
