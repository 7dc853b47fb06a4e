"""The port's flash attention against the JAX package's: the same numpy
inputs through JAX ``flash_attention`` (the Pallas kernel in interpret
mode) and the port's wrapper, which on CPU tensors computes its plain
version.  Sweep and tolerances are those of tests/test_kernels.py (f32
2e-5, bf16 2e-2).  The kernel itself runs only on a card: its test is
marked ``gpu`` and skips here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

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


def test_flash_attention_on_cpu_is_the_plain_version_and_counts_nothing():
    (_, _, _), (tq, tk, tv) = _inputs(
        11, [(1, 32, 4, 64), (1, 32, 2, 64), (1, 32, 2, 64)], "float32")
    before = flash_attention.launches
    out = flash_attention(tq, tk, tv, window=8, softcap=10.0)
    ref = flash_attention_ref(tq, tk, tv, window=8, softcap=10.0)
    assert torch.equal(out, ref)
    assert flash_attention.launches == before == 0


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
    for s, h, kv, hd, window, cap in ((100, 4, 2, 64, 0, 0.0), (256, 8, 1, 256, 0, 0.0),
                                      (512, 8, 4, 128, 64, 50.0)):
        q, k, v = (torch.randn(1, s, n, hd, generator=gen, device=cuda_device).to(tdt)
                   for n in (h, kv, kv))
        before = flash_attention.launches
        out = flash_attention(q, k, v, causal=True, window=window, softcap=cap)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        ref = flash_attention_ref(q, k, v, causal=True, window=window, softcap=cap)
        np.testing.assert_allclose(_np(out.cpu()), _np(ref.cpu()), **TOL[dtype])
