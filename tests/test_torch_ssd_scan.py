"""The port's SSD chunk scan against the JAX package's: the same numpy
inputs through JAX ``ssd_scan`` (the Pallas kernel in interpret mode) or
``ssd_chunked`` and the port's wrapper, which on CPU tensors computes its
plain version (the sequential recurrence).  Sweep and tolerances are those
of tests/test_kernels.py (f32 2e-5, bf16 2e-2; 3e-5 against
``ssd_chunked``; 2e-4 across chunk sizes).  The kernels themselves run
only on a card: their tests are marked ``gpu`` and skip here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import reference_ssd_scan as jax_reference_ssd_scan
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models.mamba2 import ssd_chunked
from repro_torch.configs import get_config
from repro_torch.kernels import reference_ssd_scan, ssd_scan
from repro_torch.models import Model

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(seed, b, length, nh, hd, n, x_dtype="float32", bc_dtype="float32"):
    """x, dt, a, B, C as test_kernels.py draws them, from numpy, for both:
    dt = softplus(normal), a = -exp(0.3 normal), B and C = 0.3 normal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, length, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, length, nh)))).astype(np.float32)
    a = (-np.exp(0.3 * rng.standard_normal(nh))).astype(np.float32)
    bm = (0.3 * rng.standard_normal((b, length, n))).astype(np.float32)
    cm = (0.3 * rng.standard_normal((b, length, n))).astype(np.float32)
    dts = (x_dtype, "float32", "float32", bc_dtype, bc_dtype)
    return ([jnp.asarray(v).astype(DTYPES[d][0]) for v, d in zip((x, dt, a, bm, cm), dts)],
            [torch.from_numpy(v).to(DTYPES[d][1]) for v, d in zip((x, dt, a, bm, cm), dts)])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,length,nh,hd,n,chunk", [
    (1, 64, 2, 16, 16, 16),
    (2, 128, 4, 32, 64, 32),
    (1, 256, 2, 64, 128, 64),         # mamba2-370m-like head
])
def test_ssd_scan_matches_jax_kernel(dtype, b, length, nh, hd, n, chunk):
    jx, tx = _inputs(hash((b, length, nh, hd, n)) % 2**31, b, length, nh, hd, n, dtype)
    yj, hj = jax_ssd_scan(*jx, chunk=chunk)
    y, h = ssd_scan(*tx, chunk=chunk)
    assert y.dtype == tx[0].dtype and y.shape == tx[0].shape
    assert h.dtype == torch.float32 and h.shape == (b, nh, hd, n)
    np.testing.assert_allclose(_np(y), _np(yj), **TOL[dtype])
    np.testing.assert_allclose(_np(h), _np(hj), **TOL[dtype])


def test_ssd_scan_matches_jax_model_chunked():
    """The port's scan == the reference model's ssd_chunked (the path the
    kernel stands for), at 3e-5 as in tests/test_kernels.py."""
    jx, tx = _inputs(5, 2, 96, 3, 16, 32)
    ym, hm = ssd_chunked(*jx, 32)
    y, h = ssd_scan(*tx, chunk=32)
    np.testing.assert_allclose(_np(y), _np(ym), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(_np(h), _np(hm), rtol=3e-5, atol=3e-5)


def test_ssd_scan_chunk_size_is_invisible():
    _, tx = _inputs(9, 1, 128, 2, 16, 16)
    y16, h16 = ssd_scan(*tx, chunk=16)
    y64, h64 = ssd_scan(*tx, chunk=64)
    np.testing.assert_allclose(_np(y16), _np(y64), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(h16), _np(h64), rtol=2e-4, atol=2e-4)


def test_reference_ssd_scan_matches_jax_reference():
    """The kernel-layout oracles: (BH, NC, Q, ...) in, (y, h_final) out."""
    rng = np.random.default_rng(3)
    bh, nc, q, hd, n = 3, 4, 16, 16, 32
    x = rng.standard_normal((bh, nc, q, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bh, nc, q)))).astype(np.float32)
    da = (dt * -np.exp(0.3 * rng.standard_normal((bh, 1, 1)))).astype(np.float32)
    bm, cm = (0.3 * rng.standard_normal((bh, nc, q, n)).astype(np.float32) for _ in range(2))
    args = (x, da, dt, bm, cm)
    yj, hj = jax_reference_ssd_scan(*(jnp.asarray(v) for v in args))
    y, h = reference_ssd_scan(*(torch.from_numpy(v) for v in args))
    assert y.shape == (bh, nc, q, hd) and h.shape == (bh, hd, n)
    np.testing.assert_allclose(_np(y), _np(yj), **TOL["float32"])
    np.testing.assert_allclose(_np(h), _np(hj), **TOL["float32"])


def test_ssd_scan_mixed_dtypes_as_the_model_passes_them():
    """ssm_forward hands the scan x f32 and B/C in the parameter dtype."""
    jx, tx = _inputs(7, 2, 128, 4, 32, 64, bc_dtype="bfloat16")
    yj, hj = jax_ssd_scan(*jx, chunk=32)
    y, h = ssd_scan(*tx, chunk=32)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(yj), **TOL["float32"])
    np.testing.assert_allclose(_np(h), _np(hj), **TOL["float32"])


def test_ssd_scan_on_cpu_counts_nothing_and_rejects_bad_inputs():
    _, tx = _inputs(2, 1, 64, 2, 16, 16)
    before = ssd_scan.launches
    ssd_scan(*tx, chunk=16)
    assert ssd_scan.launches == before == 0
    with pytest.raises(ValueError, match="multiple"):
        ssd_scan(*tx, chunk=128)            # L = 64 is not a multiple of 128
    x, dt, a, bm, cm = tx
    with pytest.raises(ValueError):
        ssd_scan(x[..., :8], dt, a, bm, cm, chunk=16)   # head_dim 8
    with pytest.raises(TypeError):
        ssd_scan(x, dt.double(), a, bm, cm, chunk=16)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a, bm, cm[:, :32], chunk=16)


def test_mamba2_370m_config_sizes_the_scan_and_stays_unported_as_a_model():
    cfg = get_config("mamba2-370m")
    d_in = cfg.ssm_expand * cfg.d_model
    assert (d_in, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_chunk) == (2048, 32, 64, 128, 256)
    with pytest.raises(NotImplementedError, match="Mamba2"):
        Model(cfg, device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype,bc_dtype", [("float32", "float32"),
                                              ("bfloat16", "float32"),
                                              ("float32", "bfloat16")])
def test_kernel_matches_plain_version_on_card(cuda_device, x_dtype, bc_dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    for b, length, nh, hd, n, chunk in ((1, 64, 2, 16, 16, 16), (2, 128, 4, 32, 64, 32),
                                        (1, 512, 2, 64, 128, 256)):
        _, tx = _inputs(0, b, length, nh, hd, n, x_dtype, bc_dtype)
        tx = [t.to(cuda_device) for t in tx]
        before = ssd_scan.launches
        y, h = ssd_scan(*tx, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd_scan.launches == before + 1
        yr, hr = ssd_scan(*(t.cpu() for t in tx), chunk=chunk)
        tol = TOL["float32" if x_dtype == "float32" else "bfloat16"]
        np.testing.assert_allclose(_np(y.cpu()), _np(yr), **tol)
        np.testing.assert_allclose(_np(h.cpu()), _np(hr), **tol)
