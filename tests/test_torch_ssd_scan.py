"""The port's SSD chunk scan against the JAX package's: the same numpy
inputs through JAX ``ssd_scan`` (the Pallas kernel in interpret mode) or
``ssd_chunked`` and the port's wrapper, which on CPU tensors computes its
plain version (the sequential recurrence).  Sweep and tolerances are those
of tests/test_kernels.py (f32 2e-5, bf16 2e-2; 3e-5 against
``ssd_chunked``; 2e-4 across chunk sizes).  The kernel's arithmetic
(decays from 16-step tile-local cumsums, products as split TF32 with the
pass counts of ``csrc/ssd_scan.cu``) is emulated here and held against
the same JAX kernel, the port's plain version and an f64 recurrence.  The
kernels themselves run only on a card: their tests are marked ``gpu`` and
skip here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import reference_ssd_scan as jax_reference_ssd_scan
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models.mamba2 import ssd_chunked
from repro_torch.configs import get_config
from repro_torch.kernels import reference_ssd_scan, ssd_scan
from repro_torch.kernels.ssd_scan import ops as ssd_scan_ops
from repro_torch.kernels.ssd_scan.ops import fold_and_scan
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
    assert ssd_scan.launches_by_layout == {}
    with pytest.raises(ValueError, match="multiple"):
        ssd_scan(*tx, chunk=128)            # L = 64 is not a multiple of 128
    x, dt, a, bm, cm = tx
    with pytest.raises(ValueError):
        ssd_scan(x[..., :8], dt, a, bm, cm, chunk=16)   # head_dim 8
    with pytest.raises(TypeError):
        ssd_scan(x, dt.double(), a, bm, cm, chunk=16)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a, bm, cm[:, :32], chunk=16)


def test_mamba2_370m_config_sizes_the_scan_and_its_model_prefill_launches_no_scan(monkeypatch):
    """The config sizes the scan; the model builds, and its prefill runs
    the plain chunked SSD, never the scan (as in the reference, whose
    ``models/mamba2.py`` imports no kernel): the scan's CPU path, which
    every call on CPU tensors takes, is not entered."""
    cfg = get_config("mamba2-370m")
    d_in = cfg.ssm_expand * cfg.d_model
    assert (d_in, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_chunk) == (2048, 32, 64, 128, 256)
    Model(cfg, device="cpu")
    small = Model(cfg.reduced(), device="cpu")
    params = small.init(torch.Generator().manual_seed(0))
    calls = []
    monkeypatch.setattr(ssd_scan_ops, "fold_and_scan", lambda *a, **k: calls.append(a))
    with torch.no_grad():
        logits, cache = small.prefill(params, {"tokens": torch.zeros((1, 16), dtype=torch.long)})
    assert logits.shape == (1, 16, small.cfg.vocab_size) and set(cache["layer0"]) == {"conv", "ssm"}
    assert calls == [] and ssd_scan.launches == 0


SUB = 16   # positions per tile-local cumsum in the kernel


def _tf32(v, rounded=True):
    """v onto TF32's 10 mantissa bits: rounded to nearest, ties away from
    zero (cvt.rna), or truncated, as the tensor cores read an f32 register."""
    bits = v.contiguous().view(torch.int32)
    return (((bits + 0x1000) if rounded else bits) & ~0x1FFF).view(torch.float32)


def _mm(a, b, a_exact, b_exact):
    """a @ b as the kernel runs it on the tensor cores: an f32 operand is
    split into hi (rounded to TF32) + lo (the rest, which the tensor cores
    truncate), a bf16 one is exact in TF32; hi.hi + hi.lo + lo.hi (lo.lo
    dropped), f32 sums.  Both exact: one pass (C.B^T in bf16)."""
    def split(v):
        hi = _tf32(v)
        return hi, _tf32(v - hi, rounded=False)
    if a_exact and b_exact:
        return a @ b
    if a_exact:
        bh, bl = split(b)
        return a @ bl + a @ bh
    ah, al = split(a)
    if b_exact:
        return al @ b + ah @ b
    bh, bl = split(b)
    return (ah @ bl + al @ bh) + ah @ bh


def _run(v, reverse=False, exclusive=False):
    """Running f32 sum along the last axis, one term at a time."""
    out = torch.empty_like(v)
    run = torch.zeros_like(v[..., 0])
    steps = range(v.shape[-1])
    for k in (reversed(steps) if reverse else steps):
        if exclusive:
            out[..., k] = run
        run = run + v[..., k]
        if not exclusive:
            out[..., k] = run
    return out, run


def _tile_sums(da):
    """da (..., Q) -> the kernel's sums: loc (inclusive within each 16-step
    tile), rem (exclusive suffix within the tile), pre and suf (tile totals
    before and after each tile), mid[si, sj] (totals strictly between), and
    the chunk's total."""
    q = da.shape[-1]
    ns = q // SUB
    t = da.reshape(*da.shape[:-1], ns, SUB)
    loc, tot = _run(t)
    rem, _ = _run(t, reverse=True, exclusive=True)
    pre, total = _run(tot, exclusive=True)
    suf, _ = _run(tot, reverse=True, exclusive=True)
    mid = torch.zeros(*tot.shape, ns)
    for si in range(ns):
        run = torch.zeros_like(tot[..., 0])
        for sj in reversed(range(si)):
            mid[..., si, sj] = run
            run = run + tot[..., sj]
    return loc.reshape(da.shape), rem.reshape(da.shape), pre, suf, mid, total


def _route_emulation(x, dt, a, bm, cm, chunk):
    """The kernel's arithmetic on the CPU, model layout in and out.  Every
    decay exponent comes from sums of one sign over at most 16 steps plus
    whole-tile totals (never a difference of two long cumsums), and off the
    diagonal 16-step tile the decay is a product of three such exps; C.B^T in f32
    from exact bf16 products (or 3 TF32 passes for f32 B/C); att.x 3 passes
    (2 for bf16 x); C.h_prev^T and the chunk states 2 passes for bf16 B/C,
    3 for f32; the state pass in f32."""
    b, length, nh, hd = x.shape
    n = bm.shape[-1]
    nc, q = length // chunk, chunk
    x_exact, bc_exact = x.dtype == torch.bfloat16, bm.dtype == torch.bfloat16
    xf = x.float().reshape(b, nc, q, nh, hd).permute(0, 3, 1, 2, 4)     # b h c q d
    dtc = dt.reshape(b, nc, q, nh).permute(0, 3, 1, 2)                  # b h c q
    bf, cf = (m.float().reshape(b, nc, q, n) for m in (bm, cm))
    loc, rem, pre, suf, mid, total = _tile_sums(dtc * a[None, :, None, None])
    s_of = torch.arange(q) // SUB
    same = s_of[:, None] == s_of[None, :]
    lower = torch.arange(q)[:, None] >= torch.arange(q)[None, :]
    g = _mm(cf, bf.transpose(-1, -2), bc_exact, bc_exact)[:, None]      # b 1 c q q
    # the diagonal tile: exp(loc_i - loc_j); off it, a row factor exp(loc_i)
    # exp(mid) and a column factor exp(rem_j) dt_j
    diag = g * torch.exp(loc[..., :, None] - loc[..., None, :]) * dtc[..., None, :]
    row = torch.exp(loc)[..., :, None] * torch.exp(mid[..., s_of[:, None], s_of[None, :]])
    off = g * row * (torch.exp(rem) * dtc)[..., None, :]
    att = torch.where(lower, torch.where(same, diag, off), 0.0)
    y = _mm(att, xf, False, x_exact)
    xw = xf * (torch.exp(rem + suf.repeat_interleave(SUB, -1)) * dtc)[..., None]
    states = _mm(xw.transpose(-1, -2), bf[:, None], False, bc_exact)    # b h c d n
    h = torch.zeros(b, nh, hd, n)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = torch.exp(total[..., c, None, None]) * h + states[:, :, c]
    inter = _mm(cf[:, None], torch.stack(h_prev, 2).transpose(-1, -2), bc_exact, False)
    y = torch.exp(pre.repeat_interleave(SUB, -1) + loc)[..., None] * inter + y
    return y.permute(0, 2, 3, 1, 4).reshape(b, length, nh, hd).to(x.dtype), h


@pytest.mark.parametrize("x_dtype,bc_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                              ("float32", "bfloat16")])
@pytest.mark.parametrize("b,length,nh,hd,n,chunk", [
    (1, 64, 2, 16, 16, 16),
    (2, 128, 4, 32, 64, 32),
    (1, 256, 2, 64, 128, 64),
])
def test_route_arithmetic_matches_jax_kernel(x_dtype, bc_dtype, b, length, nh, hd, n, chunk):
    """test_kernels.py's sweep (x and B/C of one type) and the model's mix
    (x f32, B/C bf16), at x's tolerance."""
    jx, tx = _inputs(hash((b, length, nh, hd, n)) % 2**31, b, length, nh, hd, n, x_dtype,
                     bc_dtype)
    yj, hj = jax_ssd_scan(*jx, chunk=chunk)
    y, h = _route_emulation(*tx, chunk)
    np.testing.assert_allclose(_np(y), _np(yj), **TOL[x_dtype])
    np.testing.assert_allclose(_np(h), _np(hj), **TOL[x_dtype])


@pytest.mark.parametrize("x_dtype,bc_dtype", [("float32", "float32"), ("bfloat16", "float32"),
                                              ("float32", "bfloat16")])
def test_route_arithmetic_matches_plain_version_over_256_step_chunks(x_dtype, bc_dtype):
    """The card test's largest case, with its draw: decays over 256-step
    chunks, where one f32 cumsum per chunk misses 2e-5."""
    _, tx = _inputs(0, 1, 512, 2, 64, 128, x_dtype, bc_dtype)
    y, h = _route_emulation(*tx, 256)
    yr, hr = ssd_scan(*tx, chunk=256)
    np.testing.assert_allclose(_np(y), _np(yr), **TOL[x_dtype])
    np.testing.assert_allclose(_np(h), _np(hr), **TOL[x_dtype])


def test_route_arithmetic_is_no_further_from_f64_than_the_jax_kernel():
    """Against the recurrence in f64, the route's y and h are no further off
    than the reference kernel's (one cumsum per chunk, f32)."""
    jx, tx = _inputs(0, 1, 512, 2, 64, 128)
    y64, h64 = (v.numpy() for v in fold_and_scan(*(t.double() for t in tx), chunk=256))
    yj, hj = jax_ssd_scan(*jx, chunk=256)
    y, h = _route_emulation(*tx, 256)
    for ours, ref, exact in ((y, yj, y64), (h, hj, h64)):
        err = np.abs(_np(ours).astype(np.float64) - exact).max()
        err_jax = np.abs(np.asarray(ref, np.float64) - exact).max()
        assert err <= err_jax, (err, err_jax)


PASS_THREADS, PASS_BATCH = 256, 8   # csrc/ssd_scan.cu's THREADS and PASS_BATCH


def _fma(a, b, c):
    """a * b + c rounded once to f32, as the kernel's contracted expression:
    the product of two f32 values is exact in f64."""
    return (a.double() * b.double() + c.double()).float()


def _state_pass_mirror(states, decay):
    """ssd_state_pass as the kernel walks it: block x's thread e owns the
    four elements 4 (PASS_THREADS x + e) .. + 3 of every (bh, chunk) state;
    the chunks go in batches of PASS_BATCH, every load of a batch before its
    first store.  states (BH, NC, size) f32 is rewritten in place with the
    state before each chunk; returns h_final (BH, size)."""
    bh, nc, size = states.shape
    step = size // 4
    h_final = torch.full((bh, size), float("nan"))
    for x in range(-(-step // PASS_THREADS)):
        e = torch.arange(x * PASS_THREADS, min((x + 1) * PASS_THREADS, step))
        idx = (4 * e[:, None] + torch.arange(4)).reshape(-1)
        hs = torch.zeros(bh, idx.numel())
        for c0 in range(0, nc, PASS_BATCH):
            nb = min(PASS_BATCH, nc - c0)
            sc = [states[:, c0 + i, idx].clone() for i in range(nb)]
            dec = decay[:, c0:c0 + nb].clone()
            for i in range(nb):
                states[:, c0 + i, idx] = hs
                hs = _fma(dec[:, i, None], hs, sc[i])
        h_final[:, idx] = hs
    return h_final


def _chunk_states(x, dt, a, bm, chunk):
    """Each chunk's own state S_c = sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
    and its decay exp(cum_last), in f64 and cast to f32: (BH, NC, hd*N),
    (BH, NC)."""
    b, length, nh, hd = x.shape
    n, nc = bm.shape[-1], length // chunk
    xd = x.double().reshape(b, nc, chunk, nh, hd)
    da = (dt.double() * a.double()).reshape(b, nc, chunk, nh)
    cum = da.cumsum(2)
    w = torch.exp(cum[:, :, -1:] - cum) * dt.double().reshape(b, nc, chunk, nh)
    sc = torch.einsum("bcqh,bcqhd,bcqn->bhcdn", w, xd, bm.double().reshape(b, nc, chunk, n))
    decay = torch.exp(cum[:, :, -1]).permute(0, 2, 1)
    return sc.reshape(b * nh, nc, hd * n).float(), decay.reshape(b * nh, nc).float()


@pytest.fixture
def one_thread():
    """The emulations' small tensors gain nothing from intra-op threads;
    one keeps a parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("nc", [1, 2, 7, 8, 9, 16])
def test_state_pass_layout_matches_the_chunk_recurrence(nc):
    """The kernel's thread -> 4-element map and batch loop (NC below, at and
    past a batch, and not a multiple of it; a state of 8192 elements over 8
    blocks, and one of 256 where most of a block's threads idle) give, bit
    for bit, the chunk-by-chunk recurrence in the same arithmetic, and its
    h_final is the plain version's (the sequential recurrence over
    positions) at 2e-5."""
    for b, nh, hd, n, chunk in ((1, 2, 64, 128, 16), (2, 1, 16, 16, 32)):
        _, (x, dt, a, bm, cm) = _inputs(nc, b, nc * chunk, nh, hd, n)
        states, decay = _chunk_states(x, dt, a, bm, chunk)
        walked = states.clone()
        h_final = _state_pass_mirror(walked, decay)
        h, before = torch.zeros(b * nh, hd * n), torch.empty_like(states)
        for c in range(nc):
            before[:, c] = h
            h = _fma(decay[:, c, None], h, states[:, c])
        assert torch.equal(walked, before) and torch.equal(h_final, h)
        _, h_ref = fold_and_scan(x, dt, a, bm, cm, chunk=chunk)
        np.testing.assert_allclose(_np(h_final), _np(h_ref.reshape(b * nh, hd * n)),
                                   **TOL["float32"])


def test_cpu_path_stays_differentiable():
    _, tx = _inputs(4, 1, 32, 2, 16, 16)
    x = tx[0].clone().requires_grad_(True)
    y, h = ssd_scan(x, *tx[1:], chunk=16)
    (y.sum() + h.sum()).backward()
    assert x.grad is not None and x.grad.shape == x.shape and torch.isfinite(x.grad).all()


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
    # the last six: the state pass at chunk counts below, at and past its
    # batch of 8 chunks
    for b, length, nh, hd, n, chunk in ((1, 64, 2, 16, 16, 16), (2, 128, 4, 32, 64, 32),
                                        (1, 512, 2, 64, 128, 256),
                                        *((1, 32 * nc, 2, 64, 128, 32)
                                          for nc in (1, 2, 7, 8, 9, 16))):
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


@pytest.mark.gpu
def test_kernel_refuses_grad_on_card(cuda_device):
    _, tx = _inputs(1, 1, 64, 2, 16, 16)
    tx = [t.to(cuda_device) for t in tx]
    x = tx[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(x, *tx[1:], chunk=16)
    with torch.no_grad():
        y, h = ssd_scan(x, *tx[1:], chunk=16)
    torch.cuda.synchronize()
    assert y.shape == x.shape and torch.isfinite(y).all() and torch.isfinite(h).all()
