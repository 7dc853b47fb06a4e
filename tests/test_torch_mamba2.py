"""The port's Mamba2 block (``repro_torch.models.mamba2``) against the JAX
package's ``repro.models.mamba2`` on the same numpy inputs: the chunked
SSD scan, the full-sequence block and its recurrent decode step, the
conv tail, the numpy-drawn leaves of ``ssm_init``, the conversion of a
Mamba2 parameter tree, and the reference's prefill-then-decode check on
the port.  f32 throughout; bands 2e-5 for the scan and a block (f32 sums
in another order), and the reference's own 2e-2 / 5e-2 for the model
check."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import mamba2 as jax_mamba2
from repro_torch.configs import get_config
from repro_torch.models import Model, mamba2
from repro_torch.models.convert import params_from_numpy

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors gain nothing from intra-op threads; one keeps a
    parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _scan_inputs(seed, b=2, length=32, nh=3, hd=8, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, length, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, length, nh)))).astype(np.float32)
    a = -np.exp(rng.uniform(0.0, 1.5, nh)).astype(np.float32)
    bm = rng.standard_normal((b, length, n)).astype(np.float32)
    cm = rng.standard_normal((b, length, n)).astype(np.float32)
    h0 = rng.standard_normal((b, nh, hd, n)).astype(np.float32)
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_jax(chunk, with_h0):
    x, dt, a, bm, cm, h0 = _scan_inputs(chunk)
    h0 = h0 if with_h0 else None
    yj, hj = jax_mamba2.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk,
                                    None if h0 is None else jnp.asarray(h0))
    y, h = mamba2.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)), chunk,
                              None if h0 is None else torch.from_numpy(h0))
    _close(y, yj)
    _close(h, hj)


def test_ssd_chunked_refuses_a_length_off_the_chunk():
    x, dt, a, bm, cm, _ = _scan_inputs(0, length=20)
    with pytest.raises(ValueError, match="multiple"):
        mamba2.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)), 8)


def _block(seed=0):
    """Reduced mamba2-370m's config and one layer's reference parameters,
    as numpy and as the port's tensors."""
    cfg = jax_get_config("mamba2-370m").reduced()
    jp = jax_mamba2.ssm_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return get_config("mamba2-370m").reduced(), jp, tp


@pytest.mark.parametrize("length", [1, 3, 16, 32])
def test_ssm_forward_matches_jax(length):
    """Lengths under the conv window and under the chunk (one chunk of L)
    and over it (two chunks of 16)."""
    cfg, jp, tp = _block()
    x = np.random.default_rng(length).standard_normal((2, length, cfg.d_model)) \
        .astype(np.float32)
    yj, sj = jax_mamba2.ssm_forward(jp, cfg, jnp.asarray(x))
    y, s = mamba2.ssm_forward(tp, cfg, torch.from_numpy(x))
    _close(y, yj)
    _close(s["conv"], sj["conv"])
    _close(s["ssm"], sj["ssm"])


def test_ssm_decode_matches_jax_and_leaves_its_state_argument_alone():
    cfg, jp, tp = _block(1)
    rng = np.random.default_rng(7)
    d_in, nh, conv_dim = mamba2.ssm_dims(cfg)
    state = {"conv": rng.standard_normal((2, cfg.ssm_conv_width - 1, conv_dim))
             .astype(np.float32),
             "ssm": rng.standard_normal((2, nh, cfg.ssm_head_dim, cfg.ssm_state))
             .astype(np.float32)}
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    for _ in range(3):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        yj, jstate = jax_mamba2.ssm_decode(jp, cfg, jnp.asarray(x), jstate)
        before = {k: v.clone() for k, v in tstate.items()}
        y, new = mamba2.ssm_decode(tp, cfg, torch.from_numpy(x), tstate)
        assert all(torch.equal(before[k], tstate[k]) for k in tstate)
        tstate = new
        _close(y, yj)
        _close(tstate["conv"], jstate["conv"])
        _close(tstate["ssm"], jstate["ssm"])


def test_ssm_forward_state_continues_in_decode():
    """The state that ssm_forward returns, fed to ssm_decode, gives the
    outputs of ssm_forward over the longer sequence."""
    cfg, _, tp = _block(2)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 12, cfg.d_model))
                         .astype(np.float32))
    full, _ = mamba2.ssm_forward(tp, cfg, x)
    _, state = mamba2.ssm_forward(tp, cfg, x[:, :8])
    for t in range(8, 12):
        y, state = mamba2.ssm_decode(tp, cfg, x[:, t:t + 1], state)
        torch.testing.assert_close(y[:, 0], full[:, t], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("length", [1, 2, 3, 5])
def test_conv_tail_matches_jax(length):
    """Below W-1 = 3 inputs the tail is left-padded with zeros."""
    x = np.random.default_rng(length).standard_normal((2, length, 6)).astype(np.float32)
    tail = mamba2._conv_tail(torch.from_numpy(x), 4)
    assert tail.shape == (2, 3, 6)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jax_mamba2._conv_tail(
        jnp.asarray(x), 4)))


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b"])
def test_numpy_drawn_leaves_equal_the_references_bit_for_bit(arch):
    """dt_bias, A_log and D come from numpy draws, not the key: the port's
    equal the reference's bits at the config's head count (32; jamba's
    256), in every layer group.  They depend on nothing else, so the
    matrices are cut to d_model = nh."""
    full = jax_get_config(arch)
    nh = jax_mamba2.ssm_dims(full)[1]
    cfg = dataclasses.replace(full, d_model=nh, ssm_expand=2, ssm_head_dim=2)
    assert jax_mamba2.ssm_dims(cfg)[1] == nh
    jp = jax_mamba2.ssm_init(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    tp = mamba2.ssm_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                         groups=(3,))
    for leaf in ("dt_bias", "A_log", "D"):
        ref = np.asarray(jp[leaf])
        assert ref.dtype == np.float32 and tp[leaf].dtype == torch.float32
        got = tp[leaf].numpy()
        assert got.shape == (3, *ref.shape)
        assert all(np.array_equal(g.view(np.uint32), ref.view(np.uint32)) for g in got), leaf


def test_params_from_numpy_carries_a_mamba2_tree():
    cfg = jax_get_config("mamba2-370m").reduced()
    jp = jax.tree.map(np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(0), max_seq=32))
    port_cfg = get_config("mamba2-370m").reduced()
    tp = params_from_numpy(jp, port_cfg, device="cpu")
    assert "wq" not in tp["blocks"]["layer0"]["mixer"]
    for (path, ref), got in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                jax.tree.leaves(tp)):
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=jax.tree_util.keystr(path))
    with pytest.raises(ValueError, match="stacked groups"):
        params_from_numpy(jp, dataclasses.replace(port_cfg, n_layers=3), device="cpu")


def test_prefill_then_decode_matches_forward():
    """The reference's tests/test_models_smoke.py check for mamba2-370m, on
    the port: prefill on 12 tokens (one chunk of 12), then 4 teacher-forced
    decode steps against forward's logits over 16 (one chunk of 16)."""
    cfg = get_config("mamba2-370m").reduced()
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(2))
    b, s, split = 2, 16, 12
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s)))
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": toks})
        logits_p, cache = model.prefill(params, {"tokens": toks[:, :split]})
        torch.testing.assert_close(logits_p, full[:, :split], rtol=2e-2, atol=2e-2)
        assert set(cache["layer0"]) == {"conv", "ssm"}
        for i in range(split, s):
            logits_d, cache = model.decode_step(params, toks[:, i], cache,
                                                torch.full((b,), i))
            torch.testing.assert_close(logits_d, full[:, i], rtol=5e-2, atol=5e-2)
