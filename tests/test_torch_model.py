"""The port's dense and Mamba2 models against the JAX package's, with the
JAX parameters carried across by ``repro_torch.models.convert``.

Reduced gemma-2b, gemma2-2b (window + both softcaps), granite-3-8b (GQA,
swiglu, tied embeddings) and starcoder2-15b (GQA, gelu, an untied head)
run prefill, forward and decode through both packages on the same numpy
tokens, with each attention route: the reference's default sdpa,
``chunked``, and its ``pallas`` rule (the Pallas kernel in interpret mode)
against the port's ``"kernel"`` route (the kernel's plain version on CPU
tensors).  Reduced mamba2-370m (no attention: its chunked SSD prefill and
recurrent decode) runs on two routes, which must not change it.  Reduced
dbrx-132b (16 -> 4 experts, top-2) and llama4-scout-17b-a16e (top-1, a
shared expert, qk-norm) run every route too, and forward's ``moe_aux``
(each MoE layer's load-balancing loss, summed) equals the reference's
within 1e-5.  Bands are the reference's own for kernel-vs-sdpa dispatch
(tests/test_train_step_features.py): 2e-4, and 5e-4 for gemma2-2b."""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import layers as jax_layers
from repro.sharding.logical import logical_axis_rules
from repro_torch.configs import ModelConfig, get_config
from repro_torch.models import Model
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy

TOL = {"gemma-2b": 2e-4, "gemma2-2b": 5e-4, "granite-3-8b": 2e-4, "starcoder2-15b": 2e-4,
       "mamba2-370m": 2e-4, "dbrx-132b": 2e-4, "llama4-scout-17b-a16e": 2e-4}
DENSE = ("gemma-2b", "gemma2-2b", "granite-3-8b", "starcoder2-15b")
MOE = ("dbrx-132b", "llama4-scout-17b-a16e")
ROUTES = (None, "chunked", "kernel")
# (arch, route): every dense and MoE arch on every route; mamba2 has no
# attention, so two routes show that the route leaves it alone
PREFILL_CASES = [(a, r) for a in DENSE for r in ROUTES] + \
    [("mamba2-370m", None), ("mamba2-370m", "kernel")] + [(a, r) for a in MOE for r in ROUTES]
FORWARD_CASES = [(a, r) for a in (*DENSE, "mamba2-370m") for r in (None, "kernel")] + \
    [(a, r) for a in MOE for r in ROUTES]
# port route -> the reference's `attn` logical rule
JAX_RULE = {None: None, "chunked": "chunked", "kernel": "pallas"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced models gain nothing from intra-op threads; one keeps a
    parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rules(route):
    rule = JAX_RULE[route]
    if rule is None:
        return contextlib.nullcontext()
    return logical_axis_rules(None, {"attn": rule})


@functools.lru_cache(maxsize=None)
def _jax_pair(arch: str, **overrides):
    cfg = dataclasses.replace(jax_get_config(arch).reduced(), **overrides)
    jm = JaxModel(cfg)
    return jm, jm.init(jax.random.PRNGKey(0), max_seq=64)


def _models(arch, route, **overrides):
    jm, jp = _jax_pair(arch, **overrides)
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, Model(cfg, attn=route, device="cpu"), tp


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def _pad_jax_cache(cache, prefilled, length):
    """KV leaves (G, B, S, ...) padded from ``prefilled`` to ``length``
    positions; Mamba2 state leaves, whose axis 2 is W-1 or nh, are kept
    (the reference's smoke test's rule)."""
    def pad(leaf):
        if leaf.ndim < 3 or leaf.shape[2] != prefilled:
            return leaf
        pw = [(0, 0)] * leaf.ndim
        pw[2] = (0, length - leaf.shape[2])
        return jnp.pad(leaf, pw)
    return jax.tree.map(pad, cache)


def _torch_cache(model, pre, batch, length):
    cache = model.init_cache(batch, length)
    for name, leaves in pre.items():
        for leaf, x in leaves.items():
            cache[name][leaf][:, :, :x.shape[2]] = x
    return cache


def _prefill_then_decode(arch, route, *, steps=4, b=2, s=16, max_len=32, **overrides):
    jm, jp, tm, tp = _models(arch, route, **overrides)
    tol = TOL[arch]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tm.cfg.vocab_size, (b, s))
    with _rules(route):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, tol)
    jc = _pad_jax_cache(jc, s, max_len)
    tc = _torch_cache(tm, tc, b, max_len)
    pos = np.full(b, s)
    for _ in range(steps):
        step = rng.integers(0, tm.cfg.vocab_size, b)
        jl, jc = jm.decode_step(jp, jnp.asarray(step, jnp.int32), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, torch.from_numpy(step), tc, torch.from_numpy(pos))
        assert tl.shape == (b, tm.cfg.vocab_size)
        _close(tl, jl, tol)
        pos = pos + 1


@pytest.mark.parametrize("arch,route", PREFILL_CASES)
def test_prefill_and_decode_logits_match_jax(arch, route):
    _prefill_then_decode(arch, route)


@pytest.mark.parametrize("arch,route", FORWARD_CASES)
def test_forward_logits_match_jax(arch, route):
    jm, jp, tm, tp = _models(arch, route)
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab_size, (2, 16))
    with _rules(route):
        jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, TOL[arch])
    aux = taux["moe_aux"]
    assert aux.shape == () and aux.dtype == torch.float32
    _close(aux, jaux["moe_aux"], 1e-5)
    if arch in MOE:
        # the reference's smoke check (tests/test_models_smoke.py): finite, >= 0
        assert torch.isfinite(aux) and float(aux) >= 0.0
    else:
        assert float(aux) == 0.0


def test_int8_kv_cache_decode_matches_jax():
    _prefill_then_decode("gemma-2b", "kernel", kv_quant=True)


def test_ring_kv_cache_decode_matches_jax():
    """Local layers keep a window-long ring cache; decode from an empty
    cache past the window so the writes wrap."""
    jm, jp, tm, tp = _models("gemma2-2b", None, kv_ring=True)
    b, max_len = 2, 32
    jc, tc = jm.init_cache(b, max_len), tm.init_cache(b, max_len)
    assert tc["layer0"]["k"].shape[2] == tm.cfg.local_window < max_len
    rng = np.random.default_rng(3)
    for p in range(12):
        step = rng.integers(0, tm.cfg.vocab_size, b)
        pos = np.full(b, p)
        jl, jc = jm.decode_step(jp, jnp.asarray(step, jnp.int32), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, torch.from_numpy(step), tc, torch.from_numpy(pos))
        _close(tl, jl, TOL["gemma2-2b"])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    ref = jax_layers.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    out = layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    _close(out, ref, 1e-6)


def test_rope_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = np.arange(9) + 30
    ref = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    out = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("mlp_type", ["geglu", "swiglu", "gelu"])
def test_mlp_matches_jax(mlp_type):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    p = {k: (rng.standard_normal(shape) / 8).astype(np.float32)
         for k, shape in (("w_up", (32, 48)), ("w_gate", (32, 48)), ("w_down", (48, 32)))}
    ref = jax_layers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), mlp_type)
    out = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), mlp_type)
    _close(out, ref, 1e-5)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def test_bf16_parameters_carry_across_bit_for_bit():
    cfg = jax_get_config("gemma-2b").reduced()
    bf = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = JaxModel(bf).init(jax.random.PRNGKey(1), max_seq=32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), get_config("gemma-2b").reduced(),
                           device="cpu")
    ref = np.asarray(jp["blocks"]["layer0"]["mixer"]["wq"]).view(np.uint16)
    got = tp["blocks"]["layer0"]["mixer"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), ref)


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-370m", *MOE, "jamba-1.5-large-398b",
                                  "whisper-small", "internvl2-76b"])
def test_port_init_is_seeded_and_shaped_like_jax(arch):
    """Every leaf's path and shape at the reference's ``max_seq`` (the
    learned position tables': whisper's decoder and encoder)."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu")
    a = model.init(torch.Generator().manual_seed(0), max_seq=64)
    b = model.init(torch.Generator().manual_seed(0), max_seq=64)
    _, jp = _jax_pair(arch)
    flat_t = jax.tree_util.tree_flatten_with_path(a)[0]
    shapes_j = {jax.tree_util.keystr(k): v.shape
                for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert {jax.tree_util.keystr(k): tuple(v.shape) for k, v in flat_t} == shapes_j
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_model_rejects_unported_families_and_missing_cuda():
    """No family is left unported: every config of the reference builds,
    the hybrid (jamba), encoder-decoder (whisper) and frontend (internvl2)
    ones too, and a dense stack with learned positions.  An unknown
    attention route and a missing CUDA device are still refused."""
    cfg = get_config("gemma-2b").reduced()
    for arch in ("jamba-1.5-large-398b", "whisper-small", "internvl2-76b", "dbrx-132b"):
        ref = jax_get_config(arch).reduced()
        Model(ModelConfig(**dataclasses.asdict(ref)), device="cpu")
    learned = Model(dataclasses.replace(cfg, use_rope=False), device="cpu")
    assert learned.init(torch.Generator().manual_seed(0), max_seq=32)["pos_embed"].shape == \
        (32, cfg.d_model)
    with pytest.raises(ValueError):
        Model(cfg, attn="pallas", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Model(cfg)
