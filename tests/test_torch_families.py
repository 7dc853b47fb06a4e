"""The last three families of the reference against the JAX package, with
the JAX parameters carried across by ``repro_torch.models.convert`` and
the same numpy inputs given to both packages.

- Reduced jamba-1.5-large-398b, the hybrid: one 8-layer unit of (attn,
  moe), (ssm, dense), (ssm, moe), ... stacked twice, so an ssm mixer meets
  both FFNs; prefill, decode and forward on every attention route, and
  forward's ``moe_aux`` (the four MoE layers of each unit, summed).
- Reduced whisper-small, the encoder-decoder: learned positions, a
  bidirectional encoder, cross-attention whose K and V take ``n_heads``
  heads where self-attention takes ``n_kv_heads`` (4 against 2 here);
  ``encode``, forward, prefill (self and cross caches) and decode.
- Reduced internvl2-76b behind its stub vision prefix: forward, prefill
  and decode with ``prefix_embeds``.

The stub frontends draw with ``jax.random`` in the reference, which the
port cannot replay: both packages get the same numpy ``prefix_embeds``
and ``enc_frames``.  The reference's ``test_prefill_then_decode_matches_forward``
(tests/test_models_smoke.py) runs on the port over every config of
``list_configs()``, at its bands.  Whisper cannot be served by the engine,
in the reference (its prefill passes only tokens) as in the port."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config, list_configs
from repro_torch.models import Model
from repro_torch.models import frontends
from repro_torch.serving import EngineConfig, InferenceEngine
from test_torch_model import _close, _models, _pad_jax_cache, _rules, _torch_cache

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4
JAMBA, WHISPER, INTERNVL = "jamba-1.5-large-398b", "whisper-small", "internvl2-76b"
ROUTES = (None, "chunked", "kernel")
ENC_FRAMES = 24        # the encoder's length, apart from the decoder's 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced models gain nothing from intra-op threads; one keeps a
    parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _extras(cfg, b: int, seed: int) -> dict:
    """The stub frontends' inputs for ``cfg`` as numpy: N(0, 1) x 0.02,
    the stubs' scale."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "vision_stub":
        out["prefix_embeds"] = rng.standard_normal((b, cfg.frontend_len, cfg.d_model)) * 0.02
    if cfg.is_encdec:
        out["enc_frames"] = rng.standard_normal((b, ENC_FRAMES, cfg.d_model)) * 0.02
    return {k: v.astype(np.float32) for k, v in out.items()}


def _batches(toks, extras):
    jb = {"tokens": jnp.asarray(toks, jnp.int32), **{k: jnp.asarray(v) for k, v in extras.items()}}
    tb = {"tokens": torch.from_numpy(toks), **{k: torch.from_numpy(v) for k, v in extras.items()}}
    return jb, tb


def _prefill_then_decode(arch, route, *, steps=4, b=2, s=16, max_len=40):
    """Prefill on ``s`` tokens (after the prefix, if any), every cache leaf
    held against the reference's, then ``steps`` decode steps."""
    jm, jp, tm, tp = _models(arch, route)
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    jb, tb = _batches(toks, _extras(cfg, b, 7))
    with _rules(route):
        jl, jc = jm.prefill(jp, jb)
    tl, tc = tm.prefill(tp, tb)
    _close(tl, jl, TOL)
    extra = cfg.frontend_len if cfg.frontend == "vision_stub" else 0
    assert tl.shape == (b, s + extra, cfg.vocab_size)
    jself, tself = (jc["self"], tc["self"]) if cfg.is_encdec else (jc, tc)
    for name, leaves in tself.items():
        for leaf, x in leaves.items():
            _close(x, jself[name][leaf], TOL)
    if cfg.is_encdec:
        assert set(tc) == {"self", "cross"} and set(tc["cross"]) == {"k", "v"}
        for leaf in ("k", "v"):
            assert tc["cross"][leaf].shape == (cfg.n_layers, b, ENC_FRAMES, cfg.n_heads,
                                               cfg.resolved_head_dim)
            _close(tc["cross"][leaf], jc["cross"][leaf], TOL)
    jself = _pad_jax_cache(jself, s + extra, max_len)
    tself = _torch_cache(tm, tself, b, max_len)
    jc = {"self": jself, "cross": jc["cross"]} if cfg.is_encdec else jself
    tc = {"self": tself, "cross": tc["cross"]} if cfg.is_encdec else tself
    pos = np.full(b, s + extra)
    for _ in range(steps):
        step = rng.integers(0, cfg.vocab_size, b)
        jl, jc = jm.decode_step(jp, jnp.asarray(step, jnp.int32), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, torch.from_numpy(step), tc, torch.from_numpy(pos))
        assert tl.shape == (b, cfg.vocab_size)
        _close(tl, jl, TOL)
        pos = pos + 1


def _forward(arch, route):
    jm, jp, tm, tp = _models(arch, route)
    cfg = tm.cfg
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16))
    jb, tb = _batches(toks, _extras(cfg, 2, 8))
    with _rules(route):
        jl, jaux = jm.forward(jp, jb)
    tl, taux = tm.forward(tp, tb)
    _close(tl, jl, TOL)
    _close(taux["moe_aux"], jaux["moe_aux"], 1e-5)
    return taux["moe_aux"]


@pytest.mark.parametrize("route", ROUTES)
def test_jamba_prefill_and_decode_match_jax(route):
    _prefill_then_decode(JAMBA, route)


@pytest.mark.parametrize("route", ROUTES)
def test_jamba_forward_and_moe_aux_match_jax(route):
    aux = _forward(JAMBA, route)
    assert torch.isfinite(aux) and float(aux) > 0.0


def test_jamba_moe_aux_sums_every_moe_layer_of_every_unit():
    """One MoE FFN a second layer: four of each 8-layer unit, in both
    groups; with every router zeroed every expert's probability is 1/E,
    so each layer's loss, E x sum_e f_e x 1/E, is 1."""
    cfg = get_config(JAMBA).reduced()
    plan = cfg.layer_plan()
    assert cfg.scan_unit() == 8 and cfg.n_layers == 16
    assert plan[:4] == (("attn", "moe"), ("ssm", "dense"), ("ssm", "moe"), ("ssm", "dense"))
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0), max_seq=64)
    for j, (_, ffn) in enumerate(model._unit_plan()):
        if ffn == "moe":
            params["blocks"][f"layer{j}"]["ffn"]["router"].zero_()
    _, aux = model.forward(params, {"tokens": torch.arange(16).reshape(1, 16)})
    n_moe = sum(ffn == "moe" for _, ffn in plan)
    assert n_moe == 8
    _close(aux["moe_aux"], np.float32(n_moe), 1e-6)


@pytest.mark.parametrize("route", (None, "kernel"))
def test_whisper_prefill_and_decode_match_jax(route):
    _prefill_then_decode(WHISPER, route)


@pytest.mark.parametrize("route", (None, "kernel"))
def test_whisper_encode_and_forward_match_jax(route):
    jm, jp, tm, tp = _models(WHISPER, route)
    frames = _extras(tm.cfg, 2, 9)["enc_frames"]
    with _rules(route):
        ref = jm.encode(jp, jnp.asarray(frames))
    out = tm.encode(tp, torch.from_numpy(frames))
    assert out.shape == (2, ENC_FRAMES, tm.cfg.d_model)
    _close(out, ref, TOL)
    _forward(WHISPER, route)


@pytest.mark.parametrize("route", (None, "kernel"))
def test_internvl2_prefix_prefill_and_decode_match_jax(route):
    _prefill_then_decode(INTERNVL, route)


@pytest.mark.parametrize("route", (None, "kernel"))
def test_internvl2_prefix_forward_matches_jax(route):
    _forward(INTERNVL, route)


def test_cross_attention_takes_n_heads_and_the_encoder_no_kernel(monkeypatch):
    """Cross K/V take ``n_heads`` heads (self-attention ``n_kv_heads``); on
    the kernel route only the decoder's causal self-attention reaches the
    flash-attention wrapper, once a layer: the encoder and the
    cross-attention run the plain sdpa."""
    from repro_torch.models import attention
    cfg = get_config(WHISPER).reduced()
    assert cfg.n_kv_heads < cfg.n_heads
    model = Model(cfg, attn="kernel", device="cpu")
    params = model.init(torch.Generator().manual_seed(0), max_seq=64)
    hd = cfg.resolved_head_dim
    assert params["blocks"]["layer0"]["cross"]["wk"].shape == (cfg.n_layers, cfg.d_model,
                                                               cfg.n_heads * hd)
    assert params["blocks"]["layer0"]["mixer"]["wk"].shape == (cfg.n_layers, cfg.d_model,
                                                               cfg.n_kv_heads * hd)
    calls = []
    kernel = attention.flash_attention

    def counting(q, k, v, **kw):
        calls.append((q.shape, k.shape, kw["causal"]))
        return kernel(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention", counting)
    frames = torch.from_numpy(_extras(cfg, 1, 3)["enc_frames"])
    model.prefill(params, {"tokens": torch.arange(16)[None], "enc_frames": frames})
    assert calls == [((1, 16, cfg.n_heads, hd), (1, 16, cfg.n_kv_heads, hd), True)] * \
        cfg.n_layers


def test_convert_carries_the_encoder_and_checks_its_depth():
    """``params_from_numpy`` carries whisper's encoder, learned positions
    and cross-attention leaves as they are, and refuses an encoder whose
    stacked depth is not ``n_encoder_layers`` or a tree without one."""
    from repro_torch.models.convert import params_from_numpy
    _, jp, _, tp = _models(WHISPER, None)
    cfg = get_config(WHISPER).reduced()
    tree = jax.tree.map(np.asarray, jp)
    for path in (("pos_embed",), ("encoder", "pos_embed"),
                 ("encoder", "blocks", "layer0", "mixer", "wk"),
                 ("blocks", "layer0", "cross", "wv")):
        j, t_ = tree, tp
        for k in path:
            j, t_ = j[k], t_[k]
        np.testing.assert_array_equal(t_.numpy(), j)
    cut = jax.tree.map(lambda x: x[:1], tree["encoder"]["blocks"])
    with pytest.raises(ValueError, match="encoder"):
        params_from_numpy({**tree, "encoder": {**tree["encoder"], "blocks": cut}}, cfg,
                          device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        params_from_numpy({k: v for k, v in tree.items() if k != "encoder"}, cfg,
                          device="cpu")


# ---------------------------------------------------------------------------
# every config of list_configs(): the reference's smoke check on the port
# ---------------------------------------------------------------------------

def test_port_carries_the_references_ten_configs():
    from repro.configs import list_configs as jax_list_configs
    assert list_configs() == jax_list_configs() and len(list_configs()) == 10
    for arch in list_configs():
        ref = dataclasses.asdict(jax_get_config(arch))
        assert dataclasses.asdict(get_config(arch)) == ref
        Model(get_config(arch).reduced(), device="cpu")


@pytest.mark.parametrize("arch", list_configs())
def test_prefill_then_decode_matches_forward(arch):
    """tests/test_models_smoke.py's check, on the port's own parameters:
    prefill on s - 4 tokens within 2e-2 of forward, then 4 teacher-forced
    decode steps each within 5e-2 of forward at its position."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(2), max_seq=64)
    b, s = 2, 16
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s))
    rng = np.random.default_rng(4)
    extras = {}
    if cfg.frontend == "vision_stub":
        extras["prefix_embeds"] = rng.standard_normal((b, cfg.frontend_len, cfg.d_model))
    if cfg.is_encdec:
        extras["enc_frames"] = rng.standard_normal((b, s, cfg.d_model))
    extras = {k: torch.from_numpy(v.astype(np.float32)) for k, v in extras.items()}
    tokens = torch.from_numpy(toks)
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": tokens, **extras})
        split = s - 4
        logits_p, cache = model.prefill(params, {"tokens": tokens[:, :split], **extras})
        extra = cfg.frontend_len if cfg.frontend == "vision_stub" else 0
        _close(logits_p, full[:, :split + extra].numpy(), 2e-2)
        max_len = s + extra + 8
        self_cache = _torch_cache(model, cache["self"] if cfg.is_encdec else cache, b,
                                  max_len)
        cache = {"self": self_cache, "cross": cache["cross"]} if cfg.is_encdec else self_cache
        for i in range(split, s):
            pos = torch.full((b,), i + extra)
            logits_d, cache = model.decode_step(params, tokens[:, i], cache, pos)
            _close(logits_d, full[:, i + extra].numpy(), 5e-2)


# ---------------------------------------------------------------------------
# the frontends and the engine
# ---------------------------------------------------------------------------

def test_frontend_stubs_shapes_dtype_scale_and_generator():
    vis = dataclasses.replace(get_config(INTERNVL), compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = frontends.vision_patches(vis, 2, generator=gen)
    assert p.shape == (2, vis.frontend_len, vis.d_model) and p.dtype == torch.float32
    assert abs(float(p.std()) - 0.02) < 1e-3
    again = frontends.vision_patches(vis, 2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(p, again)
    aud = get_config(WHISPER)
    f = frontends.audio_frames(aud, 1, 1500, generator=torch.Generator().manual_seed(1))
    assert f.shape == (1, 1500, aud.d_model) and f.dtype == torch.bfloat16
    assert abs(float(f.float().std()) - 0.02) < 1e-3
    with pytest.raises(AssertionError):
        frontends.audio_frames(vis, 1, 4, generator=gen)
    with pytest.raises(AssertionError):
        frontends.vision_patches(aud, 1, generator=gen)


def test_whisper_is_not_served_by_the_engine():
    """The reference's engine prefills with tokens alone, so whisper fails
    there for want of the encoder's frames; the port's engine refuses it
    when built, naming the encoder, and so does the launcher.  A
    full-sequence call without frames names them too."""
    jcfg = jax_get_config(WHISPER).reduced()
    jm = JaxModel(jcfg)
    jeng = JaxEngine(jm, jm.init(jax.random.PRNGKey(0), max_seq=64),
                     JaxEngineConfig(max_slots=1, max_len=32, prefill_buckets=(8,)))
    jeng.submit([JaxRequest(prompt=[1, 2, 3], max_new_tokens=2)])
    with pytest.raises(KeyError, match="enc_frames"):
        jeng.pump()

    cfg = get_config(WHISPER).reduced()
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0), max_seq=64)
    with pytest.raises(NotImplementedError, match="encoder"):
        InferenceEngine(model, params, EngineConfig(max_slots=1, max_len=32,
                                                    prefill_buckets=(8,)))
    with pytest.raises(ValueError, match="enc_frames"):
        model.prefill(params, {"tokens": torch.ones((1, 8), dtype=torch.long)})
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", WHISPER, "--smoke",
         "--device", "cpu", "--requests", "2"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"})
    assert proc.returncode != 0 and "completed=" not in proc.stdout
    assert "encoder" in proc.stderr
