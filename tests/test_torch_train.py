"""The port's training path (``repro_torch.train``, ``launch.train``)
against the JAX package's on the CPU, with the same numpy inputs and the
reference's parameters carried across by ``models.convert``.

- AdamW: ``apply_updates`` on the same params, grads and state, f32 and
  bf16 moments, clipping on and off, within 1e-6 relative (ports of
  ``test_adamw_*`` and ``test_moment_dtype_bf16``).
- Loss and gradients of all ten reduced configs (``prefix_embeds`` /
  ``enc_frames`` where the config has a frontend): loss within 2e-4
  relative, each gradient leaf within 1e-3 of its largest magnitude,
  ``moe_aux`` within 1e-5; remat changes no gradient.
- Gradient accumulation (a port of
  ``test_grad_accumulation_matches_full_batch``) and five-step
  trajectories (loss within 1e-4 relative a step, parameters within
  2e-3 after five).
- Data bit for bit; checkpoints both ways bit for bit, a JAX run continued
  in the port; crash and restart exact; int8 quantization; the refused
  frontends; the launcher.
"""

import dataclasses
import functools
import io
import os
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import train as jtrain
from repro.configs import get_config as jax_get_config
from repro.configs import list_configs
from repro.models import Model as JaxModel
from repro_torch import train as ttrain
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.models.convert import opt_from_numpy, params_from_numpy
from repro_torch.train import steps as tsteps
from repro_torch.train.loop import frontend_input, meta_params
from repro_torch.train.tree import tree_leaves

TINY_FIELDS = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
                   vocab_size=211)
ENC_FRAMES = 16
LOSS_RTOL = 2e-4
GRAD_TOL = 1e-3
AUX_TOL = 1e-5
TRAJ_LOSS_RTOL = 1e-4
TRAJ_PARAM_TOL = 2e-3
OPT_RTOL = 1e-6
# moment dtype, clip: clipping binds at 1.0 (the grads' norm is ~30)
OPT_CASES = [("float32", 1e9), ("float32", 1.0), ("bfloat16", 1e9), ("bfloat16", 1.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced models gain nothing from intra-op threads; one keeps a
    parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str, **overrides):
    """(reference config, port config): reduced ``arch`` with ``overrides``;
    ``arch`` ``"tiny"`` is the reference's training tests' TINY."""
    if arch == "tiny":
        arch, overrides = "granite-3-8b", {**TINY_FIELDS, **overrides}
    return (dataclasses.replace(jax_get_config(arch).reduced(), **overrides),
            dataclasses.replace(get_config(arch).reduced(), **overrides))


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    jcfg, _ = _cfgs(arch)
    return JaxModel(jcfg).init(jax.random.PRNGKey(0), max_seq=64)


def _models(arch: str):
    jcfg, tcfg = _cfgs(arch)
    jp = _jax_params(arch)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return JaxModel(jcfg), jp, Model(tcfg, device="cpu"), tp


def _batch(cfg, b: int, s: int, seed: int) -> dict:
    """Numpy tokens and next-token labels, and the config's frontend input."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    key = frontend_input(cfg)
    if key == "prefix_embeds":
        out[key] = (rng.standard_normal((b, cfg.frontend_len, cfg.d_model)) * 0.02
                    ).astype(np.float32)
    elif key == "enc_frames":
        out[key] = (rng.standard_normal((b, ENC_FRAMES, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _pairs(jtree, ttree):
    """(path, reference leaf as f32 numpy, port leaf as f32 numpy)."""
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tleaves = tree_leaves(ttree)
    assert len(jflat) == len(tleaves)
    return [(jax.tree_util.keystr(path), np.asarray(j, np.float32),
             t.detach().float().numpy()) for (path, j), t in zip(jflat, tleaves)]


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _opt_inputs(moment_dtype):
    rng = np.random.default_rng(4)
    shapes = {"w": (16, 8), "b": (8,), "blocks": {"a": (3, 5, 7), "s": (4,)}}

    def draw(scale):
        def one(shape):
            return (rng.standard_normal(shape) * scale).astype(np.float32)
        return jax.tree.map(one, shapes, is_leaf=lambda x: isinstance(x, tuple))
    params, grads = draw(1.0), draw(3.0)
    # a second step from moments that are not zero
    m, v = draw(0.1), jax.tree.map(np.abs, draw(0.5))
    dt = np.float32 if moment_dtype == "float32" else jnp.bfloat16
    m = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, dt)), m)
    v = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, dt)), v)
    return params, grads, {"m": m, "v": v, "count": np.int32(1)}


def _rel_close(t, j, rtol, msg):
    """Within ``rtol`` of each reference value, or of the leaf's largest
    magnitude where a value is small beside it (the clip scale's last bit,
    carried through a moment's cancellation, moves such a value)."""
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * np.abs(j).max(), err_msg=msg)


def _to_torch(tree):
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(leaf, tree)


@pytest.mark.parametrize("moment_dtype,clip", OPT_CASES)
def test_apply_updates_matches_jax(moment_dtype, clip):
    cfg = ttrain.OptConfig(lr=1e-2, moment_dtype=moment_dtype, grad_clip=clip)
    jcfg = jtrain.OptConfig(lr=1e-2, moment_dtype=moment_dtype, grad_clip=clip)
    params, grads, state = _opt_inputs(moment_dtype)
    jp, js, jn = jtrain.apply_updates(jax.tree.map(jnp.asarray, params),
                                      jax.tree.map(jnp.asarray, grads),
                                      jax.tree.map(jnp.asarray, state), jcfg)
    tp, ts = _to_torch(params), _to_torch(state)
    same_p, same_m = tp["w"], ts["m"]["w"]
    tp, ts, tn = ttrain.apply_updates(tp, _to_torch(grads), ts, cfg)
    assert tp["w"] is same_p and ts["m"]["w"] is same_m          # in place
    assert int(ts["count"]) == int(js["count"]) == 2
    np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_RTOL)
    if clip == 1.0:
        assert float(tn) > 10.0                      # the clip binds
    for name in ("m", "v"):
        assert ts[name]["w"].dtype == {"float32": torch.float32,
                                       "bfloat16": torch.bfloat16}[moment_dtype]
        for path, j, t in _pairs(js[name], ts[name]):
            _rel_close(t, j, OPT_RTOL, f"{name} {path}")
    for path, j, t in _pairs(jp, tp):
        _rel_close(t, j, OPT_RTOL, path)


def test_adamw_matches_reference_formula():
    params = {"w": torch.tensor([1.0, -2.0, 3.0])}
    grads = {"w": torch.tensor([0.1, 0.2, -0.3])}
    cfg = ttrain.OptConfig(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                           grad_clip=1e9)
    new_p, _, gnorm = ttrain.apply_updates(params, grads, ttrain.init_opt(params, cfg), cfg)
    g = np.array([0.1, 0.2, -0.3])
    mhat = 0.1 * g / (1 - 0.9)
    vhat = 0.001 * g * g / (1 - 0.999)
    expect = np.array([1.0, -2.0, 3.0]) - 0.1 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), expect, rtol=1e-5)
    assert float(gnorm) == pytest.approx(np.linalg.norm(g), rel=1e-5)


def test_update_slices_a_large_leaf_alike(monkeypatch):
    """A leaf updated a slice of its leading axis at a time gives the
    whole-leaf update bit for bit."""
    rng = np.random.default_rng(5)
    p0 = {"e": torch.from_numpy(rng.standard_normal((37, 11)).astype(np.float32))}
    g = {"e": torch.from_numpy(rng.standard_normal((37, 11)).astype(np.float32))}
    cfg = ttrain.OptConfig(lr=1e-2)
    out = []
    for elements in (1 << 26, 20):
        monkeypatch.setattr(ttrain.optimizer, "_SLICE_ELEMENTS", elements)
        p = {"e": p0["e"].clone()}
        ttrain.apply_updates(p, g, ttrain.init_opt(p, cfg), cfg)
        out.append(p["e"])
    assert torch.equal(out[0], out[1])


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_configs())
def test_loss_and_grads_match_jax(arch):
    jm, jp, tm, tp = _models(arch)
    batch = _batch(tm.cfg, 2, 16, seed=7)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jtrain.make_loss_fn(jm, remat=False),
                                                has_aux=True))(jp, _jax_batch(batch))
    (tl, taux), tg = tsteps._value_and_grad(ttrain.make_loss_fn(tm, remat=False), tp,
                                            _torch_batch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(taux["moe_aux"]), float(jaux["moe_aux"]), atol=AUX_TOL)
    if tm.cfg.n_experts:
        assert float(taux["moe_aux"]) > 0
    for path, j, t in _pairs(jg, tg):
        np.testing.assert_allclose(t, j, rtol=0, atol=GRAD_TOL * max(np.abs(j).max(), 1e-30),
                                   err_msg=path)


def test_mamba2_grads_stay_finite_at_the_published_chunk():
    """At mamba2-370m's chunk of 256 the reference's gradient is NaN (its
    ``_segsum_exp`` takes exp of the masked entries, which overflow, and
    the backward meets 0 * inf); the port's loss is the reference's and
    its gradient finite, equal to the reference's on every leaf the NaN
    does not reach."""
    jcfg, tcfg = _cfgs("mamba2-370m", ssm_chunk=256, n_layers=1)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), max_seq=64)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    batch = _batch(tcfg, 1, 256, seed=0)
    (jl, _), jg = jax.jit(jax.value_and_grad(jtrain.make_loss_fn(jm, remat=False),
                                             has_aux=True))(jp, _jax_batch(batch))
    (tl, _), tg = tsteps._value_and_grad(ttrain.make_loss_fn(Model(tcfg, device="cpu"),
                                                             remat=False), tp,
                                         _torch_batch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    pairs = _pairs(jg, tg)
    assert any(np.isnan(j).any() for _, j, _ in pairs)          # the reference's NaN
    for path, j, t in pairs:
        assert np.isfinite(t).all(), path
        if np.isfinite(j).all():
            np.testing.assert_allclose(t, j, rtol=0, atol=GRAD_TOL * max(np.abs(j).max(), 1e-30),
                                       err_msg=path)


@pytest.mark.parametrize("arch", list_configs())
def test_remat_gives_the_same_gradients(arch):
    _, _, tm, tp = _models(arch)
    batch = _torch_batch(_batch(tm.cfg, 2, 16, seed=8))
    (l0, _), g0 = tsteps._value_and_grad(ttrain.make_loss_fn(tm, remat=False), tp, batch)
    (l1, _), g1 = tsteps._value_and_grad(ttrain.make_loss_fn(tm, remat=True), tp, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_grads_keep_the_parameter_dtype_and_leave_params_alone():
    _, tcfg = _cfgs("tiny", param_dtype="bfloat16", compute_dtype="bfloat16")
    model = Model(tcfg, device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0), max_seq=32)
    batch = _torch_batch(_batch(tcfg, 2, 8, seed=1))
    _, grads = tsteps._value_and_grad(ttrain.make_loss_fn(model), params, batch)
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert not p.requires_grad and p.grad is None


# ---------------------------------------------------------------------------
# train steps: accumulation, trajectories
# ---------------------------------------------------------------------------

def _jax_steps(jm, jp, opt, batches, accum_steps=1):
    step = jax.jit(jtrain.make_train_step(jm, opt, remat=False, accum_steps=accum_steps))
    state, losses = jtrain.init_opt(jp, opt), []
    for b in batches:
        jp, state, metrics = step(jp, state, _jax_batch(b))
        losses.append(float(metrics["loss"]))
    return jp, state, losses


def _torch_steps(tm, tp, opt, batches, accum_steps=1, state=None):
    step = ttrain.make_train_step(tm, opt, remat=False, accum_steps=accum_steps)
    state, losses = state or ttrain.init_opt(tp, opt), []
    for b in batches:
        tp, state, metrics = step(tp, state, _torch_batch(b))
        losses.append(float(metrics["loss"]))
    return tp, state, losses


def test_grad_accumulation_matches_full_batch_and_jax():
    """accum_steps=4 gives the full batch's update (equal microbatches, f32
    sums) in the port, and the reference's accumulated update."""
    jm, jp, tm, tp0 = _models("tiny")
    batch = _batch(tm.cfg, 4, 16, seed=3)
    kw = dict(lr=1e-2, weight_decay=0.0, grad_clip=1e9)
    full, _, lf = _torch_steps(tm, _models("tiny")[3], ttrain.OptConfig(**kw), [batch])
    acc, _, la = _torch_steps(tm, tp0, ttrain.OptConfig(**kw), [batch], accum_steps=4)
    np.testing.assert_allclose(la, lf, rtol=1e-5)
    for a, b in zip(tree_leaves(acc), tree_leaves(full)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-3)
    jacc, _, jla = _jax_steps(jm, jp, jtrain.OptConfig(**kw), [batch], accum_steps=4)
    np.testing.assert_allclose(la, jla, rtol=1e-5)
    for path, j, t in _pairs(jacc, acc):
        np.testing.assert_allclose(t, j, rtol=2e-3, atol=2e-3, err_msg=path)


@pytest.mark.parametrize("arch", ["tiny", "gemma-2b", "mamba2-370m", "dbrx-132b"])
def test_five_step_trajectory_matches_jax(arch):
    jm, jp, tm, tp = _models(arch)
    ds = jtrain.TokenDataset(tm.cfg.vocab_size, 16, 2, seed=2)
    batches = [ds.batch(i) for i in range(5)]
    kw = dict(lr=1e-3, moment_dtype=tm.cfg.moment_dtype)
    jp, js, jl = _jax_steps(jm, jp, jtrain.OptConfig(**kw), batches)
    tp, ts, tl = _torch_steps(tm, tp, ttrain.OptConfig(**kw), batches)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_LOSS_RTOL)
    assert tl[-1] < tl[0]
    for path, j, t in _pairs(jp, tp):
        np.testing.assert_allclose(t, j, rtol=TRAJ_PARAM_TOL, atol=TRAJ_PARAM_TOL, err_msg=path)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7), (11, 123456)])
def test_dataset_batches_equal_the_references(seed, step):
    mine = ttrain.TokenDataset(vocab_size=503, seq_len=16, global_batch=4, seed=seed)
    ref = jtrain.TokenDataset(vocab_size=503, seq_len=16, global_batch=4, seed=seed)
    for key in ("tokens", "labels"):
        got, want = mine.batch(step)[key], ref.batch(step)[key]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_prefetcher_delivers_in_order_and_seeks():
    ds = ttrain.TokenDataset(vocab_size=101, seq_len=8, global_batch=2, seed=1)
    pf = ttrain.HostPrefetcher(ds, start_step=5, depth=3)
    try:
        for step in (5, 6, 7, 42):
            np.testing.assert_array_equal(pf.get(step)["tokens"], ds.batch(step)["tokens"])
    finally:
        pf.stop()
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.randn(4).to(torch.bfloat16), "n": torch.tensor(3, dtype=torch.int32)}}
    ttrain.save_checkpoint(str(tmp_path), 5, tree, extra={"loss": 1.5})
    assert ttrain.latest_step(str(tmp_path)) == 5
    like = {"a": torch.empty(2, 3, device="meta"),
            "b": {"c": torch.empty(4, dtype=torch.bfloat16, device="meta"),
                  "n": torch.empty((), dtype=torch.int32, device="meta")}}
    restored, meta = ttrain.restore_checkpoint(str(tmp_path), 5, like, device="cpu")
    assert meta["step"] == 5 and meta["extra"] == {"loss": 1.5} and meta["n_leaves"] == 3
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert torch.equal(restored["b"]["n"], tree["b"]["n"])
    with pytest.raises(ValueError, match="meta"):
        ttrain.restore_checkpoint(str(tmp_path), 5, like)


def test_checkpoint_detects_tree_and_shape_mismatch(tmp_path):
    ttrain.save_checkpoint(str(tmp_path), 1, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="mismatch"):
        ttrain.restore_checkpoint(str(tmp_path), 1, {"zz": torch.ones(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ttrain.restore_checkpoint(str(tmp_path), 1, {"a": torch.ones(4)})


def _jax_state(steps: int, **overrides):
    """Reduced gemma-2b (with ``overrides``) after ``steps`` JAX steps:
    (model, params, optimizer state, the losses)."""
    jcfg, _ = _cfgs("gemma-2b", **overrides)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(1), max_seq=64)
    ds = jtrain.TokenDataset(jcfg.vocab_size, 16, 2, seed=5)
    opt = jtrain.OptConfig(lr=1e-3)
    step = jax.jit(jtrain.make_train_step(jm, opt, remat=False))
    js, losses = jtrain.init_opt(jp, opt), []
    for i in range(steps):
        jp, js, metrics = step(jp, js, _jax_batch(ds.batch(i)))
        losses.append(float(metrics["loss"]))
    return jm, jp, js, losses


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    jm, jp, js, _ = _jax_state(1, param_dtype="bfloat16")
    jtrain.save_checkpoint(str(tmp_path), 1, {"params": jp, "opt": js})
    _, tcfg = _cfgs("gemma-2b", param_dtype="bfloat16")
    like_p = meta_params(tcfg, max_seq=64)
    like = {"params": like_p, "opt": ttrain.init_opt(like_p, ttrain.OptConfig())}
    state, meta = ttrain.restore_checkpoint(str(tmp_path), 1, like, device="cpu")
    assert meta["step"] == 1
    want = {"params": params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu"),
            "opt": opt_from_numpy(jax.tree.map(np.asarray, js), tcfg, device="cpu")}
    got_leaves = tree_leaves(state)
    want_leaves = tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    assert state["params"]["embed"].dtype == torch.bfloat16
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    jm, jp, js, _ = _jax_state(1, param_dtype="bfloat16")
    _, tcfg = _cfgs("gemma-2b", param_dtype="bfloat16")
    tree = {"params": params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu"),
            "opt": opt_from_numpy(jax.tree.map(np.asarray, js), tcfg, device="cpu")}
    ttrain.save_checkpoint(str(tmp_path), 3, tree)
    like = jax.eval_shape(lambda: {"params": jp, "opt": js})
    restored, meta = jtrain.restore_checkpoint(str(tmp_path), 3, like)
    assert meta["step"] == 3
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(restored)[0],
                            jax.tree.leaves({"params": jp, "opt": js})):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                      err_msg=jax.tree_util.keystr(path))


def test_jax_run_continues_in_the_port():
    """Three JAX steps, then two more in JAX and, from the same state
    carried across (params_from_numpy, opt_from_numpy), two in the port."""
    jm, jp, js, jl = _jax_state(5)
    _, jp3, js3, _ = _jax_state(3)
    _, tcfg = _cfgs("gemma-2b")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp3), tcfg, device="cpu")
    ts = opt_from_numpy(jax.tree.map(np.asarray, js3), tcfg, device="cpu")
    assert int(ts["count"]) == 3 and ts["count"].dtype == torch.int32
    ds = jtrain.TokenDataset(tcfg.vocab_size, 16, 2, seed=5)
    _, ts, tl = _torch_steps(Model(tcfg, device="cpu"), tp, ttrain.OptConfig(lr=1e-3),
                             [ds.batch(3), ds.batch(4)], state=ts)
    assert int(ts["count"]) == 5
    np.testing.assert_allclose(tl, jl[3:], rtol=TRAJ_LOSS_RTOL)


# ---------------------------------------------------------------------------
# the loop: restart, loss, refusals, launcher
# ---------------------------------------------------------------------------

def test_train_restart_reproduces_uninterrupted_run(tmp_path):
    """Crash at step 7, restart, and the loss trajectory equals an
    uninterrupted run's exactly (deterministic data, checkpoint/restore)."""
    _, tiny = _cfgs("tiny")
    kw = dict(steps=10, save_every=2, global_batch=2, seq_len=16, device="cpu")
    ref = ttrain.train_loop(tiny, ckpt_dir=str(tmp_path / "ref"), **kw)

    class Boom(RuntimeError):
        pass

    def injector(step):
        if step == 7 and not os.path.exists(tmp_path / "crashed"):
            (tmp_path / "crashed").touch()
            raise Boom("simulated preemption")

    with pytest.raises(Boom):
        ttrain.train_loop(tiny, ckpt_dir=str(tmp_path / "ft"), failure_injector=injector, **kw)
    res = ttrain.train_loop(tiny, ckpt_dir=str(tmp_path / "ft"), failure_injector=injector, **kw)
    assert res["resumed_from"] == 6
    assert res["losses"] == ref["losses"][6:]
    assert ttrain.latest_step(str(tmp_path / "ft")) == 10
    assert res["prefetch_cpu_s"] is not None and res["prefetch_cpu_s"] >= 0


def test_loss_decreases_over_short_run(tmp_path):
    _, tiny = _cfgs("tiny")
    res = ttrain.train_loop(tiny, steps=12, ckpt_dir=str(tmp_path), save_every=50,
                            global_batch=2, seq_len=16, opt_cfg=ttrain.OptConfig(lr=3e-3),
                            device="cpu")
    assert res["losses"][-1] < res["losses"][0]


@pytest.mark.parametrize("arch,key", [("whisper-small", "enc_frames"),
                                      ("internvl2-76b", "prefix_embeds")])
def test_loop_refuses_a_config_whose_loss_needs_a_frontend_input(tmp_path, arch, key):
    """The reference's loop fails on both inside its first step (a
    KeyError for whisper's frames, an einsum shape error for internvl2's
    dropped prefix); the port's refuses them when called, by name."""
    cfg = get_config(arch).reduced()
    with pytest.raises(ValueError, match=key):
        ttrain.train_loop(cfg, steps=2, ckpt_dir=str(tmp_path), device="cpu")
    assert not os.listdir(tmp_path)


def test_launcher_trains_on_the_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(["--arch", "gemma-2b", "--smoke", "--steps", "4", "--seq", "16",
                                "--ckpt", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    line = out.getvalue().strip().splitlines()[-1]
    assert line.startswith("arch=gemma-2b-smoke steps=4 resumed_from=-1 loss ")
    first, last = (float(x) for x in line.split("loss ")[1].split(" -> "))
    assert last < first


def test_launcher_wants_cuda_without_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--arch", "gemma-2b", "--smoke", "--steps", "1",
                           "--ckpt", str(tmp_path)])


# ---------------------------------------------------------------------------
# int8 quantization
# ---------------------------------------------------------------------------

def test_int8_quantization_roundtrip_and_reference_codes():
    x = np.random.RandomState(0).randn(64, 32).astype(np.float32) * 3.0
    q, scale = ttrain.quantize_int8(torch.from_numpy(x))
    y = ttrain.dequantize_int8(q, scale)
    assert q.dtype == torch.int8
    assert float(torch.linalg.norm(y - torch.from_numpy(x)) / np.linalg.norm(x)) < 0.01
    jq, jscale = jtrain.quantize_int8(jnp.asarray(x))
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_int8_stochastic_rounding_is_unbiased():
    """Over 4,000 draws each element's mean code is its exact quotient
    within six standard errors (SR's variance is at most 1/4 a code)."""
    x = torch.from_numpy(np.random.RandomState(1).randn(256).astype(np.float32))
    draws = 4000
    gen = torch.Generator().manual_seed(0)
    q, scale = ttrain.quantize_int8(x.expand(draws, -1).contiguous(), generator=gen)
    exact = (x / scale).double()
    mean = q.double().mean(0)
    assert float((mean - exact).abs().max()) < 6 * 0.5 / draws ** 0.5
    nearest, _ = ttrain.quantize_int8(x)
    assert not torch.equal(q[0], nearest)           # it does round at random
