"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe`` on the same numpy inputs: ``moe_apply`` with each
expert MLP type, with and without llama4's shared expert, at a no-drop
capacity and at the published ``capacity_factor=1.25`` with a skewed
router, where assignments drop (the kept set and its slots equal exactly);
the top-k order on ties; the capacity at the served shapes; and
``moe_init``'s leaves.  f32 throughout, within 1e-5 (sums in another
order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro_torch.configs import get_config
from repro_torch.models import moe

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors gain nothing from intra-op threads; one keeps a
    parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**widths):
    """The same small MoE config in both packages."""
    base = dict(d_model=32, d_ff=48, n_experts=4, experts_per_token=2, n_shared_experts=0,
                mlp_type="swiglu", capacity_factor=1.25)
    base.update(widths)
    return (dataclasses.replace(jax_get_config("dbrx-132b"), **base),
            dataclasses.replace(get_config("dbrx-132b"), **base))


def _params(cfg, seed, skew=0.0):
    """numpy leaves of one MoE layer; ``skew`` adds to the router's first
    column's weights, so that tokens with a positive mean pick expert 0
    and it overflows."""
    rng = np.random.default_rng(seed)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    router = w(d, e)
    router[:, 0] += skew
    p = {"router": router, "w_gate": w(e, d, f), "w_up": w(e, d, f), "w_down": w(e, f, d)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w_gate": w(d, fs), "w_up": w(d, fs), "w_down": w(fs, d)}
    return p


def _jax_tree(p):
    return jax.tree.map(jnp.asarray, p)


def _torch_tree(p):
    return jax.tree.map(torch.from_numpy, p)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _apply_both(jcfg, tcfg, p, x):
    yj, auxj = jax_moe.moe_apply(_jax_tree(p), jcfg, jnp.asarray(x))
    yt, auxt = moe.moe_apply(_torch_tree(p), tcfg, torch.from_numpy(x))
    assert yt.shape == x.shape and yt.dtype == torch.float32
    _close(yt, yj)
    _close(auxt, auxj)
    return yt, auxt


def _plans(jcfg, tcfg, p, x):
    """(eid, slot, keep) of the flat assignments in each package."""
    xf = x.reshape(-1, x.shape[-1])
    cap = max(int(xf.shape[0] * jcfg.experts_per_token / jcfg.n_experts
                  * jcfg.capacity_factor), 1)
    assert moe._capacity(tcfg, xf.shape[0]) == cap
    _, _, idx_j = jax_moe._route(_jax_tree(p), jcfg, jnp.asarray(xf))
    _, pos_j = jax_moe._positions(idx_j, jcfg.n_experts)
    _, _, idx_t = moe._route(_torch_tree(p), tcfg, torch.from_numpy(xf))
    _, pos_t = moe._positions(idx_t, tcfg.n_experts)
    pos_j = np.asarray(pos_j)
    jax_plan = (np.asarray(idx_j).reshape(-1), np.minimum(pos_j, cap - 1), pos_j < cap)
    port_plan = (idx_t.reshape(-1).numpy(), pos_t.clamp_max(cap - 1).numpy(),
                 (pos_t < cap).numpy())
    return jax_plan, port_plan


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_moe_apply_matches_jax_without_drops(mlp_type, shared):
    """capacity_factor = E (the reduced configs'): no assignment drops."""
    jcfg, tcfg = _cfgs(mlp_type=mlp_type, n_shared_experts=shared, capacity_factor=4.0)
    p = _params(jcfg, seed=1)
    x = np.random.default_rng(2).standard_normal((2, 8, 32)).astype(np.float32)
    _apply_both(jcfg, tcfg, p, x)
    jax_plan, port_plan = _plans(jcfg, tcfg, p, x)
    assert port_plan[2].all()
    for a, b in zip(jax_plan, port_plan):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_moe_apply_matches_jax_where_assignments_drop(mlp_type, shared):
    """The published capacity factor, T = 32, E = 4, k = 2 (cap 20) and a
    router skewed to expert 0: the same assignments drop in both, at the
    same slots, and the outputs and aux losses agree."""
    jcfg, tcfg = _cfgs(mlp_type=mlp_type, n_shared_experts=shared)
    p = _params(jcfg, seed=3, skew=0.2)
    # tokens with a common offset, along which the skew points
    x = (np.random.default_rng(4).standard_normal((2, 16, 32)) + 1.0).astype(np.float32)
    yt, auxt = _apply_both(jcfg, tcfg, p, x)
    jax_plan, port_plan = _plans(jcfg, tcfg, p, x)
    for a, b in zip(jax_plan, port_plan):
        np.testing.assert_array_equal(a, b)
    dropped = int((~port_plan[2]).sum())
    assert 0 < dropped < port_plan[2].size
    # an unbalanced router pays more than the balanced minimum of 1
    assert float(auxt) > 1.0
    # every token of which every assignment dropped gets the shared expert only
    all_dropped = ~port_plan[2].reshape(32, 2).any(axis=1)
    if all_dropped.any():
        xs = torch.from_numpy(x.reshape(32, 32))[torch.from_numpy(all_dropped)]
        rest = torch.zeros_like(xs)
        if shared:
            from repro_torch.models.layers import mlp_apply
            rest = mlp_apply(_torch_tree(p)["shared"], xs, "swiglu")
        torch.testing.assert_close(yt.reshape(32, 32)[torch.from_numpy(all_dropped)], rest)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_order_on_ties_matches_jax(k):
    """Ties in the router's probabilities: experts 1 and 3 have equal
    router columns, and tokens of zeros give every expert the same
    probability.  The order inside k (lower index first on a tie, as
    ``jax.lax.top_k``) feeds the positions' cumsum, so the plans and the
    outputs must agree."""
    jcfg, tcfg = _cfgs(experts_per_token=k, capacity_factor=1.0)
    p = _params(jcfg, seed=5)
    p["router"][:, 3] = p["router"][:, 1]
    x = np.random.default_rng(6).standard_normal((1, 12, 32)).astype(np.float32)
    x[0, ::3] = 0.0
    probs = moe._route(_torch_tree(p), tcfg, torch.from_numpy(x[0]))[0]
    assert torch.equal(probs[:, 1], probs[:, 3])
    assert (probs[::3] == probs[0, 0]).all()
    _, _, idx_j = jax_moe._route(_jax_tree(p), jcfg, jnp.asarray(x[0]))
    _, _, idx_t = moe._route(_torch_tree(p), tcfg, torch.from_numpy(x[0]))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(idx_t[::3].numpy(), np.tile(np.arange(k), (4, 1)))
    _apply_both(jcfg, tcfg, p, x)
    jax_plan, port_plan = _plans(jcfg, tcfg, p, x)
    for a, b in zip(jax_plan, port_plan):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,tokens,cap", [
    ("dbrx-132b", 4, 1), ("llama4-scout-17b-a16e", 4, 1),       # a decode step, 4 slots
    ("dbrx-132b", 1024, 320), ("llama4-scout-17b-a16e", 1024, 80),  # prefill at S=1024
])
def test_capacity_at_the_served_shapes(arch, tokens, cap):
    jcfg = jax_get_config(arch)
    assert moe._capacity(get_config(arch), tokens) == cap == max(
        int(tokens * jcfg.experts_per_token / jcfg.n_experts * jcfg.capacity_factor), 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_init_is_seeded_and_keeps_the_router_in_f32(dtype):
    cfg = get_config("llama4-scout-17b-a16e").reduced()
    a = moe.moe_init(torch.Generator().manual_seed(0), cfg, dtype, groups=(3,))
    b = moe.moe_init(torch.Generator().manual_seed(0), cfg, dtype, groups=(3,))
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    shapes = jax.tree.map(lambda t: tuple(t.shape), a)
    assert shapes == {"router": (3, d, e), "w_gate": (3, e, d, f), "w_up": (3, e, d, f),
                      "w_down": (3, e, f, d),
                      "shared": {"w_gate": (3, d, f), "w_up": (3, d, f), "w_down": (3, f, d)}}
    assert a["router"].dtype == torch.float32 and a["w_up"].dtype == dtype
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    # each expert its own draw, at lecun scale by its fan-in
    w = a["w_down"].float()
    assert not torch.equal(w[0, 0], w[0, 1]) and not torch.equal(w[0, 0], w[1, 0])
    assert abs(float(w.std()) * np.sqrt(f) - 1.0) < 0.1


def test_params_from_numpy_carries_a_moe_tree():
    """The reference's bf16 MoE tree (reduced llama4-scout-17b-a16e): the
    router stays f32, the (G, e, d, f) expert leaves and the shared
    expert's sub-dict arrive bit for bit."""
    from repro.models import Model as JaxModel
    from repro_torch.models.convert import params_from_numpy

    bf = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_get_config("llama4-scout-17b-a16e").reduced(), **bf)
    jp = jax.tree.map(np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(0), max_seq=32))
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e").reduced(), **bf)
    tp = params_from_numpy(jp, cfg, device="cpu")
    jf, tf = jp["blocks"]["layer0"]["ffn"], tp["blocks"]["layer0"]["ffn"]
    assert set(tf) == {"router", "w_gate", "w_up", "w_down", "shared"}
    assert tf["router"].dtype == torch.float32
    np.testing.assert_array_equal(tf["router"].numpy(), jf["router"])
    for name, leaf in (("w_up", tf["w_up"]), ("w_down", tf["w_down"]),
                       ("shared.w_gate", tf["shared"]["w_gate"])):
        ref = jf["shared"]["w_gate"] if name == "shared.w_gate" else jf[name]
        assert leaf.dtype == torch.bfloat16 and tuple(leaf.shape) == ref.shape
        np.testing.assert_array_equal(leaf.view(torch.int16).numpy().view(np.uint16),
                                      ref.view(np.uint16))
    assert tf["w_up"].shape == (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
