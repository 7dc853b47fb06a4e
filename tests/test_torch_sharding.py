"""The port's multi-device layer (``repro_torch.sharding``,
``launch.{mesh,inputs,dryrun}``, ``roofline``) against the JAX package's on
the CPU.

- Policy, exactly: ``param_pspecs`` of all ten configs in train and serve
  mode on 16x16, 2x16x16 and 2x4 meshes, leaf by leaf against the
  reference's over ``jax.sharding.AbstractMesh``; ``cache_pspecs`` of each
  cache family (KV, int8 KV, ring, SSM, cross); ``logical_rules`` and
  ``batch_pspec``; the ports of ``tests/test_sharding_policy.py``'s six
  rule tests.
- Cells and FLOPs, exactly: ``cells()`` and ``model_flops`` of all 32.
- ``build_cell``: every argument's global shape, dtype and spec against the
  reference's ``build_cell`` on a (2, 4) mesh (8 host devices in a JAX
  subprocess; a fake process group of 8 in the port's), six cells; all 32
  in the ``slow`` mirror of the reference's
  ``test_every_cell_constructs_on_small_mesh_subprocess``.
- The dry run on reduced configs over a fake 2x4 mesh against 1x1, the
  refused kernel route, the expert-parallel MoE's exchanges in a train
  cell, and the CLI on mamba2-370m x long_500k (``slow``, the
  mirror of ``test_dryrun_cli_one_cell_subprocess``).

A spec is compared as the reference's ``PartitionSpec`` entries padded
with None to the leaf's rank, a one-axis tuple as its name.  Anything that
needs a process group runs in a subprocess.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.configs import list_configs
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import cells as jax_cells
from repro.models import Model as JaxModel
from repro.roofline.analysis import model_flops as jax_model_flops
from repro.sharding import policy as jpolicy
from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import Model
from repro_torch.roofline import model_flops
from repro_torch.sharding import policy
from repro_torch.train.loop import meta_params
from repro_torch.train.tree import tree_items

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
# one cell per shape kind and per family
BUILD_CELLS = [("gemma-2b", "train_4k"), ("dbrx-132b", "prefill_32k"),
               ("whisper-small", "decode_32k"), ("internvl2-76b", "train_4k"),
               ("mamba2-370m", "long_500k"), ("jamba-1.5-large-398b", "long_500k")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Shapes and specs gain nothing from intra-op threads; one keeps a
    parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, no devices: all the policy reads
    (the counterpart of ``jax.sharding.AbstractMesh``)."""
    shape: tuple
    mesh_dim_names: tuple


def _meshes(name):
    shape, names = MESHES[name]
    try:
        jmesh = JaxAbstractMesh(shape, names)
    except TypeError:  # pragma: no cover - jax >= 0.4.36 takes (name, size) pairs
        jmesh = JaxAbstractMesh(tuple(zip(names, shape)))
    return jmesh, AbstractMesh(shape, names)


def _norm(spec, ndim: int) -> tuple:
    """Spec entries padded to ``ndim``, a one-axis tuple as its name."""
    out = [a[0] if isinstance(a, tuple) and len(a) == 1 else
           (tuple(a) if isinstance(a, (tuple, list)) else a) for a in spec]
    return tuple(out) + (None,) * (ndim - len(out))


def _jax_items(tree, is_leaf=None):
    """{key path: leaf} of a reference tree, keys as the port's paths."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): leaf
            for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str, max_seq: int = 4096):
    return jax.eval_shape(functools.partial(JaxModel(jax_get_config(arch)).init,
                                            max_seq=max_seq), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch: str, max_seq: int = 4096):
    return meta_params(get_config(arch), max_seq=max_seq)


def _compare_specs(ref_specs, ref_leaves, port_specs):
    ref = {k: _norm(s, ref_leaves[k].ndim)
           for k, s in _jax_items(ref_specs, lambda x: isinstance(x, P)).items()}
    port = {path: _norm(s, ref_leaves[path].ndim) for path, s in tree_items(port_specs)}
    assert port == ref


# ---------------------------------------------------------------------------
# policy, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", list_configs())
def test_param_pspecs_equal_reference(arch, mode, mesh):
    jmesh, tmesh = _meshes(mesh)
    jp = _jax_params(arch)
    ref = jpolicy.param_pspecs(jax_get_config(arch), jp, jmesh, mode)
    port = policy.param_pspecs(get_config(arch), _port_params(arch), tmesh, mode)
    leaves = _jax_items(jp)
    assert {path: tuple(leaf.shape) for path, leaf in tree_items(_port_params(arch))} == \
        {k: tuple(v.shape) for k, v in leaves.items()}
    _compare_specs(ref, leaves, port)


# (arch, config overrides, batch, length): each cache family at decode_32k's
# batch and a length that divides, and one that does not
CACHE_CASES = {
    "kv": ("gemma-2b", {}, 128, 32768),
    "kv_int8": ("granite-3-8b", {"kv_quant": True}, 128, 32768),
    "ring": ("gemma2-2b", {"kv_ring": True}, 128, 32768),
    "ssm": ("mamba2-370m", {}, 128, 32768),
    "hybrid_odd": ("jamba-1.5-large-398b", {}, 1, 1000),
    "cross": ("whisper-small", {}, 128, 32768),
}


def _caches(case):
    """(reference cache tree, port cache tree on meta) of a case: the model's
    ``init_cache``, and whisper's cross K/V beside it as ``build_cell``
    gives them."""
    arch, ov, b, s = CACHE_CASES[case]
    jcfg = dataclasses.replace(jax_get_config(arch), **ov)
    tcfg = dataclasses.replace(get_config(arch), **ov)
    ref = jax.eval_shape(functools.partial(JaxModel(jcfg).init_cache, b, s))
    port = Model(tcfg, device="meta").init_cache(b, s)
    if jcfg.is_encdec:
        groups, hd = jcfg.n_layers // jcfg.scan_unit(), jcfg.resolved_head_dim
        shape = (groups, b, 4096, jcfg.n_heads, hd)
        ref = {"self": ref, "cross": {k: jax.ShapeDtypeStruct(shape, jax.numpy.bfloat16)
                                      for k in ("k", "v")}}
        port = {"self": port, "cross": {k: torch.empty(shape, dtype=torch.bfloat16,
                                                        device="meta") for k in ("k", "v")}}
    return ref, port


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_cache_pspecs_equal_reference(case, mesh):
    jmesh, tmesh = _meshes(mesh)
    ref, port = _caches(case)
    leaves = _jax_items(ref)
    assert {p: tuple(x.shape) for p, x in tree_items(port)} == \
        {k: tuple(v.shape) for k, v in leaves.items()}
    _compare_specs(jpolicy.cache_pspecs(ref, jmesh), leaves, policy.cache_pspecs(port, tmesh))


@pytest.mark.parametrize("overrides", [None, {"seq": "model"}, {"expert": None,
                                                                 "expert_capacity": "data"},
                                       {"moe": "shard_map", "batch": None}])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_logical_rules_and_batch_pspec_equal_reference(mesh, mode, overrides):
    jmesh, tmesh = _meshes(mesh)
    assert policy.logical_rules(tmesh, mode, overrides) == \
        jpolicy.logical_rules(jmesh, mode, overrides)
    assert policy.batch_pspec(tmesh) == tuple(jpolicy.batch_pspec(jmesh))
    assert batch_axes(tmesh) == tuple(a for a in ("pod", "data") if a in MESHES[mesh][1])


# the ports of tests/test_sharding_policy.py's six rule tests
def _specs(arch, mesh="16x16", mode="train"):
    return policy.param_pspecs(get_config(arch), _port_params(arch), _meshes(mesh)[1], mode)


def test_dense_tp_fsdp_rules():
    specs = _specs("internvl2-76b")
    blk = specs["blocks"]["layer0"]
    # stacked group dim first, then (D, X): fsdp x model
    assert blk["mixer"]["wq"] == (None, "data", "model")
    assert blk["mixer"]["wo"] == (None, "model", "data")
    assert blk["ffn"]["w_up"] == (None, "data", "model")
    assert blk["ffn"]["w_down"] == (None, "model", "data")
    assert blk["mixer_norm"] == (None, None)
    # untied input embedding: vocab over fsdp
    assert specs["embed"] == ("data", None)
    assert specs["lm_head"] == ("data", "model")


def test_serve_mode_has_no_fsdp():
    blk = _specs("internvl2-76b", mode="serve")["blocks"]["layer0"]
    assert blk["mixer"]["wq"] == (None, None, "model")
    assert blk["ffn"]["w_down"] == (None, "model", None)


def test_moe_expert_parallel_rules():
    moe = _specs("dbrx-132b")["blocks"]["layer0"]["ffn"]
    assert moe["w_gate"] == (None, "data", None, "model")   # (G, E, D, F)
    assert moe["w_down"] == (None, "data", "model", None)   # (G, E, F, D)
    assert moe["router"] == (None, None, None)


def test_divisibility_degrades_to_replication():
    # granite vocab 49155 isn't divisible by 16 anywhere
    assert _specs("granite-3-8b")["embed"] == (None, "data")   # tied: vocab/model unfit
    # mamba2 vocab 50280 % 16 != 0, tied embedding
    assert _specs("mamba2-370m")["embed"][0] is None


def test_multipod_fsdp_spans_pod_and_data():
    blk = _specs("internvl2-76b", mesh="2x16x16")["blocks"]["layer0"]
    assert blk["mixer"]["wq"] == (None, ("pod", "data"), "model")


def test_ssm_rules():
    blk = _specs("mamba2-370m")["blocks"]["layer0"]["mixer"]
    assert blk["wx"] == (None, "data", "model")
    assert blk["out"] == (None, "model", "data")
    assert blk["conv_w"] == (None, None, "model")
    assert blk["A_log"] == (None, None)


def test_to_placements_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _meshes("2x16x16")[1]
    assert policy.to_placements((None, ("pod", "data"), "model"), mesh) == \
        (Shard(1), Shard(1), Shard(2))
    assert policy.to_placements(("model",), mesh) == (Replicate(), Replicate(), Shard(0))
    with pytest.raises(ValueError, match="order"):
        policy.to_placements((("data", "pod"),), mesh)


# ---------------------------------------------------------------------------
# cells and FLOPs, exactly
# ---------------------------------------------------------------------------

def test_cells_equal_reference():
    assert cells() == jax_cells()
    assert cells(include_skips=True) == jax_cells(include_skips=True)
    assert len(cells()) == 32
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in jax_cells()])
def test_model_flops_equal_reference(arch, shape):
    """The dry run's MODEL_FLOPS on the port's meta tree, as its CLI builds
    it, equal the reference's on its ``eval_shape`` tree."""
    cfg = get_config(arch)
    max_seq = SHAPES[shape].seq_len if not cfg.use_rope else 4096
    got = model_flops(cfg, SHAPES[shape], _port_params(arch, max_seq))
    want = jax_model_flops(jax_get_config(arch), JAX_SHAPES[shape], _jax_params(arch, max_seq))
    assert got == want and got > 0


# ---------------------------------------------------------------------------
# build_cell: global shapes, dtypes and specs against the reference's
# ---------------------------------------------------------------------------

JAX_BUILD = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.launch.inputs import build_cell
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
for arch, shape in json.loads(sys.argv[1]):
    cell = build_cell(arch, shape, mesh)
    flat = jax.tree_util.tree_flatten_with_path(cell.args)[0]
    out[arch + "|" + shape] = [
        ([getattr(k, "key", getattr(k, "idx", None)) for k in path], list(x.shape),
         str(x.dtype), [list(a) if isinstance(a, tuple) else a for a in x.sharding.spec])
        for path, x in flat]
print("CELLS " + json.dumps(out))
"""

PORT_BUILD = """
import json, sys
import torch
torch.set_num_threads(1)
from torch.distributed.tensor import Shard
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.inputs import build_cell
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.tree import tree_items
fake_world(8)
mesh = make_host_mesh(2, 4, device_type="cpu")
names = mesh.mesh_dim_names
out = {}
for arch, shape in json.loads(sys.argv[1]):
    cell = build_cell(arch, shape, mesh)
    rows = []
    for i, arg in enumerate(cell.args):
        for path, x in (tree_items(arg) if isinstance(arg, dict) else [((), arg)]):
            spec = [[n for n, p in zip(names, x.placements)
                     if isinstance(p, Shard) and p.dim == d] for d in range(x.ndim)]
            rows.append(([i, *path], list(x.shape), str(x.dtype).removeprefix("torch."),
                         [None if not s else s[0] if len(s) == 1 else s for s in spec]))
    out[arch + "|" + shape] = rows
print("CELLS " + json.dumps(out))
"""


def _run(code: str, *args: str, timeout: int = 560) -> str:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _cell_rows(code: str, todo) -> dict:
    line = next(ln for ln in _run(code, json.dumps(todo)).splitlines()
                if ln.startswith("CELLS "))
    return {cell: {tuple(path): (shape, dtype, _norm(spec, len(shape)))
                   for path, shape, dtype, spec in rows}
            for cell, rows in json.loads(line[len("CELLS "):]).items()}


@pytest.fixture(scope="module")
def built_cells():
    return _cell_rows(JAX_BUILD, BUILD_CELLS), _cell_rows(PORT_BUILD, BUILD_CELLS)


@pytest.mark.parametrize("arch,shape", BUILD_CELLS)
def test_build_cell_args_equal_reference(built_cells, arch, shape):
    ref, port = (rows[f"{arch}|{shape}"] for rows in built_cells)
    assert port == ref
    assert len(port) > 10


@pytest.mark.slow
def test_every_cell_constructs_on_small_mesh_subprocess():
    """All 32 runnable cells build their abstract sharded inputs on a (2, 4)
    mesh, each argument as the reference's."""
    todo = [(a, s) for a, s, _ in jax_cells()]
    ref, port = _cell_rows(JAX_BUILD, todo), _cell_rows(PORT_BUILD, todo)
    assert len(port) == 32 and port == ref


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

SMALL_DRYRUN = """
import dataclasses, json
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.inputs import build_cell
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.roofline.analysis import collective_bytes
out = {}
for arch, shape in [("gemma-2b", "train_4k"), ("dbrx-132b", "prefill_32k"),
                    ("whisper-small", "decode_32k"), ("jamba-1.5-large-398b", "long_500k")]:
    cfg = get_config(arch)
    red = cfg.reduced()
    ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(cfg)
          if getattr(red, f.name) != getattr(cfg, f.name)}
    for d, m in ((2, 4), (1, 1)):
        fake_world(d * m)
        cell = build_cell(arch, shape, make_host_mesh(d, m, device_type="cpu"),
                          cfg_overrides=ov)
        _, trace = cell.lower()
        coll = collective_bytes(trace.collectives)
        out[f"{arch}|{shape}|{d}x{m}"] = {"flops": trace.flops, "bytes": trace.bytes,
                                          "peak": trace.peak, "counts": coll["counts"]}
try:
    build_cell("dbrx-132b", "prefill_32k", make_host_mesh(1, 1, device_type="cpu"),
               rule_overrides={"attn": "pallas"})
except NotImplementedError as err:
    out[json.dumps({"attn": "pallas"})] = str(err)
# the expert-parallel rule on a reduced dbrx-132b train cell, 2x4, and without it
from repro_torch.models import moe
from repro_torch.sharding import local
psum_axes = []
_psum = local._psum
local._psum = lambda x, mesh, axes: psum_axes.append(list(axes)) or _psum(x, mesh, axes)
red = get_config("dbrx-132b").reduced()
ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
      if getattr(red, f.name) != getattr(get_config("dbrx-132b"), f.name)}
fake_world(8)
for rules in ({"moe": "shard_map"}, {}):
    moe._moe_shard_map.calls = 0
    psum_axes.clear()
    cell = build_cell("dbrx-132b", "train_4k", make_host_mesh(2, 4, device_type="cpu"),
                      cfg_overrides=ov, rule_overrides=rules)
    _, trace = cell.lower()
    out["dbrx-132b|train_4k|2x4|" + json.dumps(rules)] = {
        "counts": collective_bytes(trace.collectives)["counts"], "layers": red.n_layers,
        "calls": moe._moe_shard_map.calls, "psum_axes": psum_axes[:]}
print("DRY " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def small_dryrun():
    line = next(ln for ln in _run(SMALL_DRYRUN).splitlines() if ln.startswith("DRY "))
    return json.loads(line[len("DRY "):])


@pytest.mark.parametrize("cell", ["gemma-2b|train_4k", "dbrx-132b|prefill_32k",
                                  "whisper-small|decode_32k", "jamba-1.5-large-398b|long_500k"])
def test_dryrun_flops_per_device_on_a_2x4_mesh(small_dryrun, cell):
    """Reduced configs at the cells' shapes: a device of the 2x4 mesh does
    less than the whole step and, with replicated work counted in full on
    each, the eight do at least all of it."""
    eight, one = small_dryrun[f"{cell}|2x4"], small_dryrun[f"{cell}|1x1"]
    assert 0 < eight["flops"] < one["flops"] <= 8 * eight["flops"]
    assert 0 < eight["bytes"] < one["bytes"] and eight["peak"] > 0 and one["peak"] > 0
    assert sum(eight["counts"].values()) > 0


def test_dryrun_train_cell_reduces_gradients(small_dryrun):
    """FSDP parameters are all-gathered on use and their gradients
    reduce-scattered; replicated ones all-reduced."""
    counts = small_dryrun["gemma-2b|train_4k|2x4"]["counts"]
    assert counts["reduce-scatter"] > 0 and counts["all-reduce"] > 0
    assert counts["all-gather"] > 0


def test_dryrun_refuses_the_kernel_and_shard_map_routes(small_dryrun):
    """The flash-attention kernel route is still refused (K1 has no sharded
    form); the expert-parallel ``moe=shard_map`` rule is no longer refused:
    its cell traces (``test_dryrun_expert_parallel_train_cell_exchanges``)."""
    assert "flash-attention kernel" in small_dryrun[json.dumps({"attn": "pallas"})]
    assert json.dumps({"moe": "shard_map"}) not in small_dryrun
    assert small_dryrun["dbrx-132b|train_4k|2x4|" + json.dumps({"moe": "shard_map"})]["calls"] > 0


def test_dryrun_expert_parallel_train_cell_exchanges(small_dryrun):
    """A reduced dbrx-132b train cell on the 2x4 fake group under
    ``moe=shard_map``: every MoE layer takes the expert-parallel path in
    the forward and again in remat's recomputation, two all-to-alls each,
    and the backward's two a layer; the expert outputs are psum'd over
    "model" (all-reduces).  Without the rule: no EP call.  Both cells also
    split attention's queries over "model" (2 KV heads over 4 ranks), two
    all-to-alls a layer in each of the same three passes."""
    ep = small_dryrun["dbrx-132b|train_4k|2x4|" + json.dumps({"moe": "shard_map"})]
    base = small_dryrun["dbrx-132b|train_4k|2x4|" + json.dumps({})]
    n = ep["layers"]
    assert ep["calls"] == 2 * n                          # forward + remat's recomputation
    assert base["counts"]["all-to-all"] == 6 * n, base["counts"]     # the query split
    assert ep["counts"]["all-to-all"] - base["counts"]["all-to-all"] == 6 * n, ep["counts"]
    assert ["model"] in ep["psum_axes"] and ep["counts"]["all-reduce"] > 0
    assert base["calls"] == 0, base
    assert base["psum_axes"] == []


@pytest.mark.slow
def test_dryrun_cli_one_cell_subprocess():
    """The dry run's entry point passes for a representative cell (mamba2
    long_500k) on the production mesh."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "mamba2-370m", "--shape", "long_500k"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=560)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "1 cells compiled OK, 0 failed" in out.stdout
    assert "roofline:" in out.stdout


def test_strided_shard_closed_form_matches_torch():
    """The dry run's closed form of DTensor's strided shard sizes is torch's
    own arithmetic: on this torch the context swaps it in (its check on
    every small case passed) and puts the original back."""
    from torch.distributed.tensor.placement_types import _StridedShard

    from repro_torch.launch import dryrun

    size, idx = dryrun._strided_shard_closed_form(10, 3, 1, 2)
    assert (size, [i for r in idx for i in r]) == (4, [2, 3, 7, 8])
    orig = _StridedShard.local_shard_size_and_offset
    with dryrun.closed_form_strided_shards():
        assert _StridedShard.local_shard_size_and_offset is not orig
        p = _StridedShard(0, split_factor=4096)
        assert p.local_shard_size_and_offset(4096 * 16, 16, 3) == \
            orig(p, 4096 * 16, 16, 3)
    assert _StridedShard.local_shard_size_and_offset is orig
