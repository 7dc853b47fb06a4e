"""The port's expert-parallel MoE (``repro_torch.models.moe._moe_shard_map``
behind the ``moe="shard_map"`` rule) on four gloo ranks of this CPU,
against the reference's ``_moe_shard_map`` on four forced CPU devices.

Both run ``moe_apply`` under ``logical_axis_rules(mesh, logical_rules(mesh,
"train", {"moe": "shard_map"}))`` on a 2x2 ("data", "model") mesh, on the
same numpy weights (one MoE layer of the reduced config's ``init`` in JAX,
through the port's ``params_from_numpy``) and the same numpy x (4, 16, 64),
for dbrx-132b (top-2) and llama4-scout-17b-a16e (top-1 and a shared
expert), each at the reduced capacity factor (nothing drops) and at the
published 1.25, where the partition-local capacity drops other assignments
than the global path does (the router is skewed toward expert 0 so that
it overflows), so the port is held to ``_moe_shard_map`` itself.

The output and the aux loss are held at 1e-5, and every gradient of the
scalar loss ``(y**2).mean() + aux`` (w.r.t. the five or eight weight
leaves and x) at 1e-5 of its leaf's largest value against ``jax.grad``
through the same path (jitted: the rules are read while it traces).
The aux term has weight 1: with top-1 the
renormalised gate is exactly 1, so the output's own router gradient is
zero up to rounding and the aux loss is the router's only signal.  The
JAX side runs in a subprocess of its own (``XLA_FLAGS`` forces the four
devices); the four ranks in another, started together.

``_moe_sharding_ok`` is also held to the reference's on plain shapes (no
ranks): the decode fallback, indivisible experts or d_ff, no rule.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import moe as jax_moe
from repro.sharding.policy import logical_rules as jax_logical_rules
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.sharding.policy import logical_rules

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("dbrx-132b", "llama4-scout-17b-a16e")
CAPACITY = (None, 1.25)          # None: the reduced config's no-drop factor
TOL = 1e-5
SKEW = 0.4

JAX_SIDE = r'''
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import moe
from repro.sharding.logical import logical_axis_rules
from repro.sharding.policy import logical_rules

out = sys.argv[1]
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
for arch in sys.argv[2].split(","):
    a = np.load(os.path.join(out, f"{arch}.npz"))
    p = {k: jnp.asarray(a[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    if "sh_w_gate" in a:
        p["shared"] = {k: jnp.asarray(a["sh_" + k]) for k in ("w_gate", "w_up", "w_down")}
    x = jnp.asarray(a["x"])
    for cf in sys.argv[3].split(","):
        cfg = get_config(arch).reduced()
        if cf != "None":
            cfg = dataclasses.replace(cfg, capacity_factor=float(cf))
        rules = logical_rules(mesh, "train", overrides={"moe": "shard_map"})

        def loss(p, x):
            y, aux = moe.moe_apply(p, cfg, x)
            return (y ** 2).mean() + aux, (y, aux)

        with logical_axis_rules(mesh, rules):
            ok = moe._moe_sharding_ok(cfg, x, mesh, rules)
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(p, x)
        flat = {"y": y, "aux": aux, "g_x": gx}
        for k, v in gp.items():
            for kk, vv in (v.items() if isinstance(v, dict) else [("", v)]):
                flat[f"g_{k}" + (f".{kk}" if kk else "")] = vv
        np.savez(os.path.join(out, f"jax_{arch}_{cf}.npz"), ok=ok,
                 **{k: np.asarray(v) for k, v in flat.items()})
'''

PORT_SIDE = r'''
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_fn(rank, world, port, out, archs, cfs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import moe
        from repro_torch.roofline.analysis import CostTrace, collective_bytes
        from repro_torch.sharding.logical import logical_axis_rules
        from repro_torch.sharding.policy import logical_rules, to_placements

        mesh = make_host_mesh(2, 2, device_type="cpu")
        # the train-mode parameter specs (EP + TP, FSDP on the shared MLP)
        specs = {"router": (None, None), "w_gate": ("data", None, "model"),
                 "w_up": ("data", None, "model"), "w_down": ("data", "model", None),
                 "shared": {"w_gate": ("data", "model"), "w_up": ("data", "model"),
                            "w_down": ("model", "data")}}

        def place(t, spec):
            if isinstance(t, dict):
                return {k: place(v, spec[k]) for k, v in t.items()}
            return distribute_tensor(t.clone(), mesh, to_placements(spec, mesh),
                                     src_data_rank=None).requires_grad_(True)

        for arch in archs.split(","):
            a = torch.load(os.path.join(out, f"{arch}.pt"))
            for cf in cfs.split(","):
                cfg = get_config(arch).reduced()
                if cf != "None":
                    cfg = dataclasses.replace(cfg, capacity_factor=float(cf))
                p = place(a["p"], specs)
                x = place(a["x"], ("data", None, None))
                rules = logical_rules(mesh, "train", overrides={"moe": "shard_map"})
                moe._moe_shard_map.calls = 0
                with logical_axis_rules(mesh, rules), CostTrace() as trace:
                    y, aux = moe.moe_apply(p, cfg, x)
                    ((y ** 2).mean() + aux).backward()
                calls = moe._moe_shard_map.calls
                res = {"y": y.full_tensor(), "aux": aux.full_tensor(), "g_x": x.grad.full_tensor()}
                for k, v in p.items():
                    for kk, vv in (v.items() if isinstance(v, dict) else [("", v)]):
                        res[f"g_{k}" + (f".{kk}" if kk else "")] = vv.grad.full_tensor()
                # the global path on the whole batch, plain tensors, no rules
                y_glob, _ = moe.moe_apply(a["p"], cfg, a["x"])
                # plain tensors under the rules: taken as whole on every rank
                with logical_axis_rules(mesh, rules), torch.no_grad():
                    y_plain, aux_plain = moe.moe_apply(a["p"], cfg, a["x"])
                if rank == 0:
                    np.savez(os.path.join(out, f"port_{arch}_{cf}.npz"),
                             calls=calls, y_global=y_glob.detach().numpy(),
                             y_plain=y_plain.numpy(), aux_plain=aux_plain.numpy(),
                             plain_type=type(y_plain).__name__,
                             counts=json.dumps(collective_bytes(trace.collectives)["counts"]),
                             **{k: v.detach().numpy() for k, v in res.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(rank_fn, args=(4, int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                      sys.argv[4]),
                       nprocs=4, start_method="spawn")
'''


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _layer(arch: str) -> tuple[dict, dict]:
    """One MoE layer of the reduced config's JAX ``init`` as numpy leaves
    and as the port's tensors (``params_from_numpy``), the router skewed
    toward expert 0."""
    jcfg = jax_get_config(arch).reduced()
    tree = jax.tree.map(np.array, JaxModel(jcfg).init(jax.random.PRNGKey(0)))
    tree["blocks"]["layer0"]["ffn"]["router"][..., 0] += SKEW
    ffn = params_from_numpy(tree, get_config(arch).reduced(), device="cpu")["blocks"]["layer0"]["ffn"]
    port = {k: (v[0].clone() if not isinstance(v, dict) else {kk: vv[0].clone()
                                                              for kk, vv in v.items()})
            for k, v in ffn.items()}
    flat = {k: v.numpy() for k, v in port.items() if not isinstance(v, dict)}
    flat.update({"sh_" + k: v.numpy() for k, v in port.get("shared", {}).items()})
    return flat, port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ep")
    x = (np.random.default_rng(1).standard_normal((4, 16, 64)) + 0.5).astype(np.float32)
    for arch in ARCHS:
        flat, port = _layer(arch)
        np.savez(out / f"{arch}.npz", x=x, **flat)
        torch.save({"p": port, "x": torch.from_numpy(x)}, out / f"{arch}.pt")
    (out / "jax_side.py").write_text(JAX_SIDE)
    (out / "port_side.py").write_text(PORT_SIDE)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    archs, cfs = ",".join(ARCHS), ",".join(map(str, CAPACITY))
    procs = [subprocess.Popen([sys.executable, str(out / "jax_side.py"), str(out), archs, cfs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT),
             subprocess.Popen([sys.executable, str(out / "port_side.py"), str(_free_port()),
                               str(out), archs, cfs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT)]
    for proc in procs:
        log, _ = proc.communicate(timeout=400)
        assert proc.returncode == 0, log[-4000:]
    return {(arch, cf): (np.load(out / f"jax_{arch}_{cf}.npz"), np.load(out / f"port_{arch}_{cf}.npz"))
            for arch in ARCHS for cf in CAPACITY}


@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("arch", ARCHS)
def test_output_and_aux_match_the_reference(runs, arch, cf):
    ref, got = runs[arch, cf]
    assert bool(ref["ok"]) and int(got["calls"]) == 1        # both took the EP path
    np.testing.assert_allclose(got["y"], ref["y"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_tensors_under_the_rules_come_back_plain(runs, arch):
    """Plain operands under the rules are whole on every rank: the EP path
    runs on their shards and hands back the whole plain result."""
    _, got = runs[arch, 1.25]
    assert str(got["plain_type"]) == "Tensor"
    np.testing.assert_allclose(got["y_plain"], got["y"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["aux_plain"], got["aux"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(runs, arch, cf):
    ref, got = runs[arch, cf]
    names = [k for k in ref.files if k.startswith("g_")]
    assert {"g_x", "g_router", "g_w_gate", "g_w_up", "g_w_down"} <= set(names)
    assert sorted(names) == sorted(k for k in got.files if k.startswith("g_"))
    for k in names:
        scale = float(np.abs(ref[k]).max())
        assert scale > 0, k
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= TOL * scale, (k, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_capacity_drops_other_assignments_than_the_global_path(runs, arch):
    """With nothing dropped the EP output is the global one; at 1.25 the
    per-shard capacity (``cap_loc``) drops otherwise, in both packages."""
    ref, got = runs[arch, None]
    np.testing.assert_allclose(got["y"], got["y_global"], rtol=TOL, atol=TOL)
    ref, got = runs[arch, 1.25]
    assert np.abs(got["y_global"] - got["y"]).max() > 1e-3
    assert np.abs(got["y_global"] - ref["y"]).max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_of_a_layer_forward_and_backward(runs, arch):
    """Two all-to-alls over the expert axis forward and two backward; the
    psums (over "model", and the aux loss's over the batch axes) as
    all-reduces."""
    counts = json.loads(str(runs[arch, None][1]["counts"]))
    assert counts["all-to-all"] == 4, counts
    assert counts["all-reduce"] >= 4, counts


@dataclasses.dataclass(frozen=True)
class _Mesh:
    shape: tuple
    mesh_dim_names: tuple


class _X:
    def __init__(self, *shape):
        self.shape = shape


MESHES = {"2x2": ((2, 2), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
OK_CASES = [  # (arch, cfg fields, x shape, mesh, rule overrides)
    ("dbrx-132b", {}, (4, 16), "2x2", {"moe": "shard_map"}),
    ("dbrx-132b", {}, (256, 4096), "16x16", {"moe": "shard_map"}),
    ("dbrx-132b", {}, (128, 1), "16x16", {"moe": "shard_map"}),        # decode: too few tokens
    ("dbrx-132b", {}, (32, 1), "2x2", {"moe": "shard_map"}),           # 16 a shard, k=2: enough
    ("dbrx-132b", {}, (7, 15), "2x2", {"moe": "shard_map"}),           # t % shards
    ("dbrx-132b", {"n_experts": 6}, (4, 16), "16x16", {"moe": "shard_map"}),
    ("dbrx-132b", {"d_ff": 100}, (4, 64), "16x16", {"moe": "shard_map"}),
    ("dbrx-132b", {}, (4, 16), "2x2", {}),                              # no rule
    ("dbrx-132b", {}, (4, 16), "2x2", {"moe": "shard_map", "expert": None}),
    ("llama4-scout-17b-a16e", {}, (32, 4096), "2x16x16", {"moe": "shard_map"}),
    ("llama4-scout-17b-a16e", {}, (2, 32), "2x16x16", {"moe": "shard_map"}),
]


@pytest.mark.parametrize("case", range(len(OK_CASES)))
def test_moe_sharding_ok_is_the_references(case):
    arch, fields, xshape, mesh_name, ov = OK_CASES[case]
    shape, names = MESHES[mesh_name]
    jcfg = dataclasses.replace(jax_get_config(arch), **fields)
    cfg = dataclasses.replace(get_config(arch), **fields)
    try:
        jmesh = JaxAbstractMesh(shape, names)
    except TypeError:  # pragma: no cover - jax >= 0.4.36 takes (name, size) pairs
        jmesh = JaxAbstractMesh(tuple(zip(names, shape)))
    mesh = _Mesh(shape, names)
    x = _X(*xshape, cfg.d_model)
    want = jax_moe._moe_sharding_ok(jcfg, x, jmesh, jax_logical_rules(jmesh, "train", ov))
    assert moe._moe_sharding_ok(cfg, x, mesh, logical_rules(mesh, "train", ov)) == want
    assert moe._moe_sharding_ok(cfg, x, None, None) is False


def test_expected_table_rows():
    """The table reaches both answers, the decode fallback among the false."""
    got = []
    for arch, fields, xshape, mesh_name, ov in OK_CASES:
        shape, names = MESHES[mesh_name]
        cfg = dataclasses.replace(get_config(arch), **fields)
        mesh = _Mesh(shape, names)
        got.append(moe._moe_sharding_ok(cfg, _X(*xshape, cfg.d_model), mesh,
                                        logical_rules(mesh, "train", ov)))
    assert got == [True, True, False, True, False, False, False, False, False, True, False]
