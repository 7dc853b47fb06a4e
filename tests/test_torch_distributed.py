"""The port's collectives on four gloo ranks of this CPU, against the JAX
package's sequential references on the same numpy arrays.

- ``sharding.pipeline.gpipe`` over a 4-stage "pipe" mesh (the reference
  test's L, B, D, M = 8, 16, 12, 4): the output held to the reference's
  sequential ``block`` run in JAX at 1e-5, the gradients of ``w`` (each
  rank's stage share, summed over the ranks) to the port's sequential
  gradients at 2e-4, and collective-permutes among its recorded
  collectives (the port of ``tests/test_pipeline.py``).
- In one spawn, as the reference's
  ``test_elastic_reshard_and_compression_subprocess``: a checkpoint written
  by the reference's ``save_checkpoint`` restored onto a (2, 2) mesh with
  ("data", "model") placements, each rank's shard equal to its numpy
  slice; ``make_dp_grad_fn`` over the data axis, compressed against exact
  within 0.02 relative with int8 on the wire, the exact one against
  ``jax.grad`` of the whole batch's loss at 1e-5.

Each test runs a script in a subprocess that spawns the four ranks (a
process group of their own on a free localhost port), which write their
results for the test to read.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.train import save_checkpoint

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
L, B, D, M = 8, 16, 12, 4

WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def gpipe_rank(rank, world, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.roofline.analysis import CostTrace, collective_bytes
        from repro_torch.sharding.pipeline import gpipe

        a = np.load(os.path.join(out, "inputs.npz"))
        w, b, x = (torch.from_numpy(a[k]) for k in ("w", "b", "x"))
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pipe",))

        def block(p, h):
            return torch.tanh(h @ p["w"] + p["b"])

        def seq(p, h):
            for l in range(w.shape[0]):
                h = block({"w": p["w"][l], "b": p["b"][l]}, h)
            return h

        wp = w.clone().requires_grad_(True)
        with CostTrace() as trace:
            got = gpipe(block, {"w": wp, "b": b}, x, mesh, n_microbatches=int(a["m"]))
            (gw,) = torch.autograd.grad((got ** 2).sum(), wp)
        dist.all_reduce(gw)            # each rank holds its stage's share
        ws = w.clone().requires_grad_(True)
        (gs,) = torch.autograd.grad((seq({"w": ws, "b": b}, x) ** 2).sum(), ws)
        np.savez(os.path.join(out, f"rank{rank}.npz"), out=got.detach().numpy(),
                 gw=gw.numpy(), gs=gs.numpy(),
                 counts=json.dumps(collective_bytes(trace.collectives)["counts"]))
    finally:
        dist.destroy_process_group()


def dp_rank(rank, world, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.roofline.analysis import CostTrace
        from repro_torch.sharding.policy import NamedSharding, to_placements
        from repro_torch.train import make_dp_grad_fn, restore_checkpoint

        mesh = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("data", "model"))
        # elastic restore onto the (2, 2) mesh of a checkpoint written on one device
        like = {"a": torch.empty((8, 6), dtype=torch.float32, device="meta")}
        shd = {"a": NamedSharding(mesh, to_placements(("data", "model"), mesh))}
        tree, meta = restore_checkpoint(os.path.join(out, "ckpt"), 3, like, shardings=shd)
        a = np.load(os.path.join(out, "inputs.npz"))
        params = {"w": torch.from_numpy(a["w"])}
        batch = torch.from_numpy(a["batch"])

        def loss(p, bt):
            return torch.mean((bt @ p["w"]) ** 2)

        with CostTrace() as trace:
            gc = make_dp_grad_fn(loss, mesh, compress=True)(params, batch)["w"]
        ge = make_dp_grad_fn(loss, mesh, compress=False)(params, batch)["w"]
        np.savez(os.path.join(out, f"rank{rank}.npz"), shard=tree["a"].to_local().numpy(),
                 placements=repr(tuple(tree["a"].placements)),
                 coord=np.array(mesh.get_coordinate()), step=meta["step"],
                 gc=gc.numpy(), ge=ge.numpy(),
                 wire=json.dumps([(k, n, str(d)) for k, n, d in trace.collectives]))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    fn = {"gpipe": gpipe_rank, "dp": dp_rank}[sys.argv[1]]
    mp.start_processes(fn, args=(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]),
                       nprocs=int(sys.argv[2]), start_method="spawn")
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(tmp_path, what: str) -> list:
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(script), what, str(WORLD), str(_free_port()),
                           str(tmp_path)], capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(WORLD)]


def test_gpipe_matches_sequential_on_four_gloo_ranks(tmp_path):
    rs = np.random.RandomState(0)
    w = (rs.randn(L, D, D) * 0.3).astype(np.float32)
    b = (rs.randn(L, D) * 0.1).astype(np.float32)
    x = rs.randn(B, D).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", w=w, b=b, x=x, m=M)

    def block(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    h = jnp.asarray(x)
    for layer in range(L):
        h = block({"w": jnp.asarray(w[layer]), "b": jnp.asarray(b[layer])}, h)
    ref = np.asarray(h)

    for r, res in enumerate(_spawn(tmp_path, "gpipe")):
        np.testing.assert_allclose(res["out"], ref, rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["gw"], res["gs"], rtol=2e-4, atol=2e-4,
                                   err_msg=f"rank {r}")
        counts = json.loads(str(res["counts"]))
        # M + S - 1 steps forward and backward, one all-reduce to every stage
        assert counts["collective-permute"] == 2 * (M + WORLD - 1), counts
        assert counts["all-reduce"] == 1, counts


def test_elastic_reshard_and_compression_on_four_gloo_ranks(tmp_path):
    save_checkpoint(str(tmp_path / "ckpt"), 3,
                    {"a": jnp.arange(48, dtype=jnp.float32).reshape(8, 6)})
    w = np.random.RandomState(0).randn(6, 1).astype(np.float32)
    batch = np.random.RandomState(1).randn(32, 6).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", w=w, batch=batch)
    exact = np.asarray(jax.grad(lambda p: jnp.mean((jnp.asarray(batch) @ p["w"]) ** 2))(
        {"w": jnp.asarray(w)})["w"])
    full = np.arange(48, dtype=np.float32).reshape(8, 6)

    for r, res in enumerate(_spawn(tmp_path, "dp")):
        i, j = res["coord"]
        np.testing.assert_array_equal(res["shard"], full[4 * i:4 * i + 4, 3 * j:3 * j + 3])
        assert str(res["placements"]) == "(Shard(dim=0), Shard(dim=1))"
        assert int(res["step"]) == 3
        rel = np.linalg.norm(res["gc"] - res["ge"]) / np.linalg.norm(res["ge"])
        assert rel < 0.02, (r, rel)
        np.testing.assert_allclose(res["ge"], exact, rtol=1e-5, atol=1e-6)
        wire = json.loads(str(res["wire"]))
        assert ["all-gather", 6, "torch.int8"] in wire, wire     # int8 on the wire
        assert {k for k, _, _ in wire} == {"all-gather"}, wire
