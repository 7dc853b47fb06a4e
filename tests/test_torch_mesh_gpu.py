"""The multi-device layer on a one-rank NCCL mesh on the card: a reduced
gemma-2b train step through ``build_cell``'s step, on parameters and a
batch placed by the cell's specs, equals the plain step on the same
tensors within ``tests/test_torch_train.py``'s tolerances (loss 2e-4
relative, parameters 2e-3 of their largest magnitude; an embedding's
backward adds with atomics on the card, so bits may differ between two
runs of one step).  No JAX here: the plain step is held to the reference
in ``tests/test_torch_train.py``.  Needs a CUDA device, is marked ``gpu``
and skips without one; the process group lives only inside the test."""

import copy
import dataclasses
import socket

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.train import init_opt, make_train_step
from repro_torch.train.tree import tree_leaves


@pytest.fixture
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh is a one-rank NCCL group on the card")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_one_rank_nccl_mesh_train_step_equals_plain_step(nccl_mesh):
    from repro_torch.launch.inputs import build_cell, place_like

    cfg = get_config("gemma-2b")
    red = cfg.reduced()
    ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(cfg)
          if getattr(red, f.name) != getattr(cfg, f.name)}
    cell = build_cell("gemma-2b", "train_4k", nccl_mesh, cfg_overrides=ov)
    model = Model(cell.cfg, device="cuda")
    params = model.init(torch.Generator("cuda").manual_seed(0), max_seq=4096)
    toks = torch.randint(0, cell.cfg.vocab_size, (2, 65), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = cell.meta["opt"]

    plain = copy.deepcopy(params)
    p1, _, m1 = make_train_step(model, opt)(plain, init_opt(plain, opt), batch)
    mesh_p = copy.deepcopy(params)
    args = place_like((mesh_p, init_opt(mesh_p, opt), batch), cell.args)
    p2, _, m2 = cell.run(*args)
    for k in m1:
        got = m2[k].full_tensor() if hasattr(m2[k], "full_tensor") else m2[k]
        assert abs(float(got) - float(m1[k])) <= 2e-4 * abs(float(m1[k])) + 1e-6, k
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        b = b.to_local()
        assert (a.float() - b.float()).abs().max() <= 2e-3 * a.float().abs().max() + 1e-6
