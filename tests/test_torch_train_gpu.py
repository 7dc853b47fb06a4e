"""The port's train step on the card against the same step on the CPU
(no JAX here: the CPU step is held to the reference in
``tests/test_torch_train.py``).  Both tests need a CUDA device, are marked
``gpu`` and skip without one."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention
from repro_torch.models import Model
from repro_torch.train import OptConfig, init_opt, make_train_step
from repro_torch.train.tree import tree_leaves

TOL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the train step is compared between it and the CPU")
    return torch.device("cuda")


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device, copy=True)
            for k, v in tree.items()}


def _batch(cfg, device, b=2, s=32):
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1]).to(device),
            "labels": torch.from_numpy(toks[:, 1:]).to(device)}


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda_device):
    cfg = get_config("gemma-2b").reduced()
    params = Model(cfg, device="cpu").init(torch.Generator("cpu").manual_seed(0), max_seq=64)
    opt = OptConfig(lr=1e-3)
    out = {}
    for device in ("cpu", cuda_device):
        p = _to(params, device)
        step = make_train_step(Model(cfg, device=device), opt, remat=False)
        p, _, metrics = step(p, init_opt(p, opt), _batch(cfg, device))
        out[torch.device(device).type] = (p, {k: float(v) for k, v in metrics.items()})
    (pc, mc), (pg, mg) = out["cpu"], out["cuda"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(mg[key], mc[key], rtol=TOL)
    for a, b in zip(tree_leaves(pg), tree_leaves(pc)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_kernel_route_train_step_raises_on_card(cuda_device):
    """The kernels have no backward: a train step on the kernel route
    raises at its first attention layer and launches nothing."""
    cfg = dataclasses.replace(get_config("gemma-2b").reduced(), param_dtype="bfloat16",
                              compute_dtype="bfloat16", head_dim=64)   # a width K1 builds
    model = Model(cfg, attn="kernel", device=cuda_device)
    params = model.init(torch.Generator(cuda_device).manual_seed(0), max_seq=64)
    before = flash_attention.launches
    step = make_train_step(model, OptConfig(), remat=False)
    with pytest.raises(RuntimeError, match="no backward"):
        step(params, init_opt(params, OptConfig()), _batch(cfg, cuda_device, s=64))
    assert flash_attention.launches == before
