"""Carry the JAX reference's parameters into the port.

``params_from_numpy(tree, cfg)`` takes the reference's parameter pytree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's parameters: the same nested dict, each leaf a tensor of
the same shape and type.  The layouts already agree (``(in, out)``
matrices, per-layer leaves stacked over layer groups), so no leaf is
transposed or unstacked.  bfloat16 arrays (numpy's ``ml_dtypes`` type) are
carried bit for bit through their 16-bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig

__all__ = ["params_from_numpy"]


def _leaf(a, device) -> torch.Tensor:
    a = np.array(a)                     # a writable copy the tensor may own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Reference parameters (nested dicts of numpy arrays) -> the port's."""
    unit = cfg.scan_unit()
    groups = cfg.n_layers // unit
    want = {f"layer{j}" for j in range(unit)}
    if set(tree["blocks"]) != want:
        raise ValueError(f"blocks hold {sorted(tree['blocks'])}, {cfg.name} wants {sorted(want)}")
    for name, layer in tree["blocks"].items():
        lead = np.asarray(layer["mixer"]["wq"]).shape[0]
        if lead != groups:
            raise ValueError(f"{name}: {lead} stacked groups, {cfg.name} has {groups}")
    if tree["embed"].shape != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {tree['embed'].shape} != {(cfg.vocab_size, cfg.d_model)}")
    return _convert(tree, resolve_device(device))
