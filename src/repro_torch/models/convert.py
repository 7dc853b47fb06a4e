"""Carry the JAX reference's parameters into the port.

``params_from_numpy(tree, cfg)`` takes the reference's parameter pytree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's parameters: the same nested dict, each leaf a tensor of
the same shape and type.  The layouts already agree (``(in, out)``
matrices, per-layer leaves stacked over layer groups, the encoder's over
its layers; ``pos_embed`` and the decoder's ``cross`` leaves as they
are), so no leaf is transposed or unstacked.  bfloat16 arrays (numpy's
``ml_dtypes`` type) are carried bit for bit through their 16-bit
pattern.

``opt_from_numpy(state, cfg)`` carries the reference's AdamW state
(``{"m", "v", "count"}``, ``repro.train.init_opt``'s layout) across the
same way, so a run the reference started can go on in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig

__all__ = ["params_from_numpy", "opt_from_numpy"]


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
        # any leaf of the layer carries the group axis (an ssm layer has no wq)
        leaf = layer
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        lead = np.shape(leaf)[0]
        if lead != groups:
            raise ValueError(f"{name}: {lead} stacked groups, {cfg.name} has {groups}")
    if cfg.is_encdec:
        enc = tree.get("encoder", {}).get("blocks", {})
        if set(enc) != {"layer0"}:
            raise ValueError(f"encoder blocks hold {sorted(enc)}, {cfg.name} wants ['layer0']")
        lead = np.shape(enc["layer0"]["mixer"]["wq"])[0]
        if lead != cfg.n_encoder_layers:
            raise ValueError(f"encoder: {lead} stacked layers, {cfg.name} has "
                             f"{cfg.n_encoder_layers}")
    elif "encoder" in tree:
        raise ValueError(f"{cfg.name} has no encoder, the tree holds one")
    if tree["embed"].shape != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {tree['embed'].shape} != {(cfg.vocab_size, cfg.d_model)}")
    return _convert(tree, resolve_device(device))


def opt_from_numpy(state: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Reference optimizer state (nested dicts of numpy arrays) -> the
    port's: moments shaped as the parameters, checked as they are, and the
    int32 step count."""
    return {"m": params_from_numpy(state["m"], cfg, device),
            "v": params_from_numpy(state["v"], cfg, device),
            "count": _leaf(np.asarray(state["count"], np.int32), resolve_device(device))}
