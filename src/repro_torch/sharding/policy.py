"""Parameter/optimizer/activation sharding policy, PyTorch port of
``repro.sharding.policy``.

Strategy (DESIGN.md §4):
  - TP over "model": attention head projections, FFN hidden, SSM inner dim.
  - FSDP/ZeRO over ("pod","data") in train mode: the non-TP dim of every
    2-D weight; optimizer moments inherit the param sharding.
  - EP: MoE expert dim over "data" (16 experts / 16 rows), expert-internal
    hidden over "model".
  - Serve mode: no FSDP (params TP-only + EP) to avoid per-token
    all-gathers; decode KV caches shard batch over data and sequence over
    "model".

Every rule degrades to replication when a dim is not divisible by the mesh
axis (e.g. vocab 50280 % 16 != 0) — correctness first, the roofline shows
the cost.

A spec is the reference's ``PartitionSpec`` content as a plain tuple, one
entry per tensor dim: a mesh axis name, a tuple of names, or None.
``to_placements`` turns one into DTensor placements over a ``DeviceMesh``;
the ``*_shardings`` functions give a ``NamedSharding`` (the mesh and the
placements) per leaf.  A mesh here is anything with ``mesh_dim_names``
and ``shape`` (``launch.mesh.mesh_shape``); only ``to_placements``'
callers need a real ``DeviceMesh``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import batch_axes, mesh_shape

__all__ = ["param_pspecs", "param_shardings", "logical_rules", "batch_pspec",
           "cache_pspecs", "cache_shardings", "to_placements", "NamedSharding"]


class NamedSharding(NamedTuple):
    """A mesh and one DTensor placement per mesh dim
    (``jax.sharding.NamedSharding``)."""
    mesh: Any
    placements: tuple


def to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements, one per mesh dim, of a spec: a mesh dim named by
    tensor dim d is ``Shard(d)``, any other ``Replicate()``.  A tensor dim
    over several mesh axes (("pod", "data")) is ``Shard(d)`` on each, split
    major to minor in mesh order, as JAX splits it.  A mesh dim of size 1
    is ``Replicate()``: one shard is the whole, and DTensor refuses some
    views of a dim it holds as sharded."""
    from torch.distributed.tensor import Replicate, Shard

    names, sizes = tuple(mesh.mesh_dim_names), tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in the mesh's order {names}")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _fits(dim: int, mesh, axes):
    """axes if dim divides evenly over them, else None (replicate)."""
    return axes if axes and dim % _axis_size(mesh, axes) == 0 else None


def logical_rules(mesh, mode: str, overrides: dict | None = None) -> dict:
    """Logical-axis -> physical mesh axes for activation annotations.

    `seq` (the residual-stream sequence dim between blocks) is None in the
    baseline (Megatron replicated residual: wo/w_down emit an all-reduce).
    Overriding it to "model" enables sequence parallelism (Korthikanti et
    al.): the per-layer all-reduce becomes reduce-scatter + all-gather.
    """
    bx = batch_axes(mesh)
    rules = {
        "batch": bx if len(bx) > 1 else (bx[0] if bx else None),
        "model": "model",
        "expert": "data",
        "expert_capacity": None,
        "kv_seq": None,
        "seq": None,
    }
    if mode == "decode":
        rules["kv_seq"] = "model"
    if overrides:
        rules.update(overrides)
    return rules


def batch_pspec(mesh) -> tuple:
    bx = batch_axes(mesh)
    return (bx if len(bx) > 1 else (bx[0] if bx else None),)


def _leaf_spec(path: tuple[str, ...], leaf, cfg: ModelConfig, mesh,
               mode: str) -> tuple:
    """Spec for one parameter, by name pattern (see module doc)."""
    name = path[-1]
    shape = leaf.shape
    in_blocks = "blocks" in path
    # strip the stacked group dim for rule matching
    dims = shape[1:] if in_blocks else shape
    mdl = "model"
    fsdp = batch_axes(mesh) if mode == "train" else None
    if fsdp is not None and len(fsdp) == 1:
        fsdp = fsdp[0]

    def fit(i, ax):
        return _fits(dims[i], mesh, ax)

    if name in ("embed",):
        # Tied embeddings double as the vocab-parallel output head: vocab
        # over "model".  Untied input-only tables shard vocab over FSDP in
        # train; in serve mode (no FSDP) shard D over "model" instead.
        if cfg.tie_embeddings:
            spec = (fit(0, mdl), fit(1, fsdp))
        elif mode == "train":
            spec = (fit(0, fsdp), fit(1, None))
        else:
            spec = (fit(0, None), fit(1, mdl))
    elif name == "lm_head":                     # (D, V): vocab-parallel
        spec = (fit(0, fsdp), fit(1, mdl))
    elif name == "pos_embed":                   # (S, D)
        spec = (None, fit(1, mdl))
    elif name in ("wq", "wk", "wv", "wz", "wx", "wdt"):   # (D, X)
        spec = (fit(0, fsdp), fit(1, mdl))
    elif name in ("wB", "wC"):                  # (D, ds): ds small
        spec = (fit(0, fsdp), fit(1, None))
    elif name in ("wo", "out"):                 # (X, D)
        spec = (fit(0, mdl), fit(1, fsdp))
    elif name == "router":                      # (D, E): tiny, replicate
        spec = (None, None)
    elif name in ("w_gate", "w_up"):
        if len(dims) == 3:                      # (E, D, F): EP + TP
            spec = (fit(0, "data"), None, fit(2, mdl))
        else:                                   # (D, F)
            spec = (fit(0, fsdp), fit(1, mdl))
    elif name == "w_down":
        if len(dims) == 3:                      # (E, F, D)
            spec = (fit(0, "data"), fit(1, mdl), None)
        else:                                   # (F, D)
            spec = (fit(0, mdl), fit(1, fsdp))
    elif name == "conv_w":                      # (W, convdim)
        spec = (None, fit(1, mdl))
    elif name in ("conv_b", "gate_norm"):       # (convdim,) / (d_in,)
        spec = (fit(0, mdl),)
    else:                                       # norms, biases, A_log, ...
        spec = (None,) * len(dims)

    if in_blocks:
        spec = (None,) + tuple(spec)
    return tuple(spec)


def _map_with_path(fn, tree, path: tuple = ()):
    return {k: _map_with_path(fn, v, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
            for k, v in tree.items()}


def param_pspecs(cfg: ModelConfig, params, mesh, mode: str):
    """Tree of specs matching ``params`` (or its ``meta`` tree)."""
    return _map_with_path(lambda path, leaf: _leaf_spec(path, leaf, cfg, mesh, mode), params)


def _shardings(specs, mesh):
    return _map_with_path(lambda _, s: NamedSharding(mesh, to_placements(s, mesh)), specs)


def param_shardings(cfg: ModelConfig, params, mesh, mode: str):
    return _shardings(param_pspecs(cfg, params, mesh, mode), mesh)


def _cache_leaf_spec(name: str, leaf, mesh, mode: str) -> tuple:
    """KV / SSM cache sharding.

    Decode: batch over data(+pod), KV sequence over "model" (flash-decoding
    style partial softmax).  Prefill outputs use the same layout so the
    engine can hand them to decode without a reshard.
    """
    bx = batch_axes(mesh)
    bax = bx if len(bx) > 1 else (bx[0] if bx else None)
    b = _fits(leaf.shape[1], mesh, bax)
    if name in ("k", "v"):            # (G, B, S, KV, hd)
        return (None, b, _fits(leaf.shape[2], mesh, "model"), None, None)
    if name in ("k_scale", "v_scale"):  # (G, B, S, KV)
        return (None, b, _fits(leaf.shape[2], mesh, "model"), None)
    if name == "conv":                # (G, B, W-1, conv_dim)
        return (None, b, None, _fits(leaf.shape[3], mesh, "model"))
    if name == "ssm":                 # (G, B, nh, hd, N)
        return (None, b, _fits(leaf.shape[2], mesh, "model"), None, None)
    return (None,) * leaf.ndim


def cache_pspecs(cache, mesh, mode: str = "decode"):
    return _map_with_path(lambda path, leaf: _cache_leaf_spec(path[-1], leaf, mesh, mode), cache)


def cache_shardings(cache, mesh, mode: str = "decode"):
    return _shardings(cache_pspecs(cache, mesh, mode), mesh)
