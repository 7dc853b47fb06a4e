"""Cell builder: (architecture x input-shape x mesh) -> step fn + abstract
sharded inputs, PyTorch port of ``repro.launch.inputs``.

The abstract inputs are ``DTensor``s over ``meta`` storage (shapes, dtypes
and placements, no allocation): the reference's sharded
``ShapeDtypeStruct``s.  ``build_cell`` returns everything the dry run (and
the roofline) needs to run the step once on them: ``Cell.lower``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, get_config
from repro_torch.models import Model
from repro_torch.sharding.logical import logical_axis_rules
from repro_torch.sharding.policy import (
    cache_pspecs,
    logical_rules,
    param_pspecs,
    to_placements,
)
from repro_torch.train import (
    OptConfig,
    init_opt,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.train.loop import meta_params

__all__ = ["build_cell", "Cell", "input_specs", "place_like", "WHISPER_DECODE_ENC_LEN"]

# Encoder context length for whisper decode cells (the self-attn KV is the
# graded seq_len; the cross-attention memory is one fixed audio window).
WHISPER_DECODE_ENC_LEN = 4096

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    step: Callable
    args: tuple                      # DTensors over meta storage
    donate: tuple = ()
    rules: dict = field(default_factory=dict)
    mesh: Any = None
    meta: dict = field(default_factory=dict)

    def run(self, *args):
        """The step on ``args`` (by default the cell's abstract ones; or real
        tensors placed like them, ``place_like``) inside the cell's
        logical-axis rules.  Plain tensors the step makes (RoPE tables,
        positions) join the DTensors as replicated."""
        from torch.distributed.tensor.experimental import implicit_replication

        with logical_axis_rules(self.mesh, self.rules), implicit_replication():
            return self.step(*(args or self.args))

    def lower(self):
        """Run the step once on the abstract args under a
        ``roofline.CostTrace``: (the step's outputs, the trace)."""
        from repro_torch.roofline.analysis import CostTrace

        with CostTrace(device="meta") as trace:
            out = self.run()
        return out, trace


def _sds(t, mesh, pspec):
    """``t`` (a meta tensor of the global shape) as a DTensor placed by ``pspec``."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, to_placements(pspec, mesh), src_data_rank=None)


def place_like(tree, like):
    """``tree`` (real tensors, of any shapes: a smaller batch than the
    cell's) as DTensors placed as the matching leaves of ``like`` (a cell's
    abstract args, or a part of them).  Every rank holds the whole tensor
    and keeps its own shard (no collective): on one rank that is the tensor
    itself, so an in-place step updates it."""
    if isinstance(like, dict):
        return {k: place_like(tree[k], v) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(place_like(t, v) for t, v in zip(tree, like))
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(tree, like.device_mesh, like.placements, src_data_rank=None)


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_axis(mesh, b: int):
    """Batch sharding axes, degraded to replication if b doesn't divide
    (long_500k has global_batch=1)."""
    from repro_torch.launch.mesh import batch_axes, mesh_shape
    bx = batch_axes(mesh)
    n = 1
    for a in bx:
        n *= mesh_shape(mesh)[a]
    if not bx or b % n:
        return None
    return bx if len(bx) > 1 else bx[0]


def _with_specs(tree, specs, mesh):
    return {k: _with_specs(v, specs[k], mesh) if isinstance(v, dict) else _sds(v, mesh, specs[k])
            for k, v in tree.items()}


def _token_batch_sds(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                     labels: bool) -> dict:
    b, s = shape.global_batch, shape.seq_len
    bax = _batch_axis(mesh, b)
    extra = cfg.frontend_len if cfg.frontend == "vision_stub" else 0
    batch = {"tokens": _sds(_empty((b, s - extra), torch.int32), mesh, (bax,))}
    if labels:
        batch["labels"] = _sds(_empty((b, s - extra), torch.int32), mesh, (bax,))
    if extra:
        batch["prefix_embeds"] = _sds(_empty((b, extra, cfg.d_model), _DTYPES[cfg.compute_dtype]),
                                      mesh, (bax, None, None))
    if cfg.is_encdec:
        batch["enc_frames"] = _sds(_empty((b, s, cfg.d_model), _DTYPES[cfg.compute_dtype]),
                                   mesh, (bax, None, None))
    return batch


def input_specs(arch: str, shape_name: str, mesh):
    """Abstract inputs for the cell. Returns (step, args)."""
    cell = build_cell(arch, shape_name, mesh)
    return cell.step, cell.args


def build_cell(arch: str, shape_name: str, mesh, *,
               remat: bool = True, probe_groups: int | None = None,
               rule_overrides: dict | None = None,
               cfg_overrides: dict | None = None) -> Cell:
    """cfg_overrides: dataclasses.replace fields (e.g. kv_quant=True).
    rule_overrides: logical-axis rules, and ``attn``: None or "chunked"
    picks ``Model(attn=...)`` (the reference's ``attn`` rule); "pallas"
    (the flash-attention kernel) is refused, and so is ``moe=shard_map``.
    probe_groups=k builds a k-group variant of the arch (same width and
    shape): the reference's roofline probes, which the port's dry run has
    no need of (its trace runs every layer)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if probe_groups is not None:
        unit = cfg.scan_unit()
        groups = cfg.n_layers // unit
        enc_ratio = cfg.n_encoder_layers // groups if cfg.is_encdec else 0
        cfg = dataclasses.replace(
            cfg, n_layers=unit * probe_groups,
            n_encoder_layers=enc_ratio * probe_groups)
    overrides = dict(rule_overrides or {})
    attn = overrides.pop("attn", None)
    if attn == "pallas":
        raise NotImplementedError(
            "attn=pallas: the flash-attention kernel has no DTensor (sharded) or meta form; "
            "the dry run traces attn=None or attn=chunked")
    if attn not in (None, "chunked"):
        raise ValueError(f"attn must be None, 'chunked' or 'pallas', got {attn!r}")
    if overrides.get("moe") == "shard_map":
        raise NotImplementedError(
            "moe=shard_map: the reference's expert-parallel _moe_shard_map / "
            "_moe_sharding_ok (src/repro/models/moe.py:76, 145) are not ported")
    model = Model(cfg, attn=attn, device="meta")
    mode = shape.kind
    rules = logical_rules(mesh, mode, overrides=overrides)

    max_seq = shape.seq_len if not cfg.use_rope else 4096
    params_sds = meta_params(cfg, max_seq=max_seq)
    p_specs = param_pspecs(cfg, params_sds, mesh, "train" if mode == "train" else "serve")
    params_in = _with_specs(params_sds, p_specs, mesh)

    if mode == "train":
        opt_cfg = OptConfig(moment_dtype=cfg.moment_dtype)
        opt_sds = init_opt(params_sds, opt_cfg)
        opt_in = {"m": _with_specs(opt_sds["m"], p_specs, mesh),
                  "v": _with_specs(opt_sds["v"], p_specs, mesh),
                  "count": _sds(opt_sds["count"], mesh, ())}
        batch = _token_batch_sds(cfg, shape, mesh, labels=True)
        step = make_train_step(model, opt_cfg, remat=remat)
        return Cell(arch, shape_name, cfg, step,
                    (params_in, opt_in, batch), donate=(0, 1),
                    rules=rules, mesh=mesh,
                    meta={"mode": mode, "opt": opt_cfg})

    if mode == "prefill":
        batch = _token_batch_sds(cfg, shape, mesh, labels=False)
        step = make_prefill_step(model)
        return Cell(arch, shape_name, cfg, step, (params_in, batch),
                    rules=rules, mesh=mesh, meta={"mode": mode})

    # decode: one new token against a KV cache of seq_len
    b, s = shape.global_batch, shape.seq_len
    cache_sds = model.init_cache(b, s)
    if cfg.is_encdec:
        hd = cfg.resolved_head_dim
        groups = cfg.n_layers // cfg.scan_unit()
        cross = {"k": _empty((groups, b, WHISPER_DECODE_ENC_LEN, cfg.n_heads, hd),
                             _DTYPES[cfg.compute_dtype]),
                 "v": _empty((groups, b, WHISPER_DECODE_ENC_LEN, cfg.n_heads, hd),
                             _DTYPES[cfg.compute_dtype])}
        cache_sds = {"self": cache_sds, "cross": cross}
    cache_in = _with_specs(cache_sds, cache_pspecs(cache_sds, mesh), mesh)
    bax = _batch_axis(mesh, b)
    tokens = _sds(_empty((b,), torch.int32), mesh, (bax,))
    pos = _sds(_empty((b,), torch.int32), mesh, (bax,))
    step = make_serve_step(model)
    return Cell(arch, shape_name, cfg, step,
                (params_in, tokens, cache_in, pos), donate=(2,),
                rules=rules, mesh=mesh, meta={"mode": "decode"})
