"""Decoder stack, PyTorch port of ``repro.models.transformer`` for the
dense family (``attn`` / ``attn_local`` mixers with a dense FFN): gemma-2b,
gemma2-2b and the other dense configs.

Parameters are a nested dict of tensors in the reference's layout.  The
per-layer leaves under ``blocks`` keep the reference's leading group axis
(the layer plan's smallest repeating unit, stacked ``n_layers / unit``
times), and the reference's ``lax.scan`` over groups becomes a Python loop
that indexes group ``g`` of each leaf (a view, no copy).  Caches are
stacked the same way: (G, B, T, KV, hd).

Three entry points as in the reference: ``forward`` (full sequence),
``prefill`` (full sequence -> logits + cache), ``decode_step`` (one token,
cache updated in place).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from . import attention as attn
from .layers import embed_init, mlp_apply, mlp_init, rmsnorm, rmsnorm_init, softcap

__all__ = ["Model"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _unsupported(cfg: ModelConfig) -> str | None:
    """Why the port cannot run ``cfg`` yet, or None."""
    if cfg.is_encdec:
        return "encoder-decoder models (whisper) come with the model-family slice"
    if cfg.frontend:
        return "modality frontends come with the model-family slice"
    if not cfg.use_rope:
        return "learned absolute positions come with the model-family slice"
    for mixer, ffn in cfg.layer_plan():
        if mixer == "ssm":
            return "Mamba2 (ssm) layers come with the model-family slice"
        if ffn == "moe":
            return "MoE FFNs come with the model-family slice"
    return None


def _group(tree, g: int):
    """Group ``g`` of every leaf of a group-stacked tree (views)."""
    return {k: _group(v, g) if isinstance(v, dict) else v[g] for k, v in tree.items()}


@dataclass(frozen=True)
class Model:
    """``attn`` picks the attention route for full-sequence layers: None
    (masked sdpa), ``"chunked"`` or ``"kernel"`` (the flash-attention
    kernel; the reference's ``attn=pallas`` rule).  ``device`` holds the
    parameters and caches; CUDA is the default and is never silently
    replaced by the CPU."""

    cfg: ModelConfig
    attn: str | None = None
    device: str | torch.device = "cuda"

    def __post_init__(self):
        why = _unsupported(self.cfg)
        if why is not None:
            raise NotImplementedError(f"{self.cfg.name}: {why} (ROADMAP Queue 1)")
        if self.attn not in attn.ATTN_IMPLS:
            raise ValueError(f"attn must be one of {attn.ATTN_IMPLS}, got {self.attn!r}")
        object.__setattr__(self, "device", resolve_device(self.device))

    # ---- construction -----------------------------------------------------
    def init(self, generator: torch.Generator):
        """Random parameters drawn from ``generator``, which must live on
        ``self.device``."""
        cfg = self.cfg
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        dtype = _dtype(cfg.param_dtype)
        unit = cfg.scan_unit()
        groups = (cfg.n_layers // unit,)
        dev = self.device
        params = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype)}
        blocks = {}
        for j in range(unit):
            blocks[f"layer{j}"] = {
                "mixer_norm": rmsnorm_init(cfg.d_model, dtype, dev, groups),
                "mixer": attn.attn_init(generator, cfg, dtype, groups=groups),
                "ffn_norm": rmsnorm_init(cfg.d_model, dtype, dev, groups),
                "ffn": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                                dtype, groups=groups),
            }
        params["blocks"] = blocks
        params["final_norm"] = rmsnorm_init(cfg.d_model, dtype, dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = embed_init(generator, cfg.vocab_size, cfg.d_model,
                                           dtype).T.contiguous()
        return params

    # ---- shared pieces -----------------------------------------------------
    def _embed(self, params, tokens):
        cfg = self.cfg
        x = params["embed"][tokens.long()].to(_dtype(cfg.compute_dtype))
        if cfg.scale_embeddings:
            # sqrt(d_model) rounded to the compute dtype first, as the reference
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
        return x

    def _logits(self, params, x):
        cfg = self.cfg
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = x @ params["embed"].to(x.dtype).T
        else:
            logits = x @ params["lm_head"].to(x.dtype)
        return softcap(logits.float(), cfg.logit_softcap)

    def _unit_plan(self):
        unit = self.cfg.scan_unit()
        return self.cfg.layer_plan()[:unit]

    def _n_groups(self) -> int:
        return self.cfg.n_layers // self.cfg.scan_unit()

    # ---- full-sequence decoder (forward / prefill core) ---------------------
    def _stack(self, params, x, positions, *, collect_cache: bool):
        cfg = self.cfg
        plan = self._unit_plan()
        caches = []
        for g in range(self._n_groups()):
            gp = _group(params["blocks"], g)
            cache_out = {}
            for j, (mixer, _ffn) in enumerate(plan):
                sub = gp[f"layer{j}"]
                local = mixer == "attn_local"
                hin = rmsnorm(x, sub["mixer_norm"], cfg.norm_eps)
                if collect_cache:
                    a, cache_out[f"layer{j}"] = attn.attn_prefill(
                        sub["mixer"], cfg, hin, positions, local=local, impl=self.attn)
                else:
                    a = attn.attn_apply(sub["mixer"], cfg, hin, positions,
                                        local=local, impl=self.attn)
                x = x + a
                x = x + mlp_apply(sub["ffn"], rmsnorm(x, sub["ffn_norm"], cfg.norm_eps),
                                  cfg.mlp_type)
            caches.append(cache_out)
        if not collect_cache:
            return x, None
        stacked = {name: {leaf: torch.stack([c[name][leaf] for c in caches])
                          for leaf in caches[0][name]}
                   for name in caches[0]}
        return x, stacked

    def forward(self, params, batch):
        """Full-sequence logits. batch: dict(tokens, positions?)."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._stack(params, x, positions, collect_cache=False)
        return self._logits(params, x), {"moe_aux": torch.zeros((), device=x.device)}

    # ---- serving: prefill + decode -------------------------------------------
    def init_cache(self, batch: int, max_len: int):
        """Zeroed cache with leaves stacked over layer groups."""
        cfg = self.cfg
        groups = (self._n_groups(),)
        return {f"layer{j}": attn.init_kv_cache(
                    cfg, batch, max_len, _dtype(cfg.compute_dtype), self.device,
                    local=(mixer == "attn_local"), groups=groups)
                for j, (mixer, _) in enumerate(self._unit_plan())}

    def prefill(self, params, batch):
        """Returns (logits_full, cache).  Cache holds S_prefill positions,
        stacked over groups: (G, B, S, KV, hd); the engine copies it into
        its slot cache for decode_step."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        x, cache = self._stack(params, x, positions, collect_cache=True)
        return self._logits(params, x), cache

    def decode_step(self, params, tokens, cache, pos):
        """tokens: (B,) int; pos: (B,) int current positions.

        Returns (logits: (B, vocab), cache); ``cache`` is updated in place
        and returned."""
        cfg = self.cfg
        plan = self._unit_plan()
        pos = pos.long()
        x = self._embed(params, tokens[:, None])
        for g in range(self._n_groups()):
            gp = _group(params["blocks"], g)
            gc = _group(cache, g)
            for j, (mixer, _ffn) in enumerate(plan):
                sub = gp[f"layer{j}"]
                hin = rmsnorm(x, sub["mixer_norm"], cfg.norm_eps)
                a, _ = attn.attn_decode(sub["mixer"], cfg, hin, gc[f"layer{j}"], pos,
                                        local=(mixer == "attn_local"))
                x = x + a
                x = x + mlp_apply(sub["ffn"], rmsnorm(x, sub["ffn_norm"], cfg.norm_eps),
                                  cfg.mlp_type)
        return self._logits(params, x)[:, 0], cache
