"""Decoder stack, PyTorch port of ``repro.models.transformer`` for the
dense family (``attn`` / ``attn_local`` mixers with a dense FFN: gemma-2b,
gemma2-2b, granite-3-8b, starcoder2-15b), the MoE family (``attn`` mixers
with a MoE FFN, ``models/moe.py``: dbrx-132b, llama4-scout-17b-a16e) and
the Mamba2 family (``ssm`` mixers without an FFN: mamba2-370m).  The
hybrid (jamba), encoder-decoder and frontend families are refused.

Parameters are a nested dict of tensors in the reference's layout.  The
per-layer leaves under ``blocks`` keep the reference's leading group axis
(the layer plan's smallest repeating unit, stacked ``n_layers / unit``
times), and the reference's ``lax.scan`` over groups becomes a Python loop
that indexes group ``g`` of each leaf (a view, no copy).  Caches are
stacked the same way: KV leaves (G, B, T, KV, hd), Mamba2 state leaves
``conv`` (G, B, W-1, C) and ``ssm`` (G, B, nh, hd, N).

Three entry points as in the reference: ``forward`` (full sequence; its
``moe_aux`` sums every MoE layer's load-balancing loss), ``prefill`` (full
sequence -> logits + cache), ``decode_step`` (one token, cache updated in
place).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from . import attention as attn
from . import mamba2 as ssm
from .layers import embed_init, mlp_apply, mlp_init, rmsnorm, rmsnorm_init, softcap
from .moe import moe_apply, moe_init

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
    if cfg.family == "hybrid":
        return "the hybrid family (jamba) comes with its own slice"
    plan = cfg.layer_plan()
    # the reference adds learned positions only to a stack with attention
    # (transformer.py: pos_embed); an attention-free stack has none
    if not cfg.use_rope and any(m.startswith("attn") for m, _ in plan):
        return "learned absolute positions come with the model-family slice"
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
        for j, (mixer, ffn) in enumerate(self._unit_plan()):
            layer = {"mixer_norm": rmsnorm_init(cfg.d_model, dtype, dev, groups)}
            if mixer == "ssm":
                layer["mixer"] = ssm.ssm_init(generator, cfg, dtype, groups=groups)
            else:
                layer["mixer"] = attn.attn_init(generator, cfg, dtype, groups=groups)
            if ffn == "dense":
                layer["ffn_norm"] = rmsnorm_init(cfg.d_model, dtype, dev, groups)
                layer["ffn"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                                        dtype, groups=groups)
            elif ffn == "moe":
                layer["ffn_norm"] = rmsnorm_init(cfg.d_model, dtype, dev, groups)
                layer["ffn"] = moe_init(generator, cfg, dtype, groups=groups)
            blocks[f"layer{j}"] = layer
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
    def _ffn(self, sub, ffn: str, x):
        """(x + the layer's FFN of x, its MoE aux loss or None)."""
        cfg = self.cfg
        if ffn == "dense":
            return x + mlp_apply(sub["ffn"], rmsnorm(x, sub["ffn_norm"], cfg.norm_eps),
                                 cfg.mlp_type), None
        if ffn == "moe":
            f, aux = moe_apply(sub["ffn"], cfg, rmsnorm(x, sub["ffn_norm"], cfg.norm_eps))
            return x + f, aux
        return x, None

    def _stack(self, params, x, positions, *, collect_cache: bool):
        """(x, the MoE aux loss summed over layers and groups as the
        reference's scan carry, the stacked cache or None)."""
        cfg = self.cfg
        plan = self._unit_plan()
        caches = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for g in range(self._n_groups()):
            gp = _group(params["blocks"], g)
            cache_out = {}
            for j, (mixer, ffn) in enumerate(plan):
                sub = gp[f"layer{j}"]
                local = mixer == "attn_local"
                hin = rmsnorm(x, sub["mixer_norm"], cfg.norm_eps)
                if mixer == "ssm":
                    a, state = ssm.ssm_forward(sub["mixer"], cfg, hin)
                    if collect_cache:
                        cache_out[f"layer{j}"] = state
                elif collect_cache:
                    a, cache_out[f"layer{j}"] = attn.attn_prefill(
                        sub["mixer"], cfg, hin, positions, local=local, impl=self.attn)
                else:
                    a = attn.attn_apply(sub["mixer"], cfg, hin, positions,
                                        local=local, impl=self.attn)
                x, layer_aux = self._ffn(sub, ffn, x + a)
                if layer_aux is not None:
                    aux = aux + layer_aux
            caches.append(cache_out)
        if not collect_cache:
            return x, aux, None
        stacked = {name: {leaf: torch.stack([c[name][leaf] for c in caches])
                          for leaf in caches[0][name]}
                   for name in caches[0]}
        return x, aux, stacked

    def forward(self, params, batch):
        """Full-sequence logits. batch: dict(tokens, positions?)."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        x, aux, _ = self._stack(params, x, positions, collect_cache=False)
        return self._logits(params, x), {"moe_aux": aux}

    # ---- serving: prefill + decode -------------------------------------------
    def init_cache(self, batch: int, max_len: int):
        """Zeroed cache with leaves stacked over layer groups: KV for an
        attention layer, the conv window and SSM state for an ssm layer."""
        cfg = self.cfg
        groups = (self._n_groups(),)
        dtype = _dtype(cfg.compute_dtype)
        return {f"layer{j}": ssm.init_ssm_state(cfg, batch, dtype, self.device, groups=groups)
                if mixer == "ssm" else
                attn.init_kv_cache(cfg, batch, max_len, dtype, self.device,
                                   local=(mixer == "attn_local"), groups=groups)
                for j, (mixer, _) in enumerate(self._unit_plan())}

    def prefill(self, params, batch):
        """Returns (logits_full, cache).  Cache holds S_prefill positions,
        stacked over groups: (G, B, S, KV, hd), and each ssm layer's state
        after the whole sequence; the engine copies it into its slot cache
        for decode_step."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        x, _, cache = self._stack(params, x, positions, collect_cache=True)
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
            for j, (mixer, ffn) in enumerate(plan):
                sub = gp[f"layer{j}"]
                hin = rmsnorm(x, sub["mixer_norm"], cfg.norm_eps)
                if mixer == "ssm":
                    a, state = ssm.ssm_decode(sub["mixer"], cfg, hin, gc[f"layer{j}"])
                    # gc holds views of group g: store the new state through
                    # them, or the step would be lost
                    for leaf, value in state.items():
                        gc[f"layer{j}"][leaf].copy_(value)
                else:
                    a, _ = attn.attn_decode(sub["mixer"], cfg, hin, gc[f"layer{j}"], pos,
                                            local=(mixer == "attn_local"))
                x, _ = self._ffn(sub, ffn, x + a)
        return self._logits(params, x)[:, 0], cache
