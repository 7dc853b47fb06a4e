"""Decoder and encoder-decoder stack, PyTorch port of
``repro.models.transformer``, covering the reference's ten architectures:

  dense        (attn, dense): gemma-2b, granite-3-8b, starcoder2-15b, and
               internvl2-76b behind its vision prefix
  gemma2       (attn_local, dense), (attn, dense): gemma2-2b
  moe          (attn, moe): dbrx-132b, llama4-scout-17b-a16e
  ssm          (ssm, none): mamba2-370m
  hybrid       a unit of 8 layers, (attn, moe), (ssm, dense), (ssm, moe),
               ...: an ssm mixer meets a dense or a MoE FFN (jamba)
  encdec       a bidirectional encoder stack, and decoder layers with
               cross-attention to its output (whisper-small)

Learned absolute positions (``pos_embed``) replace RoPE where
``use_rope`` is off and the stack has attention.  As in the reference, the
modality frontends are stubs (``models/frontends.py``): a batch brings
``prefix_embeds`` (vision patches, put before the tokens) or
``enc_frames`` (the encoder's input frames) precomputed.

Parameters are a nested dict of tensors in the reference's layout.  The
per-layer leaves under ``blocks`` keep the reference's leading group axis
(the layer plan's smallest repeating unit, stacked ``n_layers / unit``
times; the encoder's ``blocks`` one layer a group), and the reference's
``lax.scan`` over groups becomes a Python loop over each leaf's groups,
unbound into views once a call (``_groups``, no copy).  Caches are stacked the same way: KV leaves
(G, B, T, KV, hd), Mamba2 state leaves ``conv`` (G, B, W-1, C) and
``ssm`` (G, B, nh, hd, N); an encoder-decoder's prefill cache is
``{"self": ..., "cross": ...}``, the cross K/V (G, B, T_enc, H, hd).

Activations carry the reference's logical-axis annotations
(``sharding.logical.shard``: the residual stream between layers, the
logits), which redistribute DTensors inside ``logical_axis_rules`` and are
the identity anywhere else.

Three entry points as in the reference: ``forward`` (full sequence; its
``moe_aux`` sums every MoE layer's load-balancing loss; ``remat``
recomputes each group in the backward), ``prefill`` (full
sequence -> logits + cache), ``decode_step`` (one token, cache updated in
place).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.logical import shard, splittable, take_rows
from . import attention as attn
from . import mamba2 as ssm
from .layers import embed_init, mlp_apply, mlp_init, rmsnorm, rmsnorm_init, softcap
from .moe import moe_apply, moe_init

__all__ = ["Model"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _groups(tree) -> list[dict]:
    """Every group of a group-stacked tree, as views (a write through one
    lands in the tree): one ``unbind`` a leaf, whose backward stacks the
    groups' gradients into one leaf-sized tensor (indexing each group
    instead makes a leaf-sized gradient per group, zero-filled and then
    summed)."""
    parts = {k: _groups(v) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: part[g] for k, part in parts.items()} for g in range(n)]


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
        if self.attn not in attn.ATTN_IMPLS:
            raise ValueError(f"attn must be one of {attn.ATTN_IMPLS}, got {self.attn!r}")
        object.__setattr__(self, "device", resolve_device(self.device))

    # ---- construction -----------------------------------------------------
    def init(self, generator: torch.Generator, *, max_seq: int = 4096):
        """Random parameters drawn from ``generator``, which must live on
        ``self.device``.  ``max_seq`` sizes the learned position tables,
        as the reference's does."""
        cfg = self.cfg
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        dtype = _dtype(cfg.param_dtype)
        groups = (self._n_groups(),)
        params = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype)}
        params["blocks"] = {
            f"layer{j}": self._init_layer(generator, mixer, ffn, dtype, groups,
                                          with_cross=cfg.is_encdec)
            for j, (mixer, ffn) in enumerate(self._unit_plan())}
        params["final_norm"] = rmsnorm_init(cfg.d_model, dtype, self.device)
        if not cfg.tie_embeddings:
            params["lm_head"] = embed_init(generator, cfg.vocab_size, cfg.d_model,
                                           dtype).T.contiguous()
        if not cfg.use_rope and any(m.startswith("attn") for m, _ in cfg.layer_plan()):
            # learned absolute positions (whisper); attention-free stacks
            # (mamba2) need no positional encoding at all
            params["pos_embed"] = embed_init(generator, max_seq, cfg.d_model, dtype)
        if cfg.is_encdec:
            params["encoder"] = {
                "pos_embed": embed_init(generator, max_seq, cfg.d_model, dtype),
                "blocks": {"layer0": self._init_layer(generator, "attn", "dense", dtype,
                                                      (cfg.n_encoder_layers,),
                                                      with_cross=False)},
                "final_norm": rmsnorm_init(cfg.d_model, dtype, self.device)}
        return params

    def _init_layer(self, gen, mixer: str, ffn: str, dtype, groups: tuple, *,
                    with_cross: bool):
        cfg, dev = self.cfg, self.device
        layer = {"mixer_norm": rmsnorm_init(cfg.d_model, dtype, dev, groups)}
        if mixer == "ssm":
            layer["mixer"] = ssm.ssm_init(gen, cfg, dtype, groups=groups)
        else:
            layer["mixer"] = attn.attn_init(gen, cfg, dtype, groups=groups)
        if with_cross:
            layer["cross_norm"] = rmsnorm_init(cfg.d_model, dtype, dev, groups)
            layer["cross"] = attn.attn_init(gen, cfg, dtype, cross=True, groups=groups)
        if ffn == "dense":
            layer["ffn_norm"] = rmsnorm_init(cfg.d_model, dtype, dev, groups)
            layer["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype,
                                    groups=groups)
        elif ffn == "moe":
            layer["ffn_norm"] = rmsnorm_init(cfg.d_model, dtype, dev, groups)
            layer["ffn"] = moe_init(gen, cfg, dtype, groups=groups)
        return layer

    # ---- shared pieces -----------------------------------------------------
    def _embed(self, params, tokens):
        cfg = self.cfg
        x = take_rows(params["embed"], tokens.long()).to(_dtype(cfg.compute_dtype))
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
        return shard(softcap(logits.float(), cfg.logit_softcap), ("batch", None, "model"))

    def _unit_plan(self):
        unit = self.cfg.scan_unit()
        return self.cfg.layer_plan()[:unit]

    def _n_groups(self) -> int:
        return self.cfg.n_layers // self.cfg.scan_unit()

    # ---- encoder (whisper) --------------------------------------------------
    def encode(self, params, enc_frames):
        """enc_frames: (B, T, D) precomputed stub frontend embeddings.
        Bidirectional attention (the plain sdpa on every route, as in the
        reference) and a dense MLP a layer, then the final norm."""
        cfg = self.cfg
        enc = params["encoder"]
        t = enc_frames.shape[1]
        x = enc_frames.to(_dtype(cfg.compute_dtype))
        x = x + enc["pos_embed"][:t].to(x.dtype)
        positions = torch.arange(t, device=x.device)
        for gp in _groups(enc["blocks"]):
            sub = gp["layer0"]
            x = x + attn.attn_apply(sub["mixer"], cfg,
                                    rmsnorm(x, sub["mixer_norm"], cfg.norm_eps),
                                    positions, causal=False)
            x = x + mlp_apply(sub["ffn"], rmsnorm(x, sub["ffn_norm"], cfg.norm_eps),
                              cfg.mlp_type)
            x = shard(x, ("batch", "seq", None))
        return rmsnorm(x, enc["final_norm"], cfg.norm_eps)

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

    def _stack(self, params, x, positions, memory, *, collect_cache: bool,
               remat: bool = False):
        """(x, the MoE aux loss summed over layers and groups as the
        reference's scan carry, the stacked cache or None).  ``memory`` is
        the encoder's output (cross-attention after each mixer) or None.
        With ``remat`` each group's layers run under
        ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with
        ``nothing_saveable`` around its scan body): the backward keeps each
        group's input and recomputes the rest."""
        caches = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for gp in _groups(params["blocks"]):
            if remat and not collect_cache:
                x, aux, _ = checkpoint(self._group_body, gp, x, aux, positions, memory,
                                       use_reentrant=False, preserve_rng_state=False)
                continue
            x, aux, cache_out = self._group_body(gp, x, aux, positions, memory,
                                                 collect_cache=collect_cache)
            caches.append(cache_out)
        if not collect_cache:
            return x, aux, None
        stacked = {name: {leaf: torch.stack([c[name][leaf] for c in caches])
                          for leaf in caches[0][name]}
                   for name in caches[0]}
        return x, aux, stacked

    def _group_body(self, gp, x, aux, positions, memory, *, collect_cache: bool = False):
        """One layer group (the unit plan) on ``x``: (x, aux, the group's
        cache entries, empty without ``collect_cache``)."""
        cfg = self.cfg
        cache_out = {}
        for j, (mixer, ffn) in enumerate(self._unit_plan()):
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
            x = x + a
            if memory is not None:
                x = x + attn.attn_apply(sub["cross"], cfg,
                                        rmsnorm(x, sub["cross_norm"], cfg.norm_eps),
                                        positions, causal=False, xkv=memory)
            x, layer_aux = self._ffn(sub, ffn, x)
            if layer_aux is not None:
                aux = aux + layer_aux
            x = shard(x, ("batch", "seq", None))
        return x, aux, cache_out

    def _inputs(self, params, batch):
        """(the stack's input x, its positions, the encoder's output or
        None) for a full-sequence call: token embeddings after the vision
        prefix where the config has a frontend and the batch holds one,
        learned positions added where the model has them."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        if cfg.frontend and "prefix_embeds" in batch:
            x = torch.cat([batch["prefix_embeds"].to(x.dtype), x], dim=1)
        s = x.shape[1]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, device=x.device)
        if "pos_embed" in params:
            x = x + params["pos_embed"][:s].to(x.dtype)
        memory = None
        if cfg.is_encdec:
            if "enc_frames" not in batch:
                raise ValueError(
                    f"{cfg.name} is an encoder-decoder model: a full-sequence call needs "
                    "batch['enc_frames'], the encoder's input frames")
            memory = self.encode(params, batch["enc_frames"])
        return shard(x, ("batch", "seq", None)), positions, memory

    def forward(self, params, batch, *, remat: bool = False):
        """Full-sequence logits. batch: dict(tokens, positions?,
        prefix_embeds?, enc_frames?).  ``remat`` recomputes each decoder
        group in the backward (the encoder keeps its activations, as the
        reference's)."""
        x, positions, memory = self._inputs(params, batch)
        x, aux, _ = self._stack(params, x, positions, memory, collect_cache=False,
                                remat=remat)
        return self._logits(params, x), {"moe_aux": aux}

    # ---- serving: prefill + decode -------------------------------------------
    def init_cache(self, batch: int, max_len: int):
        """Zeroed cache with leaves stacked over layer groups: KV for an
        attention layer, the conv window and SSM state for an ssm layer.
        An encoder-decoder's cross K/V come only from ``prefill``, as in
        the reference: this is its self cache."""
        cfg = self.cfg
        groups = (self._n_groups(),)
        dtype = _dtype(cfg.compute_dtype)
        return {f"layer{j}": ssm.init_ssm_state(cfg, batch, dtype, self.device, groups=groups)
                if mixer == "ssm" else
                attn.init_kv_cache(cfg, batch, max_len, dtype, self.device,
                                   local=(mixer == "attn_local"), groups=groups)
                for j, (mixer, _) in enumerate(self._unit_plan())}

    def prefill(self, params, batch):
        """Returns (logits_full, cache).  Cache holds S_prefill positions
        (prefix included), stacked over groups: (G, B, S, KV, hd), and each
        ssm layer's state after the whole sequence; the engine copies it
        into its slot cache for decode_step.  An encoder-decoder's cache is
        ``{"self": ..., "cross": ...}``."""
        x, positions, memory = self._inputs(params, batch)
        x, _, cache = self._stack(params, x, positions, memory, collect_cache=True)
        if memory is not None:
            cache = {"self": cache, "cross": self._cross_cache(params, memory)}
        return self._logits(params, x), cache

    def _cross_cache(self, params, memory):
        """Each decoder layer's cross-attention K and V of the encoder's
        output: ``memory @ wk`` and ``memory @ wv`` (no norm), n_heads
        heads, stacked over groups."""
        hd = self.cfg.resolved_head_dim
        cross = params["blocks"]["layer0"]["cross"]
        return {name: torch.stack([splittable(memory @ w[g], hd).reshape(
                                       *memory.shape[:-1], -1, hd)
                                   for g in range(self._n_groups())])
                for name, w in (("k", cross["wk"]), ("v", cross["wv"]))}

    def decode_step(self, params, tokens, cache, pos):
        """tokens: (B,) int; pos: (B,) int current positions.

        Returns (logits: (B, vocab), cache); ``cache`` is updated in place
        and returned (an encoder-decoder's cross K/V unchanged)."""
        cfg = self.cfg
        plan = self._unit_plan()
        pos = pos.long()
        x = self._embed(params, tokens[:, None])
        if "pos_embed" in params:
            x = x + take_rows(params["pos_embed"], pos)[:, None].to(x.dtype)
        self_cache = cache["self"] if cfg.is_encdec else cache
        b, hd = x.shape[0], cfg.resolved_head_dim
        for g, (gp, gc) in enumerate(zip(_groups(params["blocks"]), _groups(self_cache))):
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
                x = x + a
                if cfg.is_encdec:
                    # the plain sdpa over the whole encoder output, no mask
                    hin = rmsnorm(x, sub["cross_norm"], cfg.norm_eps)
                    q = splittable(hin @ sub["cross"]["wq"], hd).reshape(b, 1, cfg.n_heads, hd)
                    o = attn._sdpa(cfg, q, cache["cross"]["k"][g], cache["cross"]["v"][g],
                                   None)
                    x = x + o.reshape(b, 1, -1) @ sub["cross"]["wo"]
                x, _ = self._ffn(sub, ffn, x)
        return self._logits(params, x)[:, 0], cache
