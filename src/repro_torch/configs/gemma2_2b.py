"""Gemma2-2B — local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf]."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    mlp_type="geglu",
    local_global_period=2,
    local_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    scale_embeddings=True,
    tie_embeddings=True,
    source="arXiv:2408.00118; hf",
))
