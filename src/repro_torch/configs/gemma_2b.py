"""Gemma-2B — GeGLU, head_dim=256, MQA (kv=1) [arXiv:2403.08295; hf]."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_type="geglu",
    scale_embeddings=True,
    tie_embeddings=True,
    source="arXiv:2403.08295; hf",
))
