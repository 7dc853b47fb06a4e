"""Granite-3 8B — GQA (kv=8), SwiGLU [hf:ibm-granite/granite-3.0-2b-base; hf]."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    mlp_type="swiglu",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
))
