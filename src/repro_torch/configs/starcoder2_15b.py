"""StarCoder2-15B — GQA (kv=4), RoPE, GELU FFN [arXiv:2402.19173; hf]."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="gelu",
    tie_embeddings=False,
    source="arXiv:2402.19173; hf",
))
