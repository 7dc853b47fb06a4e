"""InternVL2-76B — InternViT + InternLM2 backbone [arXiv:2404.16821; unverified].

Per the assignment the modality frontend is a STUB: input_specs() provides
precomputed patch embeddings (``prefix_embeds``); this config is the
InternLM2-76B-style dense LM backbone.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    mlp_type="swiglu",
    tie_embeddings=False,
    frontend="vision_stub",
    frontend_len=256,
    source="arXiv:2404.16821; unverified",
))
