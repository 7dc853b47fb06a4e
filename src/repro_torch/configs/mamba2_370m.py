"""Mamba2-370M — attention-free SSD (state-space duality) [arXiv:2405.21060; unverified]."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,               # mamba2 blocks have no separate FFN
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
    use_rope=False,       # no attention; no positional encoding needed
    source="arXiv:2405.21060; unverified",
))
