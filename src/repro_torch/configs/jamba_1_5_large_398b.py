"""Jamba-1.5-Large 398B — Mamba+attention 1:7 interleave, 16e top-2 MoE
[arXiv:2403.19887; hf].

Adaptation note (DESIGN.md): Jamba's SSM layers are Mamba-1; our SSM
substrate is the Mamba2/SSD block (the TPU-native chunked formulation),
with d_state=64.  Layer plan: attention on layer 0 of each 8-layer group,
MoE FFN every 2nd layer.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    moe_period=2,
    attn_period=8,          # 1 attention : 7 mamba
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    mlp_type="swiglu",
    tie_embeddings=False,
    use_rope=True,
    moment_dtype="bfloat16",  # 398B params: bf16 moments to fit 16GB/chip
    source="arXiv:2403.19887; hf",
))
