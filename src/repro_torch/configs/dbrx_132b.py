"""DBRX-132B — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base; unverified]."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    experts_per_token=4,
    moe_period=1,
    mlp_type="swiglu",
    tie_embeddings=False,
    rope_theta=500_000.0,
    moment_dtype="bfloat16",   # 132B total params: bf16 moments to fit 16GB/chip
    source="hf:databricks/dbrx-base; unverified",
))
