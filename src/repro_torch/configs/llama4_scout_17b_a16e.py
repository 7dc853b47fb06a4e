"""Llama-4 Scout 17B-active/16E — top-1 MoE + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    experts_per_token=1,
    n_shared_experts=1,
    moe_period=1,
    mlp_type="swiglu",
    qk_norm=True,
    tie_embeddings=False,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
))
