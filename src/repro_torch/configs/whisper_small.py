"""Whisper-small — enc-dec, conv audio frontend (STUB per assignment)
[arXiv:2212.04356; unverified].

12 encoder + 12 decoder layers, learned positions (no RoPE); the audio
frontend is a stub — input_specs() provides precomputed frame embeddings.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,            # decoder layers
    n_encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    mlp_type="gelu",
    use_rope=False,
    tie_embeddings=True,
    frontend="audio_stub",
    source="arXiv:2212.04356; unverified",
))
