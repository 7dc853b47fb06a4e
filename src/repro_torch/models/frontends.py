"""Stub modality frontends, PyTorch port of ``repro.models.frontends``
(per the assignment, the ``[audio]`` / ``[vlm]`` entries specify the
transformer BACKBONE only; the frontend provides precomputed frame/patch
embeddings).

These helpers synthesize embeddings with the right shapes — what a real
ViT patchifier (internvl2) or log-mel conv stack (whisper) would emit —
for tests, examples and the serving path: N(0, 1) × 0.02 in the compute
dtype, as the reference's.  They draw from an explicit
``torch.Generator``, on the generator's device; the numbers differ from
``jax.random``'s, so tests hand both packages the same numpy inputs.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from .transformer import _dtype

__all__ = ["vision_patches", "audio_frames"]


def _normal(gen: torch.Generator, shape, cfg: ModelConfig) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=_dtype(cfg.compute_dtype),
                       device=gen.device) * 0.02


def vision_patches(cfg: ModelConfig, batch: int, *, generator: torch.Generator):
    """(B, frontend_len, d_model) patch embeddings (InternViT stand-in)."""
    assert cfg.frontend == "vision_stub", cfg.name
    return _normal(generator, (batch, cfg.frontend_len, cfg.d_model), cfg)


def audio_frames(cfg: ModelConfig, batch: int, n_frames: int, *, generator: torch.Generator):
    """(B, T, d_model) encoder frame embeddings (conv frontend stand-in)."""
    assert cfg.frontend == "audio_stub", cfg.name
    return _normal(generator, (batch, n_frames, cfg.d_model), cfg)
