"""Model configurations: the reference's ten architectures.

Importing this package registers every config; use
``repro_torch.configs.base.get_config(name)``.  The port carries all of
them:

- the dense family: gemma-2b, gemma2-2b (local/global attention with
  softcaps), granite-3-8b (GQA 32/8, swiglu), starcoder2-15b (GQA 48/4,
  gelu, untied embeddings) and internvl2-76b (GQA 64/8, behind a stub
  vision prefix of 256 positions);
- the MoE family: dbrx-132b (16 experts, top-4, GQA 48/8) and
  llama4-scout-17b-a16e (16 experts, top-1 plus a shared expert, GQA
  40/8, qk-norm);
- the Mamba2 family: mamba2-370m (attention-free SSD blocks, whose widths
  also size the ``ssd_scan`` kernel);
- the hybrid jamba-1.5-large-398b (one attention layer to seven Mamba2
  layers, a MoE FFN every second layer);
- the encoder-decoder whisper-small (learned positions, cross-attention,
  a stub audio frontend).

The engine serves every one but whisper-small, whose prefill needs the
encoder's frames: as in the reference, it runs through ``Model`` alone.

``metronome_l3fwd`` holds the paper's own Sec 5 configuration (the l3fwd
testbed: ``PAPER_CONFIG``, ``PAPER_SIM``).  It is not a model, so, as in
the reference, it is imported by its module path and not registered.
"""

from .base import ModelConfig, ShapeConfig, SHAPES, cells, get_config, list_configs, register
from . import (  # noqa: F401  (registration side effects)
    dbrx_132b,
    gemma_2b,
    gemma2_2b,
    granite_3_8b,
    internvl2_76b,
    jamba_1_5_large_398b,
    llama4_scout_17b_a16e,
    mamba2_370m,
    starcoder2_15b,
    whisper_small,
)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "cells", "get_config",
           "list_configs", "register"]
