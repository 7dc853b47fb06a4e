"""Model configurations carried by the port so far.

Importing this package registers every config; use
``repro_torch.configs.base.get_config(name)``.  The port carries the dense
gemma family, gemma-2b (the served model) and gemma2-2b (local/global
attention with softcaps), and mamba2-370m, whose SSD widths size the
``ssd_scan`` kernel (its model family is not ported yet).
"""

from .base import ModelConfig, ShapeConfig, SHAPES, get_config, list_configs, register
from . import (  # noqa: F401  (registration side effects)
    gemma_2b,
    gemma2_2b,
    mamba2_370m,
)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "get_config",
           "list_configs", "register"]
