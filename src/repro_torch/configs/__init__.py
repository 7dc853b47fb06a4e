"""Model configurations carried by the port so far.

Importing this package registers every config; use
``repro_torch.configs.base.get_config(name)``.  Slice 1 carries the dense
gemma family: gemma-2b (the served model) and gemma2-2b (local/global
attention with softcaps).
"""

from .base import ModelConfig, ShapeConfig, SHAPES, get_config, list_configs, register
from . import (  # noqa: F401  (registration side effects)
    gemma_2b,
    gemma2_2b,
)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "get_config",
           "list_configs", "register"]
