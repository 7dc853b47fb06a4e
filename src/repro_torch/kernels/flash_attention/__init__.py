from .ops import flash_attention, flash_attention_ref  # noqa: F401
