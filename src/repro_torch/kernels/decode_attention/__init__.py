from .ops import decode_attention, reference_decode_attention  # noqa: F401
