from .ops import AdaptiveParams, adaptive_sweep, reference_adaptive_sweep  # noqa: F401
