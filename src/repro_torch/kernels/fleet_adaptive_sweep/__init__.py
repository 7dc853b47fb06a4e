from .ops import fleet_adaptive_sweep, reference_fleet_adaptive_sweep  # noqa: F401
