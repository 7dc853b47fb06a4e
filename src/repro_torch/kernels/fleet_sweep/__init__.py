from .ops import FleetParams, fleet_sweep, reference_fleet_sweep  # noqa: F401
