from .ops import SweepParams, energy_arm_cost, reference_slot_sweep, slot_sweep  # noqa: F401
