"""repro_torch.runtime — retrieval policies, queues, workloads, the
threaded ``Runtime``, the paper's discrete-event simulator
(``simulate_run``), load schedules (copied from ``repro.runtime``), co-run
apps, the batched sweeps and the calibration layer.

``simulate_batch`` runs a whole ``SweepGrid`` in one launch of a
hand-written CUDA kernel: ``repro_torch.kernels.slot_sweep`` (fixed slots)
or, with ``stepping="adaptive"``, ``repro_torch.kernels.adaptive_sweep``
(event jumps); their plain versions with ``device="cpu"``.
``build_operating_table`` distils such a sweep into an ``OperatingTable``
(``calibrate``).  ``simulate_fleet`` runs a ``FleetGrid`` (hosts behind a
load balancer, with topology and hedging) in one launch of
``repro_torch.kernels.fleet_sweep`` (``fleet``).  ``MatmulAppLoad`` is a
``torch.matmul`` tenant.
"""

from .apps import (
    AppLoad,
    DutyCycleBurner,
    MatmulAppLoad,
    co_run_config,
)
from .assignment import (
    Assignment,
    DedicatedAssignment,
    SharedAssignment,
    StealingAssignment,
    ThreadSlot,
    clone_policy,
)
from .dispatch import (
    Dispatcher,
    FlowHashDispatch,
    LeastLoadedDispatch,
    RoundRobinDispatch,
    StaleLeastLoadedDispatch,
    WeightedDispatch,
)
from .policy import (
    BusyPollPolicy,
    EqualTimeoutsPolicy,
    FixedPeriodPolicy,
    MetronomePolicy,
    RetrievalPolicy,
    WakeContext,
)
from .queues import BoundedQueue
from .runtime import Runtime
from .schedule import (
    LoadSchedule,
    MMPPSchedule,
    RampSchedule,
    SinusoidSchedule,
    StepSchedule,
    from_trace,
)
from .sim import (
    HR_SLEEP_MODEL,
    NANOSLEEP_MODEL,
    PERFECT_SLEEP_MODEL,
    SimRunConfig,
    SleepModel,
    fleet_tail_reference,
    simulate_fleet_run,
    simulate_run,
)
from .simcore import (
    DEEP_CSTATE_ENERGY_MODEL,
    DEFAULT_ENERGY_MODEL,
    EnergyModel,
    FleetConfig,
)
from .stats import (
    QueueStats,
    Reservoir,
    RunStats,
    TrackingStats,
    WindowedSeries,
    hedged_latency_quantile,
)
from .workload import (
    CBRWorkload,
    OnOffBurstyWorkload,
    PoissonWorkload,
    ScheduledWorkload,
    TraceReplayWorkload,
    Workload,
)

# The batched engine (and the calibration layer on top of it) import torch
# and the kernel package; load them lazily, as the reference does, so the
# numpy-only event sim / threaded / serving paths do not pay for them.
_LAZY_SUBMODULE = {
    "SweepGrid": "batched",
    "BatchStats": "batched",
    "simulate_batch": "batched",
    "unsupported_config_fields": "batched",
    "validate_batched_config": "batched",
    "OperatingPoint": "calibrate",
    "OperatingTable": "calibrate",
    "CalibrationMismatch": "calibrate",
    "build_operating_table": "calibrate",
    "schedule_spot_check": "calibrate",
    "FleetGrid": "fleet",
    "FleetStats": "fleet",
    "simulate_fleet": "fleet",
}


def __getattr__(name: str):
    submodule = _LAZY_SUBMODULE.get(name)
    if submodule is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module
    value = getattr(import_module(f".{submodule}", __name__), name)
    globals()[name] = value          # cache: next access skips this hook
    return value


__all__ = [
    "RetrievalPolicy",
    "WakeContext",
    "BusyPollPolicy",
    "MetronomePolicy",
    "FixedPeriodPolicy",
    "EqualTimeoutsPolicy",
    "Workload",
    "PoissonWorkload",
    "CBRWorkload",
    "OnOffBurstyWorkload",
    "TraceReplayWorkload",
    "ScheduledWorkload",
    "LoadSchedule",
    "StepSchedule",
    "RampSchedule",
    "SinusoidSchedule",
    "MMPPSchedule",
    "from_trace",
    "Dispatcher",
    "RoundRobinDispatch",
    "FlowHashDispatch",
    "LeastLoadedDispatch",
    "WeightedDispatch",
    "StaleLeastLoadedDispatch",
    "Assignment",
    "ThreadSlot",
    "SharedAssignment",
    "DedicatedAssignment",
    "StealingAssignment",
    "clone_policy",
    "BoundedQueue",
    "Runtime",
    "RunStats",
    "QueueStats",
    "Reservoir",
    "WindowedSeries",
    "TrackingStats",
    "SleepModel",
    "HR_SLEEP_MODEL",
    "NANOSLEEP_MODEL",
    "PERFECT_SLEEP_MODEL",
    "SimRunConfig",
    "EnergyModel",
    "DEFAULT_ENERGY_MODEL",
    "DEEP_CSTATE_ENERGY_MODEL",
    "simulate_run",
    "FleetConfig",
    "simulate_fleet_run",
    "fleet_tail_reference",
    "hedged_latency_quantile",
    "SweepGrid",
    "BatchStats",
    "simulate_batch",
    "unsupported_config_fields",
    "validate_batched_config",
    "OperatingPoint",
    "OperatingTable",
    "CalibrationMismatch",
    "build_operating_table",
    "schedule_spot_check",
    "FleetGrid",
    "FleetStats",
    "simulate_fleet",
    "AppLoad",
    "DutyCycleBurner",
    "MatmulAppLoad",
    "co_run_config",
]
