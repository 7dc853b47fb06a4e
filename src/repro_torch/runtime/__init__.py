"""repro_torch.runtime — retrieval policies, queues, workloads and the
threaded ``Runtime`` (copied from ``repro.runtime``).

This slice carries what the serving path needs: ``Server`` builds on
``Runtime``, ``BoundedQueue``, the dispatchers and assignments, and the
policies.  The event simulator, the batched sweep engines, calibration,
fleet, schedules and co-run apps come in later slices.
"""

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
from .simcore import (
    DEEP_CSTATE_ENERGY_MODEL,
    DEFAULT_ENERGY_MODEL,
    EnergyModel,
)
from .stats import (
    QueueStats,
    Reservoir,
    RunStats,
    TrackingStats,
    WindowedSeries,
)
from .workload import (
    CBRWorkload,
    OnOffBurstyWorkload,
    PoissonWorkload,
    ScheduledWorkload,
    TraceReplayWorkload,
    Workload,
)

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
    "EnergyModel",
    "DEFAULT_ENERGY_MODEL",
    "DEEP_CSTATE_ENERGY_MODEL",
]
