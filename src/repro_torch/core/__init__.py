"""Metronome core: the paper's host-side contribution (copied from
``repro.core``).

- analytics:  closed-form renewal model (Eqs 1-13)
- controller: EWMA load estimate + adaptive T_S rule (Eqs 10/12)
- hr_sleep:   precise userspace hybrid sleep (paper Sec 3.1 adaptation)
- trylock:    non-blocking queue ownership (paper Sec 3.2)
- simulator:  DEPRECATED shims over repro_torch.runtime.sim (paper Sec 5)

The simulator's old names resolve lazily to the new package, as in the
reference, so ``from repro_torch.core import SimConfig, simulate`` works.
The reference's deprecated ``pollers`` shim is not part of the port.
"""

from . import analytics
from .controller import MetronomeConfig, MetronomeController
from .hr_sleep import calibrate, hr_sleep, make_hr_sleep, measure_precision, naive_sleep
from .trylock import TryLock

# Names re-exported lazily (PEP 562) from the simulator shim.  Lazy so that
# `import repro_torch.runtime` -> policy -> repro_torch.core.controller
# doesn't re-enter a half-initialized repro_torch.runtime.
_SIMULATOR = (
    "HR_SLEEP_MODEL",
    "NANOSLEEP_MODEL",
    "PERFECT_SLEEP_MODEL",
    "SimConfig",
    "SimResult",
    "SleepModel",
    "simulate",
    "simulate_busy_poll",
)

__all__ = [
    "analytics",
    "MetronomeConfig",
    "MetronomeController",
    "calibrate",
    "hr_sleep",
    "make_hr_sleep",
    "measure_precision",
    "naive_sleep",
    "TryLock",
    *_SIMULATOR,
]


def __getattr__(name: str):
    if name in _SIMULATOR:
        from . import simulator
        return getattr(simulator, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
