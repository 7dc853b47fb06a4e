"""Metronome core: the paper's host-side contribution (copied from
``repro.core``).

- analytics:  closed-form renewal model (Eqs 1-13)
- controller: EWMA load estimate + adaptive T_S rule (Eqs 10/12)
- hr_sleep:   precise userspace hybrid sleep (paper Sec 3.1 adaptation)
- trylock:    non-blocking queue ownership (paper Sec 3.2)

The reference's deprecated ``pollers``/``simulator`` shims are not part
of the port.
"""

from . import analytics
from .controller import MetronomeConfig, MetronomeController
from .hr_sleep import calibrate, hr_sleep, make_hr_sleep, measure_precision, naive_sleep
from .trylock import TryLock

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
]
