"""Retrieval policies — *when* to wake up and poll the queue.

A ``RetrievalPolicy`` answers one question per wakeup: how long should
this thread sleep before its next poll?  The same policy object runs
unmodified in the discrete-event simulator (``repro.runtime.sim``), the
real-thread ``Runtime``, and the serving server — validate analytically,
simulate, then deploy, without rewriting the control law three times.

Contract:
  - ``threads``          how many pollers this policy deploys (paper M);
  - ``reset()``          re-arm internal state at run start (in place, so
                         held references like ``policy.controller`` stay
                         valid across runs);
  - ``on_wake(ctx)``     -> nanoseconds to sleep before the next poll; 0
                         means "don't sleep at all" (busy polling).  Must
                         be side-effect free: backends may call it to
                         probe the current timeout;
  - ``on_cycle_end(busy_us, vacation_us)``  one renewal-cycle observation
                         (paper Fig 3/4), fed by whichever thread won the
                         lock and finished draining.

Implementations:
  - ``BusyPollPolicy``      classic DPDK Listing-1 spinning baseline;
  - ``MetronomePolicy``     the paper's adaptive sleep&wake (Eq 10/12);
  - ``FixedPeriodPolicy``   constant-period retrieval (interrupt
                            coalescing-style timer, no role split);
  - ``EqualTimeoutsPolicy`` T_L = T_S (paper Fig 5/7 scenarios).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

from repro_torch.core.controller import MetronomeConfig, MetronomeController

__all__ = [
    "WakeContext",
    "RetrievalPolicy",
    "BusyPollPolicy",
    "MetronomePolicy",
    "FixedPeriodPolicy",
    "EqualTimeoutsPolicy",
]


@dataclass(frozen=True)
class WakeContext:
    """What a poller knows when it decides its next sleep."""

    primary: bool = True        # did this wake win the queue lock?
    items: int = 0              # items retrieved during the busy period
    backlog: int = 0            # queue depth left behind (usually 0)
    now_ns: int = 0             # ns since run start (same clock on every backend)


@runtime_checkable
class RetrievalPolicy(Protocol):
    name: str

    @property
    def threads(self) -> int: ...

    def reset(self) -> None: ...

    def on_wake(self, ctx: WakeContext) -> int: ...

    def on_cycle_end(self, busy_us: float, vacation_us: float) -> None: ...


class BusyPollPolicy:
    """Paper Listing 1: one dedicated thread, never sleeps.

    ``spin = True`` tells backends to use their spinning fast path (the
    simulator switches to an analytic fluid model; the threaded runtime
    pins CPU accounting at a full core, the baseline's defining cost).
    """

    name = "busy-poll"
    spin = True

    def __init__(self, threads: int = 1):
        self._threads = threads

    @property
    def threads(self) -> int:
        return self._threads

    def reset(self) -> None:
        pass

    def on_wake(self, ctx: WakeContext) -> int:
        return 0

    def on_cycle_end(self, busy_us: float, vacation_us: float) -> None:
        pass


class MetronomePolicy:
    """The paper's adaptive sleep&wake retrieval (Listing 2 + Eq 10/12).

    Wraps one shared ``MetronomeController``: primaries sleep the adaptive
    T_S, backups sleep T_L.  ``adaptive=False`` freezes T_S at the
    vacation target (the paper's static-configuration ablations).
    ``operating_table`` installs a calibrated feed-forward term (an
    ``repro.runtime.calibrate.OperatingTable`` or anything with
    ``timeouts_us(rho)``): the Eq 10 EWMA keeps estimating rho, and the
    table maps that estimate to a pre-validated (T_S, T_L) operating
    point, blended with Eq 12 by ``cfg.feedforward_weight``.
    """

    name = "metronome"
    spin = False

    def __init__(self, cfg: MetronomeConfig | None = None, *,
                 adaptive: bool = True, operating_table=None):
        self.cfg = cfg or MetronomeConfig()
        self.adaptive = adaptive
        self.controller = MetronomeController(self.cfg,
                                              feedforward=operating_table)
        self.reset()

    @property
    def threads(self) -> int:
        return self.cfg.m

    @property
    def rho(self) -> float:
        return self.controller.rho

    @property
    def t_short_us(self) -> float:
        return self.controller.t_short_us

    @property
    def trajectory(self) -> list:
        """The controller's recorded (cycle, rho, T_S, T_L) trace —
        empty unless ``cfg.record_trajectory`` is on."""
        return self.controller.trajectory

    def reset(self) -> None:
        # re-arm in place: callers hold references to self.controller
        self.controller.__post_init__()
        if not self.adaptive:
            self.controller.t_short_us = self.cfg.v_target_us

    def on_wake(self, ctx: WakeContext) -> int:
        return self.controller.timeout_ns(primary=ctx.primary)

    def on_cycle_end(self, busy_us: float, vacation_us: float) -> None:
        if self.adaptive:
            self.controller.on_cycle_end(busy_us, vacation_us)

    def __repr__(self) -> str:
        return (f"MetronomePolicy(m={self.cfg.m}, "
                f"v_target_us={self.cfg.v_target_us}, "
                f"t_long_us={self.cfg.t_long_us}, adaptive={self.adaptive})")


class FixedPeriodPolicy:
    """Constant-period retrieval: every thread sleeps ``period_us`` no
    matter what happened — the timer-driven middle ground between busy
    polling and Metronome (think NIC interrupt coalescing)."""

    name = "fixed-period"
    spin = False

    def __init__(self, period_us: float = 50.0, threads: int = 1):
        self.period_us = float(period_us)
        self._threads = threads

    @property
    def threads(self) -> int:
        return self._threads

    def reset(self) -> None:
        pass

    def on_wake(self, ctx: WakeContext) -> int:
        return int(self.period_us * 1_000)

    def on_cycle_end(self, busy_us: float, vacation_us: float) -> None:
        pass

    def __repr__(self) -> str:
        return f"FixedPeriodPolicy({self.period_us}us x{self._threads})"


class EqualTimeoutsPolicy(MetronomePolicy):
    """T_L := T_S — no backup role (paper Fig 5/7).

    Every wake sleeps the primary timeout, so all M threads keep probing
    at the short cadence; the paper uses this to expose the busy-try
    cost that the long backup timeout exists to avoid.
    """

    name = "equal-timeouts"

    def __init__(self, cfg: MetronomeConfig | None = None, *,
                 adaptive: bool = False):
        super().__init__(cfg, adaptive=adaptive)

    def on_wake(self, ctx: WakeContext) -> int:
        return self.controller.timeout_ns(primary=True)
