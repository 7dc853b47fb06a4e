"""Load schedules — *how the offered load changes over time*.

Every workload the runtime knew before this module was stationary: a
Poisson/CBR/on-off/trace-replay process whose long-run rate never moves.
Metronome's central claim, though, is *adaptive* retrieval — the Eq-10
EWMA load estimate drives the Eq-12 timeout so CPU tracks the offered
load — and a closed loop can only be judged against a load that
actually changes.  A ``LoadSchedule`` is a deterministic, dimensionless
rate multiplier ``scale(t)`` applied on top of any base ``Workload``:

  - ``StepSchedule``      piecewise-constant steps (paper Fig 11's
                          load steps), also the compiled form every
                          other schedule reduces to;
  - ``RampSchedule``      linear ramp discretized into a staircase;
  - ``SinusoidSchedule``  periodic diurnal-style modulation
                          (staircase-sampled, exactly periodic);
  - ``MMPPSchedule``      Markov-modulated segments: exponential dwell
                          times between random scale states, pre-
                          materialized from a private seed so both
                          engines replay the identical sample path;
  - ``from_trace``        a measured (timestamp, rate) series turned
                          into a step schedule.

All schedules are piecewise-constant by construction (``segments``)
which gives every consumer the same view:

  - the event engine (``repro.runtime.sim``) and the threaded
    ``Runtime`` modulate any base workload via *time warping*
    (``ScheduledWorkload`` in workload.py): the base process is run on
    the warped clock ``W(t) = ∫ scale`` — for Poisson this is exactly
    the inhomogeneous-rate process, for CBR/trace it is the natural
    speed-up/slow-down;
  - the batched JAX engine (``repro.runtime.batched``) evaluates
    ``scale(t)`` per ``lax.scan`` slot from the ``(edges, scales)``
    arrays — vmappable, so a ``SweepGrid`` can carry a different
    schedule per point;
  - ``transitions()`` names the times where the offered load changes
    regime — the anchor points ``TrackingStats`` measures convergence
    against.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "LoadSchedule",
    "StepSchedule",
    "RampSchedule",
    "SinusoidSchedule",
    "MMPPSchedule",
    "from_trace",
]


class LoadSchedule:
    """Base: a piecewise-constant, non-negative rate multiplier.

    Subclasses provide ``_materialize(until_us) -> (edges, scales)``
    with ``edges[0] == 0``, edges strictly increasing and covering
    ``[0, until_us]``; everything else (point lookup, integral, warp
    inverse, per-slot sampling) is derived here, identically for every
    schedule kind.
    """

    name = "schedule"

    def _materialize(self, until_us: float):
        raise NotImplementedError

    def _cum(self, until_us: float):
        """Cached ``(edges, scales, cum)`` with ``cum[i]`` = integral up
        to ``edges[i]``.  The warp lookups (``integral`` /
        ``inverse_integral`` / ``scale_at``) sit on the event engine's
        per-event path, so they answer from this cache with a binary
        search instead of re-materializing arrays and re-running a
        cumsum on every call; the cache rebuilds (geometrically grown)
        only when a lookup reaches past the materialized horizon."""
        if (getattr(self, "_cum_cache", None) is not None
                and self._cum_until >= until_us):
            return self._cum_cache
        until = max(float(until_us), 2.0 * getattr(self, "_cum_until", 0.0))
        edges, scales = self._materialize(until)
        edges = np.asarray(edges, dtype=np.float64)
        scales = np.asarray(scales, dtype=np.float64)
        cum = np.concatenate(
            [[0.0], np.cumsum(np.diff(edges) * scales[:-1])])
        object.__setattr__(self, "_cum_cache", (edges, scales, cum))
        object.__setattr__(self, "_cum_until",
                           max(until, float(edges[-1])))
        return self._cum_cache

    # -- point / window lookups -----------------------------------------------
    def scale_at(self, t_us: float) -> float:
        edges, scales, _ = self._cum(max(t_us, 0.0) + 1e-9)
        i = int(np.searchsorted(edges, t_us, side="right")) - 1
        return float(scales[min(max(i, 0), len(scales) - 1)])

    def mean_scale(self, t0_us: float, t1_us: float) -> float:
        if t1_us <= t0_us:
            return self.scale_at(t0_us)
        return (self.integral(t1_us) - self.integral(t0_us)) / (t1_us - t0_us)

    # -- warped clock ----------------------------------------------------------
    def integral(self, t_us: float) -> float:
        """W(t) = ∫_0^t scale(u) du — the warped clock a base workload
        runs on (piecewise linear, exactly invertible)."""
        t_us = max(float(t_us), 0.0)
        edges, scales, cum = self._cum(t_us + 1e-9)
        i = int(np.searchsorted(edges, t_us, side="right")) - 1
        i = min(max(i, 0), len(scales) - 1)
        return float(cum[i] + (t_us - edges[i]) * scales[i])

    def inverse_integral(self, w_us: float, *, hint_until_us: float = 1e6):
        """W^{-1}(w): real time at which the warped clock reads ``w``
        (left edge of any zero-scale plateau)."""
        w_us = max(float(w_us), 0.0)
        until = max(hint_until_us, 1.0)
        for _ in range(64):        # geometric growth, bounded
            edges, scales, cum = self._cum(until)
            total = cum[-1] + max(until - float(edges[-1]), 0.0) \
                * float(scales[-1])
            if total >= w_us or scales[-1] <= 0.0:
                break
            until *= 2.0
        i = int(np.searchsorted(cum, w_us, side="left")) - 1
        i = min(max(i, 0), len(scales) - 1)
        s = float(scales[i])
        if s <= 0.0:
            return float(edges[i])
        return float(edges[i] + (w_us - cum[i]) / s)

    # -- compiled forms --------------------------------------------------------
    def segments(self, duration_us: float) -> tuple[np.ndarray, np.ndarray]:
        """``(edges, scales)`` covering ``[0, duration_us]`` —
        ``scale(t) = scales[searchsorted(edges, t, 'right') - 1]``."""
        edges, scales = self._materialize(duration_us)
        keep = edges < duration_us
        keep[0] = True
        return (np.asarray(edges[keep], dtype=np.float64),
                np.asarray(scales[keep], dtype=np.float64))

    def compiled(self, duration_us: float,
                 max_segments: int = 256) -> tuple[np.ndarray, np.ndarray]:
        """Fixed-width ``(edges, scales)`` of exactly ``max_segments``
        entries (last segment repeated as padding) — the vmappable form
        the batched engine consumes, one row per ``SweepGrid`` point."""
        edges, scales = self.segments(duration_us)
        if edges.size > max_segments:
            # resample on an even grid — schedules denser than the cap
            # are flattened to their window means
            grid = np.linspace(0.0, duration_us, max_segments,
                               endpoint=False)
            vals = [self.mean_scale(t, t + duration_us / max_segments)
                    for t in grid]
            return grid, np.asarray(vals, dtype=np.float64)
        pad = max_segments - edges.size
        return (np.concatenate([edges, np.full(pad, duration_us + 1.0)
                                + np.arange(pad)]),
                np.concatenate([scales, np.full(pad, scales[-1])]))

    def transitions(self, duration_us: float) -> tuple[float, ...]:
        """Times (excluding 0) where the offered load changes regime —
        what ``TrackingStats`` measures convergence against.  Default:
        every interior segment edge with a scale change."""
        edges, scales = self.segments(duration_us)
        out = [float(e) for e, a, b in
               zip(edges[1:], scales[1:], scales[:-1], strict=True)
               if a != b]
        return tuple(out)

    def jump_boundaries(self, duration_us: float) -> np.ndarray:
        """Interior segment edges in ``(0, duration_us)`` — the times an
        event-jump (adaptive macro-slot) kernel must not step across,
        because the arrival rate is only piecewise-constant between
        them.  Used by ``batched_adaptive.estimate_adaptive_steps`` to
        budget the scan length; the kernel itself stops at these edges
        via the compiled ``(edges, scales)`` rows."""
        edges, _ = self.segments(duration_us)
        inner = edges[(edges > 0.0) & (edges < duration_us)]
        return np.asarray(inner, dtype=np.float64)

    def descriptor(self) -> str:
        return self.name

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.descriptor()})"


@dataclass(frozen=True)
class StepSchedule(LoadSchedule):
    """Piecewise-constant steps: ``scales[i]`` on
    ``[times[i], times[i+1])`` with ``times[0] == 0``."""

    times_us: tuple = (0.0,)
    scales: tuple = (1.0,)
    name: str = field(default="step", compare=False)

    def __post_init__(self):
        t = tuple(float(x) for x in self.times_us)
        s = tuple(float(x) for x in self.scales)
        if len(t) != len(s) or not t or t[0] != 0.0:
            raise ValueError("StepSchedule needs times[0]=0 and "
                             "len(times) == len(scales)")
        if any(b <= a for a, b in zip(t, t[1:], strict=False)):
            raise ValueError("StepSchedule times must strictly increase")
        if any(x < 0 for x in s):
            raise ValueError("StepSchedule scales must be >= 0")
        object.__setattr__(self, "times_us", t)
        object.__setattr__(self, "scales", s)

    def _materialize(self, until_us: float):
        return (np.asarray(self.times_us), np.asarray(self.scales))

    def descriptor(self) -> str:
        # '|'-separated: benchmark rows embed descriptors in 'k=v;k=v'
        # derived strings, so ';' (and ',', the CSV delimiter) are out
        parts = "|".join(f"{t:g}:{s:g}" for t, s in
                         zip(self.times_us, self.scales, strict=True))
        return f"step[{parts}]"


@dataclass(frozen=True)
class RampSchedule(LoadSchedule):
    """Linear ramp from ``scale_from`` to ``scale_to`` over
    ``[t_start_us, t_end_us]``, discretized into ``n_steps`` equal
    stairs (flat before and after)."""

    t_start_us: float
    t_end_us: float
    scale_from: float = 1.0
    scale_to: float = 1.0
    n_steps: int = 32
    name: str = field(default="ramp", compare=False)

    def __post_init__(self):
        if self.t_end_us <= self.t_start_us:
            raise ValueError("RampSchedule needs t_end_us > t_start_us")
        if self.n_steps < 1:
            raise ValueError("RampSchedule needs n_steps >= 1")
        if min(self.scale_from, self.scale_to) < 0:
            raise ValueError("RampSchedule scales must be >= 0")

    def _materialize(self, until_us: float):
        ts = [0.0]
        ss = [float(self.scale_from)]
        step = (self.t_end_us - self.t_start_us) / self.n_steps
        for k in range(self.n_steps):
            frac = (k + 0.5) / self.n_steps      # midpoint value per stair
            ts.append(self.t_start_us + k * step)
            ss.append(self.scale_from
                      + frac * (self.scale_to - self.scale_from))
        ts.append(self.t_end_us)
        ss.append(float(self.scale_to))
        return np.asarray(ts), np.asarray(ss)

    def transitions(self, duration_us: float) -> tuple[float, ...]:
        # one regime change begins at ramp start and completes at ramp
        # end — the per-stair micro-edges are not separate transitions
        out = [t for t in (self.t_start_us, self.t_end_us)
               if 0.0 < t < duration_us]
        return tuple(out)

    def descriptor(self) -> str:
        return (f"ramp[{self.t_start_us:g}-{self.t_end_us:g}us|"
                f"{self.scale_from:g}->{self.scale_to:g}]")


@dataclass(frozen=True)
class SinusoidSchedule(LoadSchedule):
    """Periodic modulation ``mean + amplitude*sin(2*pi*t/period)``,
    staircase-sampled at ``steps_per_period`` (clipped at 0)."""

    period_us: float
    amplitude: float = 0.5
    mean: float = 1.0
    steps_per_period: int = 16
    name: str = field(default="sinusoid", compare=False)

    def __post_init__(self):
        if self.period_us <= 0 or self.steps_per_period < 4:
            raise ValueError("SinusoidSchedule needs period_us > 0 and "
                             "steps_per_period >= 4")

    def _materialize(self, until_us: float):
        n_periods = int(np.ceil(max(until_us, 1e-9) / self.period_us))
        step = self.period_us / self.steps_per_period
        k = np.arange(n_periods * self.steps_per_period)
        ts = k * step
        phase = 2.0 * np.pi * (k + 0.5) / self.steps_per_period
        ss = np.maximum(self.mean + self.amplitude * np.sin(phase), 0.0)
        return ts, ss

    def transitions(self, duration_us: float) -> tuple[float, ...]:
        # continuous modulation: no discrete regime changes to converge
        # after (tracking reduces to violation fraction / rho RMSE)
        return ()

    def descriptor(self) -> str:
        return (f"sinusoid[T={self.period_us:g}us|"
                f"{self.mean:g}±{self.amplitude:g}]")


class MMPPSchedule(LoadSchedule):
    """Markov-modulated steps: dwell Exp(``mean_dwell_us``) in a state,
    then jump to a different scale state uniformly.  The sample path is
    materialized from a private ``seed`` (not the run rng), so the event
    engine, the threaded runtime and the batched engine all replay the
    *same* schedule."""

    name = "mmpp"

    def __init__(self, states=(0.3, 1.0, 1.8), *,
                 mean_dwell_us: float = 20_000.0, seed: int = 0):
        states = tuple(float(s) for s in states)
        if len(states) < 2 or any(s < 0 for s in states):
            raise ValueError("MMPPSchedule needs >= 2 non-negative states")
        if mean_dwell_us <= 0:
            raise ValueError("MMPPSchedule needs mean_dwell_us > 0")
        self.states = states
        self.mean_dwell_us = float(mean_dwell_us)
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._edges = [0.0]
        self._scale_idx = [int(self._rng.integers(len(states)))]

    def _materialize(self, until_us: float):
        while self._edges[-1] < until_us:
            self._edges.append(self._edges[-1]
                               + float(self._rng.exponential(
                                   self.mean_dwell_us)))
            nxt = int(self._rng.integers(len(self.states) - 1))
            cur = self._scale_idx[-1]
            self._scale_idx.append(nxt + (nxt >= cur))   # never self-jump
        return (np.asarray(self._edges),
                np.asarray([self.states[i] for i in self._scale_idx]))

    def __eq__(self, other):
        return (isinstance(other, MMPPSchedule)
                and self.states == other.states
                and self.mean_dwell_us == other.mean_dwell_us
                and self.seed == other.seed)

    def __hash__(self):
        return hash((self.states, self.mean_dwell_us, self.seed))

    def descriptor(self) -> str:
        return (f"mmpp[{len(self.states)}states|"
                f"dwell={self.mean_dwell_us:g}us|seed={self.seed}]")


def from_trace(times_us, rates_mpps, *, base_rate_mpps: float) -> StepSchedule:
    """A measured (timestamp, rate) series as a step schedule relative to
    ``base_rate_mpps`` (the stationary rate of the workload it will
    modulate): ``scale(t) = rates[i] / base_rate`` on
    ``[times[i], times[i+1])``."""
    if base_rate_mpps <= 0:
        raise ValueError("from_trace needs base_rate_mpps > 0")
    times = [float(t) for t in times_us]
    if not times:
        raise ValueError("from_trace needs at least one sample")
    if times[0] != 0.0:
        times = [0.0] + times
        rates_mpps = [rates_mpps[0]] + list(rates_mpps)
    sched = StepSchedule(
        times_us=tuple(times),
        scales=tuple(float(r) / base_rate_mpps for r in rates_mpps))
    object.__setattr__(sched, "name", "trace")
    return sched
