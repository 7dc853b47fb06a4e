"""Traffic workloads — *what* arrives at the retrieval queue, and when.

A ``Workload`` is consumed two ways, one per execution backend:

  - the discrete-event simulator calls ``counts_in(t0, t1)`` over a
    monotone sweep of windows (aggregate-exact: no per-packet events, so
    a line-rate second costs O(#cycles));
  - the threaded ``Runtime`` / serving server call
    ``iter_arrivals(duration_us, rng)`` and replay each arrival in real
    time against the queue.

``reset(rng)`` re-arms internal state (phase schedules, materialized
trace times) before each run; ``rate_at(t)`` is the rate *envelope* in
packets/us used for diagnostics and saturation checks, not accounting.

Implementations: ``PoissonWorkload`` (optionally time-varying),
``CBRWorkload`` (constant bit rate), ``OnOffBurstyWorkload`` (exponential
on/off phases — bursty edge traffic), and ``TraceReplayWorkload``
(timestamped trace with ``speedup``/``jitter``, the pcap-sender replay
model: each inter-arrival gap is divided by ``speedup`` and multiplied
by a fresh ``1 ± jitter`` factor).

``ScheduledWorkload`` makes any of them *nonstationary*: a
``repro.runtime.schedule.LoadSchedule`` multiplies the base rate over
time via time warping — the base process runs on the warped clock
``W(t) = ∫ scale(u) du``, which for Poisson is exactly the
inhomogeneous-rate process and for CBR/trace replay the natural
speed-up/slow-down.  Both window counting (``counts_in``) and real-time
replay (``iter_arrivals``) are warped, so the event engine, the batched
engine and the threaded runtime all see the same offered-load
trajectory.
"""

from __future__ import annotations

from typing import Iterator, Protocol, Sequence, runtime_checkable

import numpy as np

__all__ = [
    "Workload",
    "PoissonWorkload",
    "CBRWorkload",
    "OnOffBurstyWorkload",
    "TraceReplayWorkload",
    "ScheduledWorkload",
]


@runtime_checkable
class Workload(Protocol):
    name: str

    def reset(self, rng: np.random.Generator) -> None: ...

    def rate_at(self, t_us: float) -> float: ...

    def counts_in(self, t0_us: float, t1_us: float) -> int: ...

    def iter_arrivals(self, duration_us: float,
                      rng: np.random.Generator) -> Iterator[float]: ...


class PoissonWorkload:
    """Memoryless arrivals at ``rate_mpps`` packets/us, optionally
    modulated by ``profile(t_us) -> rate`` (paper Fig 11 ramps)."""

    name = "poisson"

    def __init__(self, rate_mpps: float = 14.88, *, profile=None):
        self.rate_mpps = float(rate_mpps)
        self.profile = profile
        self._rng: np.random.Generator | None = None

    def reset(self, rng: np.random.Generator) -> None:
        self._rng = rng

    def rate_at(self, t_us: float) -> float:
        return float(self.profile(t_us)) if self.profile else self.rate_mpps

    def counts_in(self, t0_us: float, t1_us: float) -> int:
        dt = t1_us - t0_us
        if dt <= 0:
            return 0
        lam = self.rate_at(t0_us)
        return int(self._rng.poisson(lam * dt)) if lam > 0 else 0

    def iter_arrivals(self, duration_us, rng) -> Iterator[float]:
        t = 0.0
        while True:
            lam = self.rate_at(t)
            if lam <= 0:
                t += 1_000.0       # idle probe step while the profile is off
                if t >= duration_us:
                    return
                continue
            t += float(rng.exponential(1.0 / lam))
            if t >= duration_us:
                return
            yield t


class CBRWorkload:
    """Constant bit rate: one arrival every 1/rate us, deterministically."""

    name = "cbr"

    def __init__(self, rate_mpps: float = 14.88):
        self.rate_mpps = float(rate_mpps)

    def reset(self, rng: np.random.Generator) -> None:
        pass

    def rate_at(self, t_us: float) -> float:
        return self.rate_mpps

    def counts_in(self, t0_us: float, t1_us: float) -> int:
        if t1_us <= t0_us:
            return 0
        # stateless and exact over disjoint windows: cumulative counts
        return int(np.floor(t1_us * self.rate_mpps)
                   - np.floor(t0_us * self.rate_mpps))

    def iter_arrivals(self, duration_us, rng) -> Iterator[float]:
        period = 1.0 / self.rate_mpps
        t = period
        while t < duration_us:
            yield t
            t += period


class OnOffBurstyWorkload:
    """Exponential on/off phases: Poisson at ``peak_mpps`` while "on",
    silence while "off" — the bursty edge-traffic scenario a single mean
    rate cannot express (mean rate = peak * duty cycle)."""

    name = "on-off"

    def __init__(self, peak_mpps: float = 14.88, *,
                 on_mean_us: float = 5_000.0, off_mean_us: float = 15_000.0,
                 start_on: bool = True):
        self.peak_mpps = float(peak_mpps)
        self.on_mean_us = float(on_mean_us)
        self.off_mean_us = float(off_mean_us)
        self.start_on = start_on
        self._rng: np.random.Generator | None = None
        self._edges: list[float] = []     # phase boundaries, t=0 first edge
        self._first_on = start_on

    @property
    def duty_cycle(self) -> float:
        return self.on_mean_us / (self.on_mean_us + self.off_mean_us)

    def reset(self, rng: np.random.Generator) -> None:
        self._rng = rng
        self._edges = [0.0]
        self._first_on = self.start_on

    def _extend_schedule(self, until_us: float) -> None:
        while self._edges[-1] < until_us:
            on = self._first_on == (len(self._edges) % 2 == 1)
            mean = self.on_mean_us if on else self.off_mean_us
            self._edges.append(self._edges[-1] + float(self._rng.exponential(mean)))

    def _is_on(self, phase_idx: int) -> bool:
        # phase i spans edges[i]..edges[i+1]; phase 0 is `start_on`
        return self._first_on == (phase_idx % 2 == 0)

    def _on_time(self, t0_us: float, t1_us: float) -> float:
        self._extend_schedule(t1_us)
        edges = self._edges
        i = int(np.searchsorted(edges, t0_us, side="right")) - 1
        on_time = 0.0
        while i < len(edges) - 1 and edges[i] < t1_us:
            lo = max(edges[i], t0_us)
            hi = min(edges[i + 1], t1_us)
            if hi > lo and self._is_on(i):
                on_time += hi - lo
            i += 1
        return on_time

    def rate_at(self, t_us: float) -> float:
        return self.peak_mpps * self.duty_cycle   # envelope (mean) rate

    def counts_in(self, t0_us: float, t1_us: float) -> int:
        on_time = self._on_time(t0_us, t1_us)
        if on_time <= 0:
            return 0
        return int(self._rng.poisson(self.peak_mpps * on_time))

    def iter_arrivals(self, duration_us, rng) -> Iterator[float]:
        t = 0.0
        on = self.start_on
        while t < duration_us:
            span = float(rng.exponential(self.on_mean_us if on
                                         else self.off_mean_us))
            if on:
                u = t
                while True:
                    u += float(rng.exponential(1.0 / self.peak_mpps))
                    if u >= min(t + span, duration_us):
                        break
                    yield u
            t += span
            on = not on


class TraceReplayWorkload:
    """Temporal replay of a timestamped trace (the pcap-sender model).

    Inter-arrival gaps from the trace are divided by ``speedup`` and each
    multiplied by an independent ``1 + U(-jitter, +jitter)`` factor
    (clipped at 0); ``loop=True`` restarts the trace — with fresh jitter
    — until the run's duration is covered.  The trace is normalized to
    its own start: with ``jitter=0`` the replayed arrival times are
    exactly ``(ts - ts[0]) / speedup``.
    """

    name = "trace-replay"

    def __init__(self, timestamps_us: Sequence[float], *,
                 speedup: float = 1.0, jitter: float = 0.0,
                 loop: bool = False):
        ts = np.asarray(sorted(float(t) for t in timestamps_us),
                        dtype=np.float64)
        if ts.size == 0:
            raise ValueError("trace must contain at least one timestamp")
        if speedup <= 0:
            raise ValueError("speedup must be > 0")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        if loop and ts.size > 1 and ts[-1] == ts[0]:
            raise ValueError(
                "loop=True needs a trace with nonzero span: all timestamps "
                "are equal, so each lap would advance time by nothing")
        self.trace_us = ts
        self.speedup = float(speedup)
        self.jitter = float(jitter)
        self.loop = loop
        self._rng: np.random.Generator | None = None
        self._times: np.ndarray = np.empty(0)

    @property
    def base_gaps_us(self) -> np.ndarray:
        """Replayed gaps before jitter: trace deltas / speedup.  The
        first gap is 0 (trace normalized to its own start)."""
        ts = self.trace_us
        return np.diff(ts, prepend=ts[0]) / self.speedup

    def _lap(self) -> np.ndarray:
        """One pass over the trace: jittered, sped-up gaps."""
        gaps = self.base_gaps_us
        if self.jitter:
            factors = 1.0 + self._rng.uniform(-self.jitter, self.jitter,
                                              size=gaps.size)
            gaps = np.maximum(gaps * factors, 0.0)
        return gaps

    def reset(self, rng: np.random.Generator) -> None:
        self._rng = rng
        self._times = np.cumsum(self._lap())

    def _ensure(self, until_us: float) -> None:
        while self.loop and self._times[-1] < until_us:
            start = self._times[-1]
            gaps = self._lap()
            # restart gap: reuse the first gap (or the mean gap for
            # single-packet traces) so laps don't collapse onto one
            # instant; a tiny floor guarantees forward progress even for
            # near-degenerate traces (zero-span ones are rejected upfront)
            gaps[0] = max(gaps[0], float(np.mean(gaps)) if gaps.size > 1
                          else 1.0 / max(self.mean_rate_mpps, 1e-9), 1e-3)
            self._times = np.concatenate([self._times, start + np.cumsum(gaps)])

    @property
    def mean_rate_mpps(self) -> float:
        span = (self.trace_us[-1] - self.trace_us[0]) / self.speedup
        return self.trace_us.size / max(span, 1e-9)

    def rate_at(self, t_us: float) -> float:
        return self.mean_rate_mpps

    def counts_in(self, t0_us: float, t1_us: float) -> int:
        if t1_us <= t0_us:
            return 0
        self._ensure(t1_us)
        t = self._times
        # [t0, t1) windows: an arrival at exactly t=0 lands in the first
        # window of the simulator's monotone sweep
        return int(np.searchsorted(t, t1_us, side="left")
                   - np.searchsorted(t, t0_us, side="left"))

    def iter_arrivals(self, duration_us, rng) -> Iterator[float]:
        self.reset(rng)
        self._ensure(duration_us)
        for t in self._times:
            if t >= duration_us:
                return
            yield float(t)

    def __repr__(self) -> str:
        return (f"TraceReplayWorkload(n={self.trace_us.size}, "
                f"speedup={self.speedup}, jitter={self.jitter}, "
                f"loop={self.loop})")


class ScheduledWorkload:
    """Any base workload modulated by a ``LoadSchedule`` — nonstationary
    traffic through time warping.

    The base process is evaluated on the warped clock ``W(t) =
    ∫_0^t scale(u) du``: window counts on real ``[t0, t1)`` become base
    counts on ``[W(t0), W(t1))`` and replayed arrival times map back
    through ``W^{-1}``.  For a Poisson base this *is* the
    inhomogeneous Poisson process at rate ``lambda * scale(t)``; for
    CBR / trace replay it is the piecewise speed change a sender would
    apply.  The wrapper satisfies the full ``Workload`` protocol, so
    every backend (event engine, threaded runtime, serving replay)
    consumes it unchanged.
    """

    def __init__(self, base: Workload, schedule):
        self.base = base
        self.schedule = schedule
        self.name = (f"{getattr(base, 'name', type(base).__name__)}"
                     f"@{schedule.descriptor()}")

    def reset(self, rng: np.random.Generator) -> None:
        self.base.reset(rng)

    def rate_at(self, t_us: float) -> float:
        return (self.base.rate_at(self.schedule.integral(t_us))
                * self.schedule.scale_at(t_us))

    def counts_in(self, t0_us: float, t1_us: float) -> int:
        if t1_us <= t0_us:
            return 0
        return self.base.counts_in(self.schedule.integral(t0_us),
                                   self.schedule.integral(t1_us))

    def iter_arrivals(self, duration_us, rng) -> Iterator[float]:
        warped_end = self.schedule.integral(duration_us)
        for u in self.base.iter_arrivals(warped_end, rng):
            t = self.schedule.inverse_integral(
                u, hint_until_us=duration_us)
            if t >= duration_us:
                return
            yield float(t)

    def __repr__(self) -> str:
        return f"ScheduledWorkload({self.base!r}, {self.schedule!r})"
