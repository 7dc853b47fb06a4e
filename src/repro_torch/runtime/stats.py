"""Unified run statistics for every execution backend.

One ``RunStats`` dataclass is produced by the discrete-event simulator,
the threaded ``Runtime``, and the serving server, so policies and
workloads can be compared apples-to-apples across backends (and the old
``PollerStats``/``ServerStats``/``SimResult`` views become thin aliases
or conversions of this).

``Reservoir`` is a bounded uniform sample: long-running servers record
latency forever without unbounded memory growth (each of the first
``capacity`` values is kept; afterwards value *n* replaces a random slot
with probability capacity/n — the classic Algorithm R invariant, every
value seen has equal probability of being in the sample).
"""

from __future__ import annotations

import copy
import random
import warnings
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Reservoir", "QueueStats", "RunStats", "WindowedSeries",
           "TrackingStats", "hedged_latency_quantile"]


class Reservoir:
    """Bounded uniform reservoir sample of a float stream (Algorithm R).

    Quacks enough like a list (len/iter/bool/__array__/extend/append)
    that existing consumers — ``np.median(stats.latency_samples_us)``,
    truthiness guards — keep working unchanged.
    """

    __slots__ = ("capacity", "count", "_buf", "_rng", "_np_rng")

    def __init__(self, capacity: int = 65_536, seed: int = 0):
        if capacity < 1:
            raise ValueError("Reservoir capacity must be >= 1")
        self.capacity = capacity
        self.count = 0              # total values ever offered
        self._buf: list[float] = []
        self._rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)

    def append(self, value: float) -> None:
        self.count += 1
        if len(self._buf) < self.capacity:
            self._buf.append(float(value))
            return
        j = self._rng.randrange(self.count)
        if j < self.capacity:
            self._buf[j] = float(value)

    def extend(self, values) -> None:
        if not isinstance(values, (list, tuple, np.ndarray)):
            for v in values:            # generators: no length to batch on
                self.append(v)
            return
        arr = np.asarray(values, dtype=np.float64).ravel()
        if arr.size == 0:
            return
        free = self.capacity - len(self._buf)
        if free > 0:                    # fill phase, no randomness needed
            take = min(free, arr.size)
            self._buf.extend(arr[:take].tolist())
            self.count += take
            arr = arr[take:]
        if arr.size == 0:
            return
        # bulk Algorithm R: value #k replaces a random slot iff
        # randrange(k) < capacity — one vectorized draw for the batch
        ks = np.arange(self.count + 1, self.count + arr.size + 1)
        self.count += arr.size
        js = (self._np_rng.random(arr.size) * ks).astype(np.int64)
        hit = js < self.capacity
        for j, v in zip(js[hit].tolist(), arr[hit].tolist(), strict=True):
            self._buf[j] = v            # in order: later values win ties

    def merge(self, other: "Reservoir") -> "Reservoir":
        """Weighted Algorithm-R union: after merging, the sample behaves
        as if the two underlying streams had been fed into one reservoir
        of ``self.capacity`` — each of the ``self.count + other.count``
        values seen by either side is (approximately) equally likely to
        be in the merged buffer.  In place; returns ``self``.

        While both sides are still lossless (nothing evicted yet) the
        union is an exact concatenation.  Otherwise the merged buffer
        draws each slot from ``self`` with probability proportional to
        ``self.count`` (binomial split, sampled without replacement
        within each side) — the standard reservoir-union construction
        used to combine per-shard samples.
        """
        if other.count == 0:
            return self
        total = self.count + other.count
        lossless = (self.count == len(self._buf)
                    and other.count == len(other._buf))
        if lossless and total <= self.capacity:
            self._buf.extend(other._buf)
            self.count = total
            return self
        k = min(self.capacity, len(self._buf) + len(other._buf))
        n_self = int(self._np_rng.binomial(k, self.count / total))
        n_self = min(n_self, len(self._buf))
        n_other = min(k - n_self, len(other._buf))
        n_self = min(k - n_other, len(self._buf))   # top up if other clipped
        pick_s = self._np_rng.choice(len(self._buf), size=n_self,
                                     replace=False)
        pick_o = self._np_rng.choice(len(other._buf), size=n_other,
                                     replace=False)
        self._buf = ([self._buf[i] for i in pick_s]
                     + [float(other._buf[i]) for i in pick_o])
        self.count = total
        return self

    def merge_all(self, others) -> "Reservoir":
        """n-way weighted union in ONE buffer rebuild.

        Distributionally equivalent to left-folding pairwise ``merge``
        over ``others`` — every value seen by any side ends up in the
        merged sample with (approximately) equal probability — but a
        1000-shard rollup does a single multinomial slot allocation and
        one sampling pass instead of O(n) full buffer re-copies.  In
        place; returns ``self``.

        Slots are allocated across sides by a multinomial draw
        proportional to each side's stream count, clipped to what each
        buffer actually holds, with the clipped excess handed to sides
        that still have unsampled values (largest-room first).
        """
        parts = [o for o in others if o.count > 0]
        if not parts:
            return self
        counts = np.asarray([self.count] + [o.count for o in parts],
                            dtype=np.float64)
        bufs = [self._buf] + [o._buf for o in parts]
        lens = np.asarray([len(b) for b in bufs], dtype=np.int64)
        total = int(counts.sum())
        if total <= self.capacity and int(counts.sum()) == int(lens.sum()):
            # every side still lossless and the union fits: exact concat
            merged: list[float] = list(self._buf)
            for b in bufs[1:]:
                merged.extend(float(v) for v in b)
            self._buf = merged
            self.count = total
            return self
        k = min(self.capacity, int(lens.sum()))
        alloc = self._np_rng.multinomial(k, counts / counts.sum())
        for _ in range(len(bufs)):
            excess = int(np.maximum(alloc - lens, 0).sum())
            if excess == 0:
                break
            alloc = np.minimum(alloc, lens)
            room = lens - alloc
            for i in np.argsort(-room):
                give = min(excess, int(room[i]))
                alloc[i] += give
                excess -= give
                if excess == 0:
                    break
        buf: list[float] = []
        for n_i, b in zip(alloc.tolist(), bufs, strict=True):
            if n_i == 0:
                continue
            if n_i >= len(b):
                buf.extend(float(v) for v in b)
            else:
                pick = self._np_rng.choice(len(b), size=n_i, replace=False)
                buf.extend(float(b[j]) for j in pick)
        self._buf = buf
        self.count = total
        return self

    def __len__(self) -> int:
        return len(self._buf)

    def __bool__(self) -> bool:
        return bool(self._buf)

    def __iter__(self):
        return iter(self._buf)

    def __getitem__(self, i):
        return self._buf[i]

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._buf, dtype=dtype or np.float64)

    def __repr__(self) -> str:
        return (f"Reservoir(n={len(self._buf)}/{self.capacity}, "
                f"seen={self.count})")


def _empty() -> np.ndarray:
    return np.empty(0)


@dataclass
class WindowedSeries:
    """Per-window accumulators of one run, shared by every backend.

    Raw sums are stored (never derived values), so the derived metrics —
    per-window mean latency via Little's law, CPU fraction, offered /
    served rates, estimated vs true rho — are computed by *one* code
    path regardless of which engine filled the accumulators, and two
    equal-grid series merge by plain addition.  All arrays have one
    entry per window of ``window_us``.

      - ``offered`` / ``served``  packets entering / leaving per window;
      - ``lat_area_us``  queue-depth integral accrued in the window
        (packet*us) — ``mean_latency_us`` is its Little's-law ratio;
      - ``awake_us``  poller CPU charged in the window;
      - ``energy_uj``  EnergyModel charge accrued in the window
        (active + sleep-arm + transition components);
      - ``rho_sum`` / ``rho_cnt``  controller load-estimate samples
        (one per primary wake; zero count = no estimator, e.g. the
        batched engine's static points or busy polling);
      - ``ts_sum``  the controller's T_S at those samples;
      - ``p99_latency_us``  per-window sampled p99 (NaN where the
        backend keeps no samples, e.g. the batched engine);
      - ``spill_*``  scalar contributions at event times past the run
        duration (the event engine's final-drain pass; always 0 from
        the batched engines, whose scan stops at duration).  Window
        sums plus spill equal the run totals — the conservation law.
    """

    window_us: float
    service_rate_mpps: float
    offered: np.ndarray
    served: np.ndarray
    lat_area_us: np.ndarray
    awake_us: np.ndarray
    energy_uj: np.ndarray = field(default_factory=_empty)
    rho_sum: np.ndarray = field(default_factory=_empty)
    rho_cnt: np.ndarray = field(default_factory=_empty)
    ts_sum: np.ndarray = field(default_factory=_empty)
    p99_latency_us: np.ndarray = field(default_factory=_empty)
    spill_offered: float = 0.0
    spill_served: float = 0.0
    spill_lat_area_us: float = 0.0
    spill_awake_us: float = 0.0
    spill_energy_uj: float = 0.0

    def __post_init__(self):
        n = len(self.offered)
        for f in ("energy_uj", "rho_sum", "rho_cnt", "ts_sum"):
            if getattr(self, f).size == 0:
                setattr(self, f, np.zeros(n))
        if self.p99_latency_us.size == 0:
            self.p99_latency_us = np.full(n, np.nan)

    # -- derived ---------------------------------------------------------------
    @property
    def n_windows(self) -> int:
        return len(self.offered)

    @property
    def t_us(self) -> np.ndarray:
        """Window start times."""
        return np.arange(self.n_windows) * self.window_us

    @property
    def mean_latency_us(self) -> np.ndarray:
        """Little's-law mean sojourn per window (NaN where nothing was
        served — no departures means no latency observation)."""
        out = np.full(self.n_windows, np.nan)
        m = self.served > 0
        out[m] = self.lat_area_us[m] / self.served[m]
        return out

    @property
    def cpu_fraction(self) -> np.ndarray:
        return self.awake_us / max(self.window_us, 1e-9)

    @property
    def power_w(self) -> np.ndarray:
        """Mean package power per window (uJ over us is W)."""
        return self.energy_uj / max(self.window_us, 1e-9)

    @property
    def offered_mpps(self) -> np.ndarray:
        return self.offered / max(self.window_us, 1e-9)

    @property
    def tput_mpps(self) -> np.ndarray:
        return self.served / max(self.window_us, 1e-9)

    @property
    def rho_true(self) -> np.ndarray:
        """Actual offered load per window (what Eq 10 is estimating)."""
        return self.offered_mpps / max(self.service_rate_mpps, 1e-9)

    @property
    def rho_est(self) -> np.ndarray:
        """Controller EWMA estimate per window (NaN without samples)."""
        out = np.full(self.n_windows, np.nan)
        m = self.rho_cnt > 0
        out[m] = self.rho_sum[m] / self.rho_cnt[m]
        return out

    @property
    def ts_us(self) -> np.ndarray:
        out = np.full(self.n_windows, np.nan)
        m = self.rho_cnt > 0
        out[m] = self.ts_sum[m] / self.rho_cnt[m]
        return out

    def merge(self, other: "WindowedSeries") -> "WindowedSeries":
        """Sum accumulators of two equal-grid shards (raises on
        mismatched window grids — derived ratios then re-derive from the
        pooled sums).  Sampled p99 combines conservatively (max)."""
        if (self.window_us != other.window_us
                or self.n_windows != other.n_windows):
            raise ValueError("cannot merge WindowedSeries on different "
                             "window grids")
        for f in ("offered", "served", "lat_area_us", "awake_us",
                  "energy_uj", "rho_sum", "rho_cnt", "ts_sum",
                  "spill_offered", "spill_served", "spill_lat_area_us",
                  "spill_awake_us", "spill_energy_uj"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            self.p99_latency_us = np.fmax(self.p99_latency_us,
                                          other.p99_latency_us)
        return self

    def tracking(self, transitions_us, target_latency_us: float, *,
                 settle_rel: float = 0.25, settle_abs_us: float = 2.0,
                 hold_windows: int = 3) -> "TrackingStats":
        """Adaptation quality against this series — ONE implementation
        for every backend (the acceptance criterion of the
        nonstationary-traffic tier).

        The run is cut into regimes at ``transitions_us`` (the
        schedule's load-change times).  Per regime the *settled* latency
        is the median of the regime's last third of windows; the
        convergence time after a transition is how long the windowed
        mean latency takes to enter the settle band
        ``max(settle_abs_us, settle_rel * settled)`` around that value
        and hold it for ``hold_windows`` consecutive windows (sustained
        entry, so one noisy window deep in an otherwise-settled regime
        does not push convergence to the end of the run).  Overshoot is
        the worst windowed excursion above the settled value; the
        violation fraction counts windows whose mean latency exceeds
        ``target_latency_us`` among the windows that actually served
        traffic; ``rho_rmse`` is the tracking error of the controller's
        load estimate against the true offered load (NaN without an
        estimator).
        """
        lat = self.mean_latency_us
        t = self.t_us
        n = self.n_windows
        bounds = [0.0] + sorted(float(x) for x in transitions_us
                                if 0.0 < x < n * self.window_us)
        bounds_idx = [int(np.searchsorted(t, b, side="left"))
                      for b in bounds] + [n]

        conv, overshoot = [], 0.0
        for k in range(len(bounds)):
            lo, hi = bounds_idx[k], bounds_idx[k + 1]
            if hi <= lo:
                if k > 0:
                    conv.append(float("nan"))
                continue
            seg = lat[lo:hi]
            valid = seg[np.isfinite(seg)]
            if valid.size == 0:
                if k > 0:
                    conv.append(float("nan"))
                continue
            tail = valid[-max(valid.size // 3, 1):]
            settled = float(np.median(tail))
            band = max(settle_abs_us, settle_rel * settled)
            overshoot = max(overshoot, float(np.nanmax(seg)) - settled)
            if k > 0:          # convergence is measured after a transition
                inside = ~(np.abs(seg - settled) > band)   # NaN => inside
                # first window from which the metric holds the band for
                # `hold_windows` consecutive windows (clipped to the
                # regime length for short regimes)
                kk = min(max(int(hold_windows), 1), inside.size)
                streak = (np.convolve(inside.astype(np.int64),
                                      np.ones(kk, np.int64),
                                      mode="valid") == kk)
                idx = int(np.argmax(streak)) if streak.any() else -1
                conv.append(float(t[lo + idx] + self.window_us
                                  - bounds[k]) if idx >= 0
                            else float("nan"))

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            # violations are judged over windows that actually served
            # traffic: NaN (nothing-served) windows would otherwise pad
            # the denominator and understate violations under schedules
            # with idle phases
            fin = lat[np.isfinite(lat)]
            violation = (float(np.mean(fin > target_latency_us))
                         if fin.size else 0.0)
            err = self.rho_est - self.rho_true
            err = err[np.isfinite(err)]
            rho_rmse = (float(np.sqrt(np.mean(err ** 2)))
                        if err.size else float("nan"))
        conv_t = tuple(conv)
        finite = [c for c in conv_t if np.isfinite(c)]
        return TrackingStats(
            window_us=self.window_us,
            target_latency_us=float(target_latency_us),
            transitions_us=tuple(bounds[1:]),
            convergence_us=conv_t,
            mean_convergence_us=(float(np.mean(finite)) if finite
                                 else float("nan")),
            max_overshoot_us=float(overshoot),
            violation_fraction=violation,
            rho_rmse=rho_rmse,
        )


@dataclass(frozen=True)
class TrackingStats:
    """How well the closed loop tracked a nonstationary offered load.

    Produced by ``WindowedSeries.tracking`` — the identical computation
    on every backend — and consumed by ``benchmarks/adaptation.py``'s
    verdict rows (feed-forward vs pure-Eq-12 convergence, busy-poll's
    flat CPU)."""

    window_us: float
    target_latency_us: float
    transitions_us: tuple        # load-change times the run was cut at
    convergence_us: tuple        # per transition; NaN = never settled
    mean_convergence_us: float
    max_overshoot_us: float      # worst windowed excursion above settled
    violation_fraction: float    # windows with mean latency > target
    rho_rmse: float              # EWMA rho vs true rho (NaN: no estimator)

    def summary(self) -> dict:
        return {
            "window_us": self.window_us,
            "target_latency_us": self.target_latency_us,
            "n_transitions": len(self.transitions_us),
            "mean_convergence_us": self.mean_convergence_us,
            "max_overshoot_us": self.max_overshoot_us,
            "violation_fraction": self.violation_fraction,
            "rho_rmse": self.rho_rmse,
        }


@dataclass
class QueueStats:
    """Per-Rx-queue slice of a run's counters.  Every field sums to the
    matching ``RunStats`` total across ``RunStats.per_queue`` (the
    conservation law the multi-queue refactor is tested against)."""

    queue: int
    offered: int = 0
    dropped: int = 0
    serviced: int = 0
    busy_tries: int = 0
    cycles: int = 0
    # per-queue retrieval-latency sample (populated by the event
    # simulator; None where the backend doesn't break latency down)
    latency_us: Reservoir | None = None

    @property
    def loss_fraction(self) -> float:
        return self.dropped / max(self.offered, 1)

    def merge(self, other: "QueueStats") -> "QueueStats":
        """Combine with the same queue's slice from a parallel shard."""
        self.offered += other.offered
        self.dropped += other.dropped
        self.serviced += other.serviced
        self.busy_tries += other.busy_tries
        self.cycles += other.cycles
        if self.latency_us is not None and other.latency_us is not None:
            self.latency_us.merge(other.latency_us)
        return self

    def merge_all(self, others) -> "QueueStats":
        """n-way ``merge``: counters sum once, the latency reservoir does
        one weighted union (``Reservoir.merge_all``).  In place."""
        others = list(others)
        if not others:
            return self
        for f in ("offered", "dropped", "serviced", "busy_tries", "cycles"):
            setattr(self, f,
                    getattr(self, f) + sum(getattr(o, f) for o in others))
        if self.latency_us is not None:
            self.latency_us.merge_all(
                o.latency_us for o in others if o.latency_us is not None)
        return self


@dataclass
class RunStats:
    """One result type for sim / threads / server runs.

    Time bookkeeping is in nanoseconds (``awake_ns`` over
    ``stopped_ns - started_ns``) so the real-thread backends can feed
    ``time.thread_time_ns`` straight in; the simulator converts its
    microsecond clock once at the end.  Cycle-level arrays
    (vacations/busies/backlogs, adaptation time series) are only
    populated by the simulator — real threads would pay too much for
    them on the hot path.
    """

    backend: str = ""                 # "sim" | "threads" | "server"
    policy: str = ""
    workload: str = ""
    # nonstationary runs: the LoadSchedule descriptor that modulated the
    # workload ("" = stationary) — keeps benchmark/JSON rows
    # self-describing without reaching back to the config object
    schedule: str = ""

    wakeups: int = 0
    cycles: int = 0                   # busy periods won (lock taken)
    busy_tries: int = 0               # failed trylocks (backup wakes)
    items: int = 0                    # packets / requests serviced
    offered: int = 0
    dropped: int = 0

    awake_ns: int = 0
    started_ns: int = 0
    stopped_ns: int = 0

    # co-run application load (repro.runtime.apps): work quanta the
    # competing app completed during the run and the CPU it burned —
    # kept separate from awake_ns, which is the I/O task's CPU alone
    app_ops: int = 0
    app_cpu_ns: int = 0

    latency_us: Reservoir = field(default_factory=Reservoir)
    # analytic backends (the busy-poll fluid model) report closed-form
    # latency summaries instead of samples
    latency_override: dict | None = None
    # exact queue-depth integral (packet*us): simulation engines set this
    # so Little's law recovers the true all-packet mean sojourn —
    # ``mean_latency_us`` from samples is the *vacation-found-packet*
    # estimator (per-cycle weighted), which reads systematically higher
    # by roughly (1+rho) at load; use ``mean_sojourn_us`` to compare
    # engines or backends on the same quantity
    latency_area_us: float = 0.0
    # EnergyModel charge of the run (active + sleep-arm + transition
    # components, see SimRunConfig.energy_model).  Simulation engines
    # account it exactly; the threaded Runtime/Server backends fill a
    # model-based estimate from their wake/awake counters.
    energy_uj: float = 0.0
    # real-time replay only: worst lateness of the arrival generator vs
    # the workload's schedule.  >> mean inter-arrival gap means the host
    # could not source the workload and the run is NOT sim-comparable.
    feeder_lag_us: float = 0.0

    # multi-queue ingress: one entry per Rx queue (empty when the backend
    # does not break its counters down, e.g. the spin fluid model)
    per_queue: list[QueueStats] = field(default_factory=list)
    # simulator: busy periods cut short by the drain round cap, stranding
    # backlog until the next wake — nonzero means saturated cycles whose
    # service was deferred, and summary() warns about it
    drain_truncations: int = 0

    # windowed adaptation series (cfg.window_us > 0): filled by BOTH
    # simulation engines with the same accumulator convention, so
    # WindowedSeries/TrackingStats are one code path across backends
    windows: WindowedSeries | None = None

    # simulator-only cycle samples and adaptation series
    vacations_us: np.ndarray = field(default_factory=_empty)
    busies_us: np.ndarray = field(default_factory=_empty)
    n_v: np.ndarray = field(default_factory=_empty)
    rho_series: np.ndarray = field(default_factory=_empty)
    ts_series: np.ndarray = field(default_factory=_empty)
    tput_series_mpps: np.ndarray = field(default_factory=_empty)
    offered_series_mpps: np.ndarray = field(default_factory=_empty)
    series_t_us: np.ndarray = field(default_factory=_empty)

    # -- derived ---------------------------------------------------------------
    @property
    def duration_ns(self) -> int:
        return max(self.stopped_ns - self.started_ns, 1)

    @property
    def cpu_fraction(self) -> float:
        """Sum of thread awake time over wall duration (can exceed 1.0)."""
        return self.awake_ns / self.duration_ns

    @property
    def loss_fraction(self) -> float:
        return self.dropped / max(self.offered, 1)

    @property
    def app_cpu_fraction(self) -> float:
        """Cores the co-run application load actually got (0 when none
        was installed)."""
        return self.app_cpu_ns / self.duration_ns

    @property
    def energy_per_packet_nj(self) -> float:
        """Package energy per serviced packet (nJ) — the per-packet
        cost metric the power-proportionality claims are judged on."""
        return 1e3 * self.energy_uj / max(self.items, 1)

    @property
    def mean_power_w(self) -> float:
        """Mean package power over the wall window (uJ / us = W)."""
        return self.energy_uj / (self.duration_ns / 1e3)

    @property
    def serviced(self) -> int:
        return self.items

    # legacy PollerStats / ServerStats spellings
    @property
    def busy_periods(self) -> int:
        return self.cycles

    @property
    def latency_samples_us(self) -> Reservoir:
        return self.latency_us

    @property
    def retrieval_lat_us(self) -> Reservoir:
        return self.latency_us

    # latency summaries (empty-safe, like the old SimResult defaults)
    @property
    def mean_latency_us(self) -> float:
        if self.latency_override:
            return self.latency_override["mean"]
        return float(np.mean(self.latency_us)) if self.latency_us else 0.0

    @property
    def p99_latency_us(self) -> float:
        if self.latency_override:
            return self.latency_override["p99"]
        return (float(np.percentile(np.asarray(self.latency_us), 99))
                if self.latency_us else 0.0)

    @property
    def worst_latency_us(self) -> float:
        if self.latency_override:
            return self.latency_override["worst"]
        return float(np.max(np.asarray(self.latency_us))) if self.latency_us else 0.0

    @property
    def mean_sojourn_us(self) -> float:
        """All-packet mean time in system via Little's law (area under
        the queue-depth curve over packets served); falls back to the
        sampled mean where the backend keeps no depth integral."""
        if self.latency_area_us > 0.0:
            return self.latency_area_us / max(self.items, 1)
        return self.mean_latency_us

    @property
    def mean_vacation_us(self) -> float:
        return float(np.mean(self.vacations_us)) if self.vacations_us.size else 0.0

    @property
    def mean_busy_us(self) -> float:
        return float(np.mean(self.busies_us)) if self.busies_us.size else 0.0

    @property
    def mean_nv(self) -> float:
        return float(np.mean(self.n_v)) if self.n_v.size else 0.0

    def merge(self, other: "RunStats") -> "RunStats":
        """Combine two runs that shard one logical experiment — parallel
        queue shards, seed replicas of the same simulated window, or
        per-worker slices of a batched sweep.  Counters add, latency
        reservoirs take their weighted Algorithm-R union, per-queue
        slices merge by queue index, and the wall window becomes the
        union ``[min(started), max(stopped)]`` (so ``cpu_fraction`` of
        equal-window shards is the summed awake time over that one
        window, i.e. total cores burned).  In place; returns ``self``.

        Cycle-sample arrays concatenate; binned time series merge only
        when both sides share the same bin grid (rates add, rho/T_S
        average) and are dropped otherwise.
        """
        for f in ("wakeups", "cycles", "busy_tries", "items", "offered",
                  "dropped", "awake_ns", "app_ops", "app_cpu_ns",
                  "drain_truncations", "latency_area_us", "energy_uj"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.started_ns = min(self.started_ns, other.started_ns)
        self.stopped_ns = max(self.stopped_ns, other.stopped_ns)
        for f in ("backend", "policy", "workload", "schedule"):
            if getattr(self, f) != getattr(other, f):
                setattr(self, f, "mixed")
        # latency: sample-based sides merge reservoirs; analytic
        # overrides combine as an items-weighted mean (p99/worst upper
        # bounds) since there are no samples to re-pool.
        if self.latency_override or other.latency_override:
            mine = self.latency_override or {
                "mean": self.mean_latency_us, "p99": self.p99_latency_us,
                "worst": self.worst_latency_us}
            theirs = other.latency_override or {
                "mean": other.mean_latency_us, "p99": other.p99_latency_us,
                "worst": other.worst_latency_us}
            # items was already summed above; recover the pre-merge split
            w_a, w_b = self.items - other.items, other.items
            tot = max(w_a + w_b, 1)
            self.latency_override = {
                "mean": (mine["mean"] * w_a + theirs["mean"] * w_b) / tot,
                "p99": max(mine["p99"], theirs["p99"]),
                "worst": max(mine["worst"], theirs["worst"]),
            }
        else:
            self.latency_us.merge(other.latency_us)
        self.feeder_lag_us = max(self.feeder_lag_us, other.feeder_lag_us)
        # adopt copies of the donor's per-queue slices — aliasing them
        # would let a later merge mutate `other` retroactively
        if self.per_queue and other.per_queue:
            by_q = {q.queue: q for q in self.per_queue}
            for oq in other.per_queue:
                if oq.queue in by_q:
                    by_q[oq.queue].merge(oq)
                else:
                    self.per_queue.append(copy.deepcopy(oq))
            self.per_queue.sort(key=lambda q: q.queue)
        elif other.per_queue:
            self.per_queue = copy.deepcopy(other.per_queue)
        # windowed series: pool accumulators on matching grids, drop on
        # mismatch (the same convention the binned series follow below)
        if self.windows is not None and other.windows is not None:
            try:
                self.windows.merge(other.windows)
            except ValueError:
                self.windows = None
        elif other.windows is not None:
            self.windows = copy.deepcopy(other.windows)
        for f in ("vacations_us", "busies_us", "n_v"):
            setattr(self, f, np.concatenate([getattr(self, f),
                                             getattr(other, f)]))
        same_grid = (self.series_t_us.size
                     and self.series_t_us.shape == other.series_t_us.shape
                     and np.array_equal(self.series_t_us, other.series_t_us))
        if same_grid:
            for f in ("tput_series_mpps", "offered_series_mpps"):
                setattr(self, f, getattr(self, f) + getattr(other, f))
            for f in ("rho_series", "ts_series"):
                setattr(self, f, (getattr(self, f) + getattr(other, f)) / 2)
        else:
            for f in ("rho_series", "ts_series", "tput_series_mpps",
                      "offered_series_mpps", "series_t_us"):
                setattr(self, f, _empty())
        return self

    def merge_all(self, others) -> "RunStats":
        """n-way ``merge`` for cluster rollups: one pass over all shards
        instead of a left-fold of pairwise merges.  Counters and window
        accumulators sum once, each latency reservoir family does one
        weighted union, and cycle-sample arrays concatenate in a single
        allocation — a 1000-host fleet rollup is O(total data), not
        O(n) re-copies of an ever-growing buffer.  In place.

        Semantics match folding ``merge`` exactly for all counters and
        reservoirs; the only deliberate difference is the binned
        rho/T_S series, which take an unweighted mean over all shards
        (the fold's nested pairwise average weights early shards less).
        """
        others = list(others)
        if not others:
            return self
        # capture pre-merge items for the analytic-override weighting
        items_w = [self.items] + [o.items for o in others]
        for f in ("wakeups", "cycles", "busy_tries", "items", "offered",
                  "dropped", "awake_ns", "app_ops", "app_cpu_ns",
                  "drain_truncations", "latency_area_us", "energy_uj"):
            setattr(self, f,
                    getattr(self, f) + sum(getattr(o, f) for o in others))
        self.started_ns = min(self.started_ns,
                              *(o.started_ns for o in others))
        self.stopped_ns = max(self.stopped_ns,
                              *(o.stopped_ns for o in others))
        for f in ("backend", "policy", "workload", "schedule"):
            vals = {getattr(self, f)} | {getattr(o, f) for o in others}
            if len(vals) > 1:
                setattr(self, f, "mixed")
        if self.latency_override or any(o.latency_override for o in others):
            sides = [self] + others
            views = [s.latency_override or {
                "mean": s.mean_latency_us, "p99": s.p99_latency_us,
                "worst": s.worst_latency_us} for s in sides]
            tot = max(sum(items_w), 1)
            self.latency_override = {
                "mean": sum(v["mean"] * w
                            for v, w in zip(views, items_w, strict=True))
                        / tot,
                "p99": max(v["p99"] for v in views),
                "worst": max(v["worst"] for v in views),
            }
        else:
            self.latency_us.merge_all(o.latency_us for o in others)
        self.feeder_lag_us = max(self.feeder_lag_us,
                                 *(o.feeder_lag_us for o in others))
        donors = [o for o in others if o.per_queue]
        if donors:
            if not self.per_queue:
                self.per_queue = copy.deepcopy(donors[0].per_queue)
                donors = donors[1:]
            by_q = {q.queue: q for q in self.per_queue}
            grouped: dict[int, list[QueueStats]] = {}
            for o in donors:
                for oq in o.per_queue:
                    if oq.queue in by_q:
                        grouped.setdefault(oq.queue, []).append(oq)
                    else:
                        q = copy.deepcopy(oq)
                        self.per_queue.append(q)
                        by_q[oq.queue] = q
            for queue, slices in grouped.items():
                by_q[queue].merge_all(slices)
            self.per_queue.sort(key=lambda q: q.queue)
        win_donors = [o.windows for o in others if o.windows is not None]
        if self.windows is None and win_donors:
            self.windows = copy.deepcopy(win_donors[0])
            win_donors = win_donors[1:]
        if self.windows is not None:
            try:
                for w in win_donors:
                    self.windows.merge(w)
            except ValueError:
                self.windows = None
        for f in ("vacations_us", "busies_us", "n_v"):
            setattr(self, f, np.concatenate(
                [getattr(self, f)] + [getattr(o, f) for o in others]))
        same_grid = all(
            self.series_t_us.size
            and o.series_t_us.shape == self.series_t_us.shape
            and np.array_equal(o.series_t_us, self.series_t_us)
            for o in others)
        if same_grid and self.series_t_us.size:
            n_sides = 1 + len(others)
            for f in ("tput_series_mpps", "offered_series_mpps"):
                setattr(self, f, getattr(self, f)
                        + sum(getattr(o, f) for o in others))
            for f in ("rho_series", "ts_series"):
                setattr(self, f, (getattr(self, f)
                                  + sum(getattr(o, f) for o in others))
                        / n_sides)
        else:
            for f in ("rho_series", "ts_series", "tput_series_mpps",
                      "offered_series_mpps", "series_t_us"):
                setattr(self, f, _empty())
        return self

    def summary(self) -> dict:
        """Flat dict of the headline numbers (benchmark CSV rows, logs)."""
        if self.drain_truncations:
            warnings.warn(
                f"{self.drain_truncations} busy period(s) hit the drain "
                "round cap and stranded backlog until the next wake; "
                "service/latency numbers understate the saturation",
                RuntimeWarning, stacklevel=2)
        return {
            "backend": self.backend, "policy": self.policy,
            "workload": self.workload, "schedule": self.schedule,
            "wakeups": self.wakeups,
            "cycles": self.cycles, "busy_tries": self.busy_tries,
            "serviced": self.items, "offered": self.offered,
            "dropped": self.dropped, "loss_fraction": self.loss_fraction,
            "cpu_fraction": self.cpu_fraction,
            "energy_uj": self.energy_uj,
            "energy_per_packet_nj": self.energy_per_packet_nj,
            "mean_power_w": self.mean_power_w,
            "mean_latency_us": self.mean_latency_us,
            "mean_sojourn_us": self.mean_sojourn_us,
            "p99_latency_us": self.p99_latency_us,
            "n_queues": max(len(self.per_queue), 1),
            "drain_truncations": self.drain_truncations,
        }


def _fleet_survival(x: np.ndarray, mean_us: np.ndarray,
                    weight: np.ndarray, tail_prob: float,
                    tail_scale_us: float) -> np.ndarray:
    """Mixture survival of the per-host two-component latency model at
    points ``x`` (see ``hedged_latency_quantile``)."""
    xs = np.maximum(np.asarray(x, dtype=np.float64)[..., None], 0.0)
    body = np.exp(-xs / mean_us)
    if tail_prob > 0.0:
        tail = np.exp(-xs / (mean_us + tail_scale_us))
        per_host = (1.0 - tail_prob) * body + tail_prob * tail
    else:
        per_host = body
    return per_host @ weight


def hedged_latency_quantile(q: float, mean_us, weight=None, *,
                            hedge_deadline_us: float = 0.0,
                            tail_prob: float = 0.0,
                            tail_scale_us: float = 0.0) -> float:
    """Latency quantile of a replicated fleet under hedged requests.

    Per-host latency follows a two-component survival

        S_h(x) = (1 - p) * exp(-x / L_h) + p * exp(-x / (L_h + c))

    — an exponential body at the host's measured mean sojourn ``L_h``
    (``mean_us``, per host, network delays included) plus an
    environment-tail component of mass ``p = tail_prob`` at scale
    ``c = tail_scale_us`` (requests that land in a correlated stall
    window; pass the host's stalled-time fraction and stall mean).  The
    fleet distribution is the served-share-weighted mixture over hosts.

    Hedging with deadline ``D = hedge_deadline_us`` duplicates a request
    that has not completed by ``D`` to an independent replica drawn from
    the fleet mixture; first completion wins, so beyond the deadline the
    survival multiplies by the fresh replica's survival at age x - D:

        S_h^D(x) = S_h(x) * S_fleet(x - D)   for x > D.

    Stall windows are independent across hosts, so this is exactly the
    mechanism by which hedging collapses the correlated-stall tail: both
    replicas must stall for the request to stay slow.  Tightening D can
    only lower S pointwise, hence every quantile is monotonically
    non-increasing in D — the property the hedging sanity test pins.
    ``D <= 0`` disables hedging.  Solved by bisection; returns the
    latency in microseconds at which the fleet CDF reaches ``q``.
    """
    if not 0.0 < q < 1.0:
        raise ValueError("q must be in (0, 1)")
    mean_us = np.maximum(np.asarray(mean_us, dtype=np.float64).ravel(),
                         1e-9)
    if weight is None:
        weight = np.full(mean_us.size, 1.0 / mean_us.size)
    else:
        weight = np.asarray(weight, dtype=np.float64).ravel()
        weight = weight / max(weight.sum(), 1e-30)
    d = float(hedge_deadline_us)

    def survival(x):
        s = _fleet_survival(x, mean_us, weight, tail_prob, tail_scale_us)
        if d > 0.0:
            over = np.maximum(np.asarray(x, dtype=np.float64) - d, 0.0)
            partner = _fleet_survival(over, mean_us, weight, tail_prob,
                                      tail_scale_us)
            s = np.where(np.asarray(x) > d, s * partner, s)
        return s

    target = 1.0 - q
    hi = float(np.max(mean_us) + tail_scale_us) * 4.0 + max(d, 0.0) + 1.0
    for _ in range(200):
        if float(survival(hi)) < target:
            break
        hi *= 2.0
    lo = 0.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if float(survival(mid)) > target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
