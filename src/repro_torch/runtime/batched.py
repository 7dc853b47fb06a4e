"""Batched fixed-slot simulation engine: thousands of configs per call.

The port's counterpart of ``repro.runtime.batched``.  The event engine
(``sim``) is exact but serial: one (policy, workload, environment) point
per call, at interpreter speed.  This engine discretizes time into fixed
slots, advances every poller thread and Rx queue one slot at a time, and
runs a whole ``SweepGrid`` of operating points (T_S, T_L, M, n_queues,
offered load, seed) in ONE launch of the hand-written CUDA kernel
``repro_torch.kernels.slot_sweep`` (one GPU thread a point, time in series
inside the thread).  The model, its approximations against the event
engine and its parity bands are the reference's, step for step: arrivals
as a residual-carried Gaussian fluid, affine + noise sleep overshoot with
per-wake interference and correlated stall windows, claims of the longest
free backlog in thread order, drain at mu, Little's-law latency, per-arm
C-state energy and optional per-window sums.

What differs from the reference:

  - the noise comes from the Philox contract of
    ``repro_torch.kernels.slot_sweep.philox`` (keyed by each point's seed,
    so points that share a seed share their draws), not from jax's
    threefry: the same grid gives other sample paths, inside the same
    bands;
  - ``device`` picks where the sweep runs: CUDA (the default) launches the
    kernel or raises, ``"cpu"`` runs its plain PyTorch version (a Python
    loop over slots, for tests at small sizes);
  - ``stepping="adaptive"`` runs the event-jump sweep of
    ``batched_adaptive`` in one launch of the kernel
    ``repro_torch.kernels.adaptive_sweep``;
  - nothing is compiled per shape, so the reference's
    ``CompileCache``/``compile_cache_stats`` have no counterpart: the
    kernel is built once, at first use, and the slot loop stops at the
    run's duration, so ``bucket_steps`` only bounds it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.slot_sweep import SweepParams, energy_arm_cost, slot_sweep
from ..kernels.slot_sweep.ops import STAT_NAMES
from .simcore import SimRunConfig
from .stats import Reservoir, RunStats, WindowedSeries

__all__ = ["SweepGrid", "BatchStats", "simulate_batch", "bucket_steps", "energy_arm_cost",
           "unsupported_config_fields", "validate_batched_config", "grid_columns"]


def bucket_steps(n: int, *, base: int = 64, ratio: float = 1.25) -> int:
    """Round a slot count up to the reference's geometric ladder
    (``base * ratio**k``), on which it keys its compiled kernels.  The
    port's kernel takes the rung as the bound of its slot loop, which also
    stops at the run's duration, so results do not depend on it; it sizes
    the window padding (``n_win_pad``) as the reference's does."""
    n = max(int(n), 1)
    v = base
    # rungs are the iterates v -> ceil(v * ratio), which makes every
    # rung a fixed point: bucket_steps(bucket_steps(n)) == bucket_steps(n)
    while v < n:
        v = int(math.ceil(v * ratio))
    return v


_DIMS = ("t_s_us", "t_l_us", "m", "n_queues", "rate_mpps", "seed")

# fixed-width piecewise-constant schedule rows the kernel consumes; a
# schedule denser than this is resampled to its per-segment means
_MAX_SCHED_SEGMENTS = 256


@dataclass(frozen=True)
class SweepGrid:
    """A flat batch of operating points, one simulated run per row.

    ``product(...)`` builds the dense cartesian grid (and remembers its
    logical ``shape`` so results can be reshaped per axis);
    ``of_points(...)`` wraps an arbitrary list of points (parity tests,
    spot checks).  All arrays share one length ``len(grid)``.

    ``schedules`` (optional) carries one ``LoadSchedule`` — or ``None``
    for stationary — per point: the batched engine evaluates each row's
    schedule as a piecewise-constant rate multiplier inside the slot
    loop, so a single vmapped call can sweep step/ramp/sinusoid/MMPP
    trajectories next to stationary points.  ``product`` grows the
    logical ``shape`` by a trailing schedules axis only when a
    ``schedules`` axis is passed (existing stationary grids keep their
    shape contract).
    """

    t_s_us: np.ndarray
    t_l_us: np.ndarray
    m: np.ndarray
    n_queues: np.ndarray
    rate_mpps: np.ndarray
    seed: np.ndarray
    shape: tuple = ()            # cartesian shape in _DIMS order ("" = flat)
    dims: tuple = _DIMS
    schedules: tuple = ()        # per-point LoadSchedule | None ("" = none)

    @classmethod
    def product(cls, *, t_s_us, t_l_us, rate_mpps, m=(3,), n_queues=(1,),
                seeds=(0,), schedules=None) -> "SweepGrid":
        axes = [np.atleast_1d(np.asarray(a)) for a in
                (t_s_us, t_l_us, m, n_queues, rate_mpps, seeds)]
        sched_axis = (np.arange(len(schedules))
                      if schedules is not None else np.zeros(1, np.int64))
        mesh = np.meshgrid(*axes, sched_axis, indexing="ij")
        shape = tuple(a.size for a in axes)
        if schedules is not None:
            shape = shape + (len(schedules),)
        vals = [g.ravel() for g in mesh]
        scheds = (tuple(schedules[i] for i in vals[6])
                  if schedules is not None else ())
        return cls(t_s_us=vals[0].astype(np.float64),
                   t_l_us=vals[1].astype(np.float64),
                   m=vals[2].astype(np.int32),
                   n_queues=vals[3].astype(np.int32),
                   rate_mpps=vals[4].astype(np.float64),
                   seed=vals[5].astype(np.int64),
                   shape=shape,
                   schedules=scheds)

    @classmethod
    def of_points(cls, points) -> "SweepGrid":
        """``points``: iterable of dicts with keys from ``SweepGrid.dims``
        (missing keys take m=3, n_queues=1, seed=0) plus an optional
        ``schedule`` (a ``LoadSchedule``) per point."""
        pts = list(points)
        get = lambda k, d: np.asarray([p.get(k, d) for p in pts])  # noqa: E731
        scheds = tuple(p.get("schedule") for p in pts)
        return cls(t_s_us=get("t_s_us", 10.0).astype(np.float64),
                   t_l_us=get("t_l_us", 500.0).astype(np.float64),
                   m=get("m", 3).astype(np.int32),
                   n_queues=get("n_queues", 1).astype(np.int32),
                   rate_mpps=get("rate_mpps", 14.88).astype(np.float64),
                   seed=get("seed", 0).astype(np.int64),
                   shape=(len(pts),),
                   schedules=(scheds if any(s is not None for s in scheds)
                              else ()))

    def __len__(self) -> int:
        return int(self.t_s_us.size)

    def point(self, i: int) -> dict:
        d = {k: getattr(self, k)[i].item() for k in self.dims}
        if self.schedules:
            d["schedule"] = self.schedules[i]
        return d


@dataclass
class BatchStats:
    """Array-shaped results, one entry per ``SweepGrid`` row.

    Everything is a float64 numpy array of shape ``(len(grid),)``;
    derived metrics are properties.  ``reshaped(name)`` folds a metric
    back to the grid's cartesian ``shape``; ``to_run_stats(i)`` converts
    one point into the unified ``RunStats`` (latency beyond the mean is
    an analytic estimate — the batched engine does not keep samples).
    """

    grid: SweepGrid
    cfg: SimRunConfig
    slot_us: float
    offered: np.ndarray = field(default_factory=lambda: np.empty(0))
    dropped: np.ndarray = field(default_factory=lambda: np.empty(0))
    serviced: np.ndarray = field(default_factory=lambda: np.empty(0))
    wakeups: np.ndarray = field(default_factory=lambda: np.empty(0))
    busy_tries: np.ndarray = field(default_factory=lambda: np.empty(0))
    cycles: np.ndarray = field(default_factory=lambda: np.empty(0))
    awake_us: np.ndarray = field(default_factory=lambda: np.empty(0))
    lat_area: np.ndarray = field(default_factory=lambda: np.empty(0))
    vac_sum: np.ndarray = field(default_factory=lambda: np.empty(0))
    nv_sum: np.ndarray = field(default_factory=lambda: np.empty(0))
    # energy accounting (cfg.energy_model): T_S-class arm count and the
    # total charge — active_power*awake + per-arm C-state residency +
    # transition energy (T_L-class arms == busy_tries)
    ts_arms: np.ndarray = field(default_factory=lambda: np.empty(0))
    energy_uj: np.ndarray = field(default_factory=lambda: np.empty(0))
    # cfg.window_us > 0: per-point windowed accumulators of shape
    # (len(grid), n_windows, 5) — [offered, served, lat_area, awake,
    # energy] — the same raw sums the event engine's WindowAccum keeps
    win: np.ndarray = field(default_factory=lambda: np.empty(0))
    # stepping diagnostics: which kernel produced this batch, its
    # compiled scan length, and per-point live-step / forced-step
    # counts, exact simulated time, and end-of-run total backlog (the
    # missing term of the offered = served + dropped + backlog law)
    stepping: str = "fixed"
    scan_len: int = 0
    n_steps: np.ndarray = field(default_factory=lambda: np.empty(0))
    forced_steps: np.ndarray = field(default_factory=lambda: np.empty(0))
    sim_time_us: np.ndarray = field(default_factory=lambda: np.empty(0))
    final_backlog: np.ndarray = field(default_factory=lambda: np.empty(0))

    # -- derived ---------------------------------------------------------------
    @property
    def cpu_fraction(self) -> np.ndarray:
        return self.awake_us / self.cfg.duration_us

    @property
    def loss_fraction(self) -> np.ndarray:
        return self.dropped / np.maximum(self.offered, 1.0)

    @property
    def mean_latency_us(self) -> np.ndarray:
        """Little's-law mean sojourn: queue-depth integral over departures."""
        return self.lat_area / np.maximum(self.serviced, 1.0)

    @property
    def mean_vacation_us(self) -> np.ndarray:
        return self.vac_sum / np.maximum(self.cycles, 1.0)

    @property
    def mean_nv(self) -> np.ndarray:
        return self.nv_sum / np.maximum(self.cycles, 1.0)

    @property
    def energy_per_packet_nj(self) -> np.ndarray:
        return 1e3 * self.energy_uj / np.maximum(self.serviced, 1.0)

    @property
    def mean_power_w(self) -> np.ndarray:
        return self.energy_uj / self.cfg.duration_us

    @property
    def rho(self) -> np.ndarray:
        return self.grid.rate_mpps / self.cfg.service_rate_mpps

    def reshaped(self, name: str) -> np.ndarray:
        val = getattr(self, name)
        return np.asarray(val).reshape(self.grid.shape)

    def _schedule(self, i: int):
        # mirror _schedule_rows' precedence exactly: a None row inside a
        # scheduled grid falls back to the batch-wide config schedule
        # (which is what the kernel simulated for that row)
        if self.grid.schedules and self.grid.schedules[i] is not None:
            return self.grid.schedules[i]
        return self.cfg.schedule

    def windows(self, i: int) -> WindowedSeries | None:
        """Point ``i``'s windowed series — the same accumulator
        convention (and therefore the same derived-metric /
        ``TrackingStats`` code path) as the event engine's.  ``None``
        when the run was not windowed (``cfg.window_us == 0``).  The
        slot engine keeps no latency samples, so per-window p99 is NaN
        and there is no controller estimate (static timeouts: the grid,
        not a controller, is the adaptation space)."""
        if self.win.size == 0:
            return None
        w = self.win[i]
        return WindowedSeries(
            window_us=float(self.cfg.window_us),
            service_rate_mpps=self.cfg.service_rate_mpps,
            offered=w[:, 0].copy(), served=w[:, 1].copy(),
            lat_area_us=w[:, 2].copy(), awake_us=w[:, 3].copy(),
            energy_uj=w[:, 4].copy())

    def tracking(self, i: int, target_latency_us: float, **kw):
        """``TrackingStats`` for point ``i`` against its schedule's
        transitions — identical computation to the event engine's
        ``stats.windows.tracking(...)``."""
        ws = self.windows(i)
        if ws is None:
            raise ValueError("run was not windowed: set cfg.window_us")
        sched = self._schedule(i)
        trans = (sched.transitions(self.cfg.duration_us)
                 if sched is not None else ())
        return ws.tracking(trans, target_latency_us, **kw)

    def to_run_stats(self, i: int) -> RunStats:
        p = self.grid.point(i)
        mean = float(self.mean_latency_us[i])
        cap = self.cfg.queue_capacity * max(int(p["n_queues"]), 1)
        sched = self._schedule(i)
        return RunStats(
            backend="batched",
            policy=(f"sleepwake(t_s={p['t_s_us']:g},t_l={p['t_l_us']:g},"
                    f"m={p['m']})"),
            workload=f"poisson({p['rate_mpps']:g})",
            schedule=sched.descriptor() if sched is not None else "",
            wakeups=int(self.wakeups[i]), cycles=int(self.cycles[i]),
            busy_tries=int(self.busy_tries[i]),
            items=int(self.serviced[i]), offered=int(self.offered[i]),
            dropped=int(self.dropped[i]),
            awake_ns=round(self.awake_us[i] * 1e3), started_ns=0,
            stopped_ns=round(self.cfg.duration_us * 1e3),
            latency_us=Reservoir(4, seed=int(p["seed"])),
            latency_area_us=float(self.lat_area[i]),
            energy_uj=float(self.energy_uj[i]),
            # no per-packet samples in the slot engine: mean is measured
            # (Little), p99/worst are coarse analytic estimates
            latency_override={
                "mean": mean,
                "p99": mean * 3.0,
                "worst": float(cap / self.cfg.service_rate_mpps
                               + p["t_l_us"]),
            },
            # no per-queue counter breakdown in the slot engine's
            # aggregate stats: leave per_queue empty rather than emit
            # all-zero slices that would break the sums-to-total law
            per_queue=[],
            windows=self.windows(i),
            vacations_us=np.asarray([self.mean_vacation_us[i]]),
            busies_us=np.asarray([self.serviced[i]
                                  / self.cfg.service_rate_mpps
                                  / max(self.cycles[i], 1.0)]),
            n_v=np.asarray([self.mean_nv[i]]),
        )

    def __len__(self) -> int:
        return len(self.grid)


_EVENT_ENGINE_ONLY_FIELDS = ("timeseries_bin_us",)
# SimRunConfig fields this engine deliberately does NOT read, named so
# the engine-parity static check (repro.analysis, PARITY001/002) can
# prove the drift guard complete instead of trusting it:
#   - grid-supplied: seed and n_queues come per-point from the
#     SweepGrid row (the grid axis IS the sweep surface; cfg.seed /
#     cfg.n_queues are event-engine inputs only);
#   - sample-path detail: the fixed-slot engine keeps no latency
#     reservoir, so its size knob has no fixed-slot meaning.
_GRID_SUPPLIED_FIELDS = ("seed", "n_queues")
_NO_SAMPLE_PATH_FIELDS = ("latency_reservoir",)


def unsupported_config_fields(cfg: SimRunConfig) -> list[str]:
    """``SimRunConfig`` fields set to values the batched engine cannot
    honor.  Empty list = the config is fully batched-simulable."""
    return [f for f in _EVENT_ENGINE_ONLY_FIELDS if getattr(cfg, f)]


def validate_batched_config(cfg: SimRunConfig) -> None:
    """Raise eagerly — before any compilation or sweep work — if ``cfg``
    sets fields only the event engine honors, naming each offending
    field (so config errors surface at construction sites such as
    ``build_operating_table``, not as a generic mid-run failure)."""
    bad = unsupported_config_fields(cfg)
    if bad:
        raise ValueError(
            "SimRunConfig field(s) not supported by the batched engine: "
            + ", ".join(f"{f}={getattr(cfg, f)!r}" for f in bad)
            + "; use repro.runtime.sim.simulate_run for those studies")


def _schedule_rows(grid: SweepGrid, cfg: SimRunConfig
                   ) -> tuple[int, np.ndarray, np.ndarray]:
    """Compile the batch's load schedules to fixed-width
    ``(edges, scales)`` rows.  Per-point grid schedules win over the
    config-wide one; ``(0, trivial, trivial)`` when every point is
    stationary (the kernel then skips the lookup entirely)."""
    n = len(grid)
    if grid.schedules:
        scheds = list(grid.schedules)
        if cfg.schedule is not None:
            scheds = [s if s is not None else cfg.schedule for s in scheds]
    elif cfg.schedule is not None:
        scheds = [cfg.schedule] * n
    else:
        return 0, np.zeros((n, 1)), np.ones((n, 1))
    n_seg = 1
    for s in scheds:
        if s is not None:
            n_seg = max(n_seg, len(s.segments(cfg.duration_us)[0]))
    n_seg = min(n_seg, _MAX_SCHED_SEGMENTS)
    edges = np.zeros((n, n_seg))
    scales = np.ones((n, n_seg))
    for i, s in enumerate(scheds):
        if s is None:       # stationary row inside a scheduled batch
            edges[i] = np.concatenate(
                [[0.0], cfg.duration_us + 1.0 + np.arange(n_seg - 1)])
        else:
            edges[i], scales[i] = s.compiled(cfg.duration_us, n_seg)
    return n_seg, edges, scales


def sweep_inputs(grid: SweepGrid, cfg: SimRunConfig, slot_us: float,
                 device) -> tuple[tuple, SweepParams]:
    """The arguments of ``slot_sweep`` for ``grid`` in ``cfg`` on
    ``device``: the per-point columns (and schedule rows, or ``None``) and
    the batch's ``SweepParams``."""
    n_windows = (int(math.ceil(cfg.duration_us / cfg.window_us))
                 if cfg.window_us > 0 else 0)
    n_slots = bucket_steps(max(int(math.ceil(cfg.duration_us / slot_us)), 1))
    n_seg, sched_edges, sched_scales = _schedule_rows(grid, cfg)
    sm = cfg.sleep_model
    em = cfg.energy_model
    params = SweepParams(
        n_slots=n_slots, slot_us=float(slot_us), duration_us=float(cfg.duration_us),
        service_rate_mpps=float(cfg.service_rate_mpps),
        queue_capacity=float(cfg.queue_capacity), wake_cost_us=float(cfg.wake_cost_us),
        base_us=float(sm.base_us), slope=float(sm.slope), sigma_us=float(sm.sigma_us),
        tail_prob=float(sm.tail_prob), tail_mean_us=float(sm.tail_mean_us),
        interference_prob=float(cfg.interference_prob),
        interference_mean_us=float(cfg.interference_mean_us),
        stall_rate_per_us=float(cfg.stall_rate_per_us),
        stall_mean_us=float(cfg.stall_mean_us),
        active_power_w=float(em.active_power_w), sleep_states=em.sleep_states,
        n_windows=n_windows,
        n_win_pad=bucket_steps(n_windows, base=8) if n_windows else 0,
        window_us=float(cfg.window_us))
    return grid_columns(grid, n_seg, sched_edges, sched_scales, device), params


def grid_columns(grid: SweepGrid, n_seg: int, sched_edges, sched_scales, device) -> tuple:
    """The per-point inputs both sweep kernels take, on ``device``: T_S,
    T_L, M, n_queues, the offered rate, the seed's two 32-bit words, and the
    schedule rows (``None`` for a stationary batch)."""
    seed64 = np.asarray(grid.seed, dtype=np.uint64)

    def col(values, dtype):
        return torch.as_tensor(np.asarray(values), device=device).to(dtype)

    def words(values):            # uint32 -> the same bits as int32
        return col(values.astype(np.uint32).view(np.int32), torch.int32)

    return (col(grid.t_s_us, torch.float32), col(grid.t_l_us, torch.float32),
            col(grid.m, torch.int32), col(grid.n_queues, torch.int32),
            col(grid.rate_mpps, torch.float32),
            words(seed64 & np.uint64(0xFFFFFFFF)), words(seed64 >> np.uint64(32)),
            col(sched_edges, torch.float32) if n_seg else None,
            col(sched_scales, torch.float32) if n_seg else None)


def stats_from_outputs(grid: SweepGrid, cfg: SimRunConfig, slot_us: float,
                       params: SweepParams, out: dict) -> BatchStats:
    """``BatchStats`` of one ``slot_sweep`` (or plain version) result."""
    n = len(grid)
    vals = {k: out[k].cpu().numpy().astype(np.float64)
            for k in (*STAT_NAMES, "win", "backlog")}
    n_slots_true = max(int(math.ceil(cfg.duration_us / slot_us)), 1)
    return BatchStats(grid=grid, cfg=cfg, slot_us=float(slot_us),
                      **{k: vals[k] for k in STAT_NAMES},
                      win=vals["win"] if params.n_windows else np.empty(0),
                      stepping="fixed", scan_len=params.n_slots,
                      n_steps=np.full(n, float(n_slots_true)),
                      forced_steps=np.zeros(n),
                      # fixed slots overshoot duration by the ceil slot
                      sim_time_us=np.full(n, n_slots_true * slot_us),
                      final_backlog=vals["backlog"])


def _fixed_sweep(grid: SweepGrid, cfg: SimRunConfig, slot_us: float,
                 device) -> BatchStats:
    """The fixed-slot sweep of ``simulate_batch`` on ``device`` (one kernel
    launch on a CUDA device, the plain version on the CPU)."""
    args, params = sweep_inputs(grid, cfg, slot_us, device)
    out = slot_sweep(*args, params=params)
    return stats_from_outputs(grid, cfg, slot_us, params, out)


def simulate_batch(grid: SweepGrid, cfg: SimRunConfig | None = None, *,
                   slot_us: float = 0.5, stepping: str = "fixed",
                   device="cuda") -> BatchStats:
    """Simulate every operating point in ``grid`` — one kernel launch over
    the whole batch.

    ``cfg`` supplies the environment (duration, mu, per-queue capacity,
    sleep model, wake cost, OS interference / correlated stalls, load
    schedule, window size, energy model); per-point knobs (T_S, T_L, M,
    n_queues, offered Poisson rate, seed, schedule) come from the grid and
    override the config's.  ``cfg.window_us > 0`` turns on the windowed
    adaptation series (``BatchStats.windows(i)``).  Binned time series
    remain event-engine-only and raise (``validate_batched_config``).

    ``stepping`` selects the kernel: ``"fixed"`` (default) steps uniform
    ``slot_us`` slots (``slot_sweep``); ``"adaptive"`` steps event-jump
    macro-slots (``batched_adaptive``, the ``adaptive_sweep`` kernel) —
    same statistics, same parity bands, steps proportional to the event
    count instead of simulated time.

    ``device`` (default ``"cuda"``) is where the sweep runs: a CUDA device
    launches the kernel (or raises), ``"cpu"`` runs its plain version.
    """
    cfg = cfg or SimRunConfig()
    validate_batched_config(cfg)
    if stepping not in ("fixed", "adaptive"):
        raise ValueError(
            f"stepping must be 'fixed' or 'adaptive', got {stepping!r}")
    device = resolve_device(device)
    if stepping == "adaptive":
        from .batched_adaptive import adaptive_sweep_arrays
        vals, win_np, back_f, simt, scan_len = adaptive_sweep_arrays(
            grid, cfg, float(slot_us), device)
        return BatchStats(
            grid=grid, cfg=cfg, slot_us=float(slot_us),
            offered=vals["offered"], dropped=vals["dropped"],
            serviced=vals["serviced"], wakeups=vals["wakeups"],
            busy_tries=vals["busy_tries"], cycles=vals["cycles"],
            awake_us=vals["awake_us"], lat_area=vals["lat_area"],
            vac_sum=vals["vac_sum"], nv_sum=vals["nv_sum"],
            ts_arms=vals["ts_arms"], energy_uj=vals["energy_uj"],
            win=win_np, stepping="adaptive", scan_len=int(scan_len),
            n_steps=vals["n_steps"], forced_steps=vals["forced_steps"],
            sim_time_us=simt, final_backlog=back_f)
    return _fixed_sweep(grid, cfg, float(slot_us), device)
