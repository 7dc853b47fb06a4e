"""Backend-agnostic simulation core shared by every simulation engine.

The environment model (``SimRunConfig``), the timer-quality model
(``SleepModel`` and its paper-fitted instances), and the run-setup
normalization (dispatcher/assignment resolution, per-queue latency
reservoir construction) live here so that the two simulation engines —
the event-driven ``repro.runtime.sim.simulate_run`` and the batched JAX
``repro.runtime.batched.simulate_batch`` — share one config surface and
one stats-assembly convention instead of drifting apart.

Engines differ only in *how* they execute the renewal system:

  - the event engine walks wake events one at a time (exact, serial,
    one config per call);
  - the batched engine steps fixed time slots under ``jax.lax.scan``
    and ``vmap``s over a whole grid of configs (approximate, massively
    parallel).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .assignment import SharedAssignment
from .dispatch import RoundRobinDispatch
from .stats import Reservoir, WindowedSeries

__all__ = [
    "SleepModel",
    "HR_SLEEP_MODEL",
    "NANOSLEEP_MODEL",
    "PERFECT_SLEEP_MODEL",
    "EnergyModel",
    "DEFAULT_ENERGY_MODEL",
    "DEEP_CSTATE_ENERGY_MODEL",
    "SimRunConfig",
    "FleetConfig",
    "EngineSetup",
    "WindowAccum",
    "prepare_run",
    "queue_reservoirs",
]


@dataclass(frozen=True)
class SleepModel:
    """actual = target + base + slope*target + |N(0, sigma)|
              + Exp(tail_mean) w.p. tail_prob            (us units).

    Fitted to paper Table 1 (mean/p99):
      hr_sleep :  base ~ 2.8us, slope ~ 0.027, sigma ~ 0.5   (mean +3.5..8.4)
      nanosleep:  base ~ 57.5us, slope ~ 0.003, sigma ~ 3.0  (mean +58 flat)
    The nanosleep arm additionally carries a heavy preemption tail —
    without it the simulator under-loses vs the paper's Table 3 (a +58us
    mean backlogs < 1024 descriptors; the paper still lost 3.9% at a 4096
    ring, implying rare multi-hundred-us pile-ups).  Tail parameters chosen
    so the q=1024..4096 loss ladder brackets the paper's.

    Energy accounting (``EnergyModel``) deliberately ignores this model's
    overshoot: the C-state and charged residency come from the *target*
    (the programmed timer — what a next-timer-event cpuidle governor
    sees), so timer noise is unpaid time in the already-chosen state, a
    second-order correction folded into the model error.
    """

    base_us: float
    slope: float
    sigma_us: float
    tail_prob: float = 0.0
    tail_mean_us: float = 0.0

    def sample(self, target_us: np.ndarray | float, rng: np.random.Generator):
        t = np.asarray(target_us, dtype=np.float64)
        noise = np.abs(rng.normal(0.0, self.sigma_us, size=t.shape))
        out = t + self.base_us + self.slope * t + noise
        if self.tail_prob:
            hit = rng.random(size=t.shape) < self.tail_prob
            out = out + hit * rng.exponential(self.tail_mean_us, size=t.shape)
        return out


HR_SLEEP_MODEL = SleepModel(base_us=2.8, slope=0.027, sigma_us=0.5)
NANOSLEEP_MODEL = SleepModel(base_us=57.5, slope=0.003, sigma_us=3.0,
                             tail_prob=0.01, tail_mean_us=400.0)
PERFECT_SLEEP_MODEL = SleepModel(base_us=0.0, slope=0.0, sigma_us=0.0)


@dataclass(frozen=True)
class EnergyModel:
    """C-state/DVFS package power model (W x us = uJ), charged
    identically by every execution layer.

    Three components:

      - **active**: ``active_power_w`` per awake microsecond (wake cost
        plus service time).  The busy-poll spin model additionally
        multiplies by ``dvfs_busy_scale`` — a spinning core pins its
        turbo frequency while a duty-cycled Metronome core can downclock
        between bursts.
      - **sleep**: every time a thread arms a sleep with target ``T``
        the core enters the *deepest* C-state whose
        ``min_residency_us <= T`` and is charged that state's
        ``power_w * T``.  This is the next-timer-event governor
        approximation (Linux cpuidle menu/teo): the state is picked from
        the *programmed* timer (T_S or T_L), not the realized residency,
        so timer overshoot (``SleepModel``) is unpaid noise in the
        already-chosen state.  Short targets stay in a shallow state —
        the minimum-residency thresholds are what make rapid polling
        energy-expensive even when its CPU looks cheap.
      - **transition**: each arm additionally pays the chosen state's
        ``transition_uj`` (entry + exit energy of one wake cycle).

    ``sleep_states`` holds ``(power_w, transition_uj, min_residency_us)``
    tuples; they are normalized shallow-to-deep at construction and the
    shallowest must have threshold 0 so every target lands somewhere.
    Deep states trade a lower power floor for higher per-wake transition
    energy and a residency floor — which is why the energy-optimal
    (T_S, T_L) sits at *longer* sleeps than the CPU-optimal point (see
    ``build_operating_table(objective="energy")``): per-thread sleep
    power scales with ``m * P(T_S)`` while CPU's wake overhead scales
    with ``m / T_S``, so the two objectives rank operating points
    differently.

    Accounting convention shared by the engines: energy is charged at
    arm time (a sleep still pending at run end was charged when armed),
    T_S-class arms are empty claims plus drain-end releases, T_L-class
    arms are blocked wakes (``busy_tries``).
    """

    active_power_w: float = 10.0
    # (power_w, transition_uj, min_residency_us), shallow -> deep
    sleep_states: tuple = ((1.5, 0.5, 0.0),
                           (0.6, 4.0, 30.0),
                           (0.25, 15.0, 300.0))
    dvfs_busy_scale: float = 1.0

    def __post_init__(self):
        states = tuple(sorted(
            (tuple(float(x) for x in s) for s in self.sleep_states),
            key=lambda s: s[2]))
        if not states or states[0][2] > 0.0:
            raise ValueError(
                "EnergyModel.sleep_states needs a shallow state with "
                "min_residency_us == 0 so every sleep target lands "
                "somewhere")
        if any(len(s) != 3 for s in states):
            raise ValueError("sleep_states entries must be "
                             "(power_w, transition_uj, min_residency_us)")
        object.__setattr__(self, "sleep_states", states)

    def params(self) -> tuple:
        """Hashable static parameters for the jit-compiled kernels."""
        return (float(self.active_power_w), float(self.dvfs_busy_scale),
                self.sleep_states)

    def select(self, target_us: float) -> tuple:
        """``(power_w, transition_uj)`` of the deepest C-state whose
        minimum residency fits the programmed sleep target."""
        p_w, t_uj = self.sleep_states[0][0], self.sleep_states[0][1]
        for pw, tuj, thr_us in self.sleep_states[1:]:
            if target_us >= thr_us:
                p_w, t_uj = pw, tuj
        return p_w, t_uj

    def arm_energy_uj(self, target_us: float) -> float:
        """Sleep + transition energy of ONE armed sleep of the given
        target: deepest-fitting state's power x target + its
        transition."""
        p_w, t_uj = self.select(float(target_us))
        return p_w * float(target_us) + t_uj

    def active_energy_uj(self, awake_us, *, spin: bool = False):
        """Energy of awake time; ``spin=True`` applies the DVFS busy
        scale (busy-poll cores pin their max frequency)."""
        scale = self.dvfs_busy_scale if spin else 1.0
        return self.active_power_w * scale * np.asarray(
            awake_us, dtype=np.float64)


DEFAULT_ENERGY_MODEL = EnergyModel()
# Aggressive deep-sleep part: much lower floor power behind much larger
# transition costs and residency thresholds — the regime where the
# energy-optimal (T_S, T_L) visibly diverges from the CPU-optimal point
# (benchmarks/power.py pins that divergence).
DEEP_CSTATE_ENERGY_MODEL = EnergyModel(
    active_power_w=10.0,
    sleep_states=((2.0, 0.2, 0.0),
                  (0.3, 10.0, 40.0),
                  (0.12, 30.0, 400.0)),
    dvfs_busy_scale=1.25)


@dataclass(frozen=True)
class SimRunConfig:
    """Environment knobs — everything that is *not* the policy or the
    workload: service rate, queue size, timer quality, OS interference."""

    duration_us: float = 1_000_000.0
    service_rate_mpps: float = 29.76          # mu (packets / us)
    queue_capacity: int = 1024                # Rx descriptors *per queue*
    n_queues: int = 1                         # Rx queues (RSS rings)
    sleep_model: SleepModel = HR_SLEEP_MODEL
    wake_cost_us: float = 1.0                 # poll+return CPU cost per wake
    # OS interference (paper Sec 5.6): each wake delayed by Exp(mean) w.p. q.
    interference_prob: float = 0.0
    interference_mean_us: float = 0.0
    # Correlated stalls: Poisson system-wide freeze events delaying EVERY
    # wake that falls inside them (kernel timer-wheel/preemption pile-ups).
    # Needed for the paper's Table-3 weak queue-size dependence: backup
    # threads absorb uncorrelated per-thread tails, so only correlated
    # stalls overflow a 4096-descriptor ring.
    stall_rate_per_us: float = 0.0
    stall_mean_us: float = 0.0
    seed: int = 0
    timeseries_bin_us: float = 0.0            # >0: emit binned time series
    latency_reservoir: int = 262_144
    # Nonstationary traffic: a repro.runtime.schedule.LoadSchedule that
    # modulates the workload's rate over time.  The event engine wraps
    # the workload in a time-warping ScheduledWorkload; the batched
    # engine evaluates the schedule's piecewise-constant scale per slot.
    schedule: object | None = None
    # >0: both simulation engines emit RunStats.windows — per-window
    # offered/served/latency/CPU/rho accumulators (WindowedSeries), the
    # cross-backend adaptation-tracking surface (unlike
    # timeseries_bin_us, which stays event-engine-only).
    window_us: float = 0.0
    # C-state/DVFS power accounting, charged by every engine with the
    # same arm-time convention (see EnergyModel) and surfaced as
    # RunStats.energy_uj / energy_per_packet_nj.
    energy_model: EnergyModel = DEFAULT_ENERGY_MODEL

    @property
    def is_noisy(self) -> bool:
        """True when any CPU-sharing injection (per-wake interference or
        correlated stalls) is active — i.e. this is a shared-host, not a
        quiet-host, environment."""
        return bool(self.interference_prob or self.stall_rate_per_us)

    def interference_slack_us(self) -> float:
        """Expected mean-vacation shift of this environment's OS
        interference over the quiet-host closed forms, in us.

        Two additive terms:

          - per-wake: every re-sleep stretches by Exp(mean) w.p. q, so
            the wake ending a vacation arrives ``q * mean`` late in
            expectation;
          - correlated stalls: the wake ending a vacation lands inside
            an open Exp(s) window w.p. ~ the stalled time fraction
            ``rate * s`` and is deferred by the window's residual life
            (= s, memoryless), i.e. ``rate * s^2`` — the E[W^2]/2 tail
            of the Poisson window process (E[W^2] = 2 s^2).

        Calibration's analytic guard widens its quiet-host App-C
        tolerance by this slack so contention-honest sweeps are not
        rejected for disagreeing with a quiet-host prediction.
        """
        per_wake = self.interference_prob * self.interference_mean_us
        stall = self.stall_rate_per_us * self.stall_mean_us ** 2
        return per_wake + stall


_LB_POLICIES = ("uniform", "weighted", "least-loaded")

# M/M/1 link waits blow up as the far-rack rate approaches the link
# rate; the fluid model clamps the wait at utilization 98% (a 50x
# service time) so a momentarily oversubscribed link yields a large
# finite delay instead of a NaN that poisons the whole sweep point
_LINK_UTIL_CLAMP = 0.98


@dataclass(frozen=True)
class FleetConfig:
    """Fleet-level environment: N replica hosts behind one load balancer.

    Everything *outside* a single host — how the shared arrival stream
    is split across replicas, and what the network between the balancer
    and each rack costs:

      - ``lb``: arrival-split policy.  ``uniform`` and ``weighted`` are
        static shares; ``least-loaded`` follows a softmin over a
        backlog snapshot that refreshes only every ``lb_stale_us``
        (a balancer polling replica queue depths at a finite rate —
        the stale-signal regime where load balancing misfires).
      - topology: the first ``round(far_fraction * n_hosts)`` hosts sit
        in a far rack.  Every packet pays its rack's constant cost
        (``near_cost_us`` / ``far_cost_us``); far packets additionally
        queue on a shared bottleneck link modeled M/M/1-style — wait
        ``1 / (link_rate_mpps - far_rate)``, clamped near saturation
        (``link_rate_mpps = 0`` means no bottleneck).  Network delay is
        charged to a separate per-host accumulator, not the host's
        queue-depth integral, so host-level parity vs the single-host
        engines is unaffected.

    Hedge deadlines are *operating-point* knobs, not environment: they
    live per sweep point on ``FleetGrid``, next to (T_S, T_L, M).
    """

    n_hosts: int = 1
    lb: str = "uniform"
    host_weights: tuple = ()           # traffic shares, lb="weighted" only
    lb_stale_us: float = 0.0           # least-loaded snapshot refresh lag
    lb_softness_pkts: float = 4.0      # softmin temperature (packets)
    far_fraction: float = 0.0
    near_cost_us: float = 0.0
    far_cost_us: float = 0.0
    link_rate_mpps: float = 0.0        # shared far-rack bottleneck (0 = none)

    def validate(self) -> "FleetConfig":
        if self.n_hosts < 1:
            raise ValueError("FleetConfig.n_hosts must be >= 1")
        if self.lb not in _LB_POLICIES:
            raise ValueError(f"FleetConfig.lb must be one of {_LB_POLICIES}")
        if self.lb == "weighted":
            if len(self.host_weights) != self.n_hosts:
                raise ValueError("host_weights must have one entry per host")
            if min(self.host_weights) <= 0:
                raise ValueError("host_weights must be positive")
        elif self.host_weights:
            raise ValueError("host_weights only apply to lb='weighted'")
        if not 0.0 <= self.far_fraction <= 1.0:
            raise ValueError("far_fraction must be in [0, 1]")
        if min(self.near_cost_us, self.far_cost_us,
               self.link_rate_mpps, self.lb_stale_us) < 0:
            raise ValueError("fleet costs/rates must be >= 0")
        if self.lb_softness_pkts <= 0:
            raise ValueError("lb_softness_pkts must be > 0")
        return self

    # -- static split ----------------------------------------------------------
    def shares(self) -> np.ndarray:
        """Static per-host traffic shares.  ``least-loaded`` has no
        static split (it reacts to backlog); its long-run share over
        identical hosts is uniform, which is what the exact event-engine
        reference path uses."""
        if self.lb == "weighted":
            w = np.asarray(self.host_weights, dtype=np.float64)
            return w / w.sum()
        return np.full(self.n_hosts, 1.0 / self.n_hosts)

    # -- topology --------------------------------------------------------------
    def far_hosts(self) -> int:
        return int(round(self.far_fraction * self.n_hosts))

    def far_mask(self) -> np.ndarray:
        """Host h is in the far rack iff h < far_hosts() — a fixed
        assignment shared by the batched kernel and the event reference."""
        return np.arange(self.n_hosts) < self.far_hosts()

    def host_cost_us(self) -> np.ndarray:
        return np.where(self.far_mask(), self.far_cost_us,
                        self.near_cost_us)

    def link_wait_us(self, far_rate_mpps: float) -> float:
        """M/M/1-style mean wait on the shared far-rack link at the given
        far-rack arrival rate, clamped near saturation."""
        if self.link_rate_mpps <= 0.0 or self.far_hosts() == 0:
            return 0.0
        gap = max(self.link_rate_mpps - far_rate_mpps,
                  (1.0 - _LINK_UTIL_CLAMP) * self.link_rate_mpps)
        return 1.0 / gap

    def mean_topo_delay_us(self, fleet_rate_mpps: float) -> float:
        """Traffic-weighted mean network delay per packet at the given
        fleet aggregate rate — the share of the latency budget the
        network consumes before any host-level tuning can help (used by
        calibration's fleet pass-through to shrink the host target)."""
        shares = self.shares()
        far = self.far_mask()
        far_rate = float(fleet_rate_mpps * shares[far].sum())
        per_host = self.host_cost_us() + far * self.link_wait_us(far_rate)
        return float((shares * per_host).sum())


@dataclass
class EngineSetup:
    """Normalized run inputs an engine starts from: seeded rng, resolved
    dispatcher/assignment, thread slots, the distinct policy objects
    behind them (already ``reset()``), and the workload — schedule-
    wrapped when the config carries a ``LoadSchedule``."""

    rng: np.random.Generator
    n_queues: int
    dispatcher: object
    assignment: object
    slots: list
    policies: list
    workload: object = None


def scheduled_workload(workload, cfg: SimRunConfig):
    """Apply ``cfg.schedule`` to ``workload`` (idempotent: a workload
    already wrapped with the *same* schedule passes through so callers
    can pre-wrap; a pre-wrap carrying a *different* schedule raises —
    silently running one schedule while stamping another on the stats
    would poison every tracking consumer downstream)."""
    from .workload import ScheduledWorkload

    if isinstance(workload, ScheduledWorkload):
        if cfg.schedule is not None and workload.schedule != cfg.schedule:
            raise ValueError(
                "workload is already wrapped with schedule "
                f"{workload.schedule.descriptor()!r} but cfg.schedule is "
                f"{cfg.schedule.descriptor()!r}; pass the bare workload "
                "or make the schedules match")
        return workload
    if cfg.schedule is None:
        return workload
    return ScheduledWorkload(workload, cfg.schedule)


def prepare_run(policy, workload, cfg: SimRunConfig, *,
                dispatcher=None, assignment=None) -> EngineSetup:
    """Resolve defaults and reset all run-scoped state, identically for
    every engine: apply the config's load schedule to the workload, seed
    the rng, reset the workload, resolve the dispatcher and assignment,
    expand the policy into thread slots, and reset each distinct policy
    object exactly once (shared slots alias one policy; dedicated slots
    carry per-queue clones)."""
    workload = scheduled_workload(workload, cfg)
    rng = np.random.default_rng(cfg.seed)
    workload.reset(rng)
    nq = max(int(cfg.n_queues), 1)
    dispatcher = dispatcher or RoundRobinDispatch()
    dispatcher.reset(nq, rng)
    assignment = assignment or SharedAssignment()
    slots = assignment.slots(policy, nq)
    policies, seen = [], set()
    for s in slots:
        if id(s.policy) not in seen:
            seen.add(id(s.policy))
            policies.append(s.policy)
    for p in policies:
        p.reset()
    return EngineSetup(rng=rng, n_queues=nq, dispatcher=dispatcher,
                       assignment=assignment, slots=slots,
                       policies=policies, workload=workload)


class WindowAccum:
    """Serial-engine side of the windowed adaptation series: raw
    per-window sums accumulated at event time, assembled into the same
    ``WindowedSeries`` the batched engine emits (so
    ``TrackingStats`` is one code path across backends).

    Inactive (every call a no-op) when ``cfg.window_us == 0`` — the
    engines call unconditionally and pay nothing on stationary runs.

    Contributions at event times past ``duration_us`` (the event
    engine's final-drain pass) go to the ``spill_*`` scalars, NOT the
    last window: the batched in-scan accumulator never runs past
    duration, so clamping drain events into the last window would skew
    windowed parity one-sidedly while silently dropping them would
    break the windows-sum-to-totals conservation law.
    """

    __slots__ = ("window_us", "duration_us", "n", "offered", "served",
                 "lat_area", "awake", "energy", "rho_sum", "rho_cnt",
                 "ts_sum", "samples", "spill_offered", "spill_served",
                 "spill_lat_area", "spill_awake", "spill_energy")

    def __init__(self, cfg: SimRunConfig):
        self.window_us = float(cfg.window_us)
        self.duration_us = float(cfg.duration_us)
        self.n = (int(np.ceil(cfg.duration_us / cfg.window_us))
                  if cfg.window_us > 0 else 0)
        n = max(self.n, 1)
        self.offered = np.zeros(n)
        self.served = np.zeros(n)
        self.lat_area = np.zeros(n)
        self.awake = np.zeros(n)
        self.energy = np.zeros(n)
        self.rho_sum = np.zeros(n)
        self.rho_cnt = np.zeros(n)
        self.ts_sum = np.zeros(n)
        self.samples: list[list[float]] = [[] for _ in range(n)]
        self.spill_offered = 0.0
        self.spill_served = 0.0
        self.spill_lat_area = 0.0
        self.spill_awake = 0.0
        self.spill_energy = 0.0

    def _idx(self, t_us: float) -> int:
        return min(max(int(t_us / self.window_us), 0), self.n - 1)

    def add(self, t_us: float, *, offered=0.0, served=0.0, lat_area=0.0,
            awake=0.0, energy_uj=0.0) -> None:
        if not self.n:
            return
        if t_us >= self.duration_us:
            self.spill_offered += offered
            self.spill_served += served
            self.spill_lat_area += lat_area
            self.spill_awake += awake
            self.spill_energy += energy_uj
            return
        i = self._idx(t_us)
        self.offered[i] += offered
        self.served[i] += served
        self.lat_area[i] += lat_area
        self.awake[i] += awake
        self.energy[i] += energy_uj

    def control(self, t_us: float, rho: float, ts_us: float) -> None:
        """One controller sample (rho estimate + current T_S) — call on
        each primary wake; NaN rho (no estimator) and post-duration
        (final-drain) samples are skipped."""
        if not self.n or not np.isfinite(rho) or t_us >= self.duration_us:
            return
        i = self._idx(t_us)
        self.rho_sum[i] += rho
        self.rho_cnt[i] += 1
        self.ts_sum[i] += ts_us

    def latency_samples(self, t_us: float, values) -> None:
        if not self.n or t_us >= self.duration_us:
            return
        self.samples[self._idx(t_us)].extend(values)

    def series(self, cfg: SimRunConfig) -> WindowedSeries | None:
        if not self.n:
            return None
        p99 = np.full(self.n, np.nan)
        for i, s in enumerate(self.samples):
            if s:
                p99[i] = float(np.percentile(np.asarray(s), 99))
        return WindowedSeries(
            window_us=self.window_us,
            service_rate_mpps=cfg.service_rate_mpps,
            offered=self.offered, served=self.served,
            lat_area_us=self.lat_area, awake_us=self.awake,
            energy_uj=self.energy,
            rho_sum=self.rho_sum, rho_cnt=self.rho_cnt,
            ts_sum=self.ts_sum, p99_latency_us=p99,
            spill_offered=self.spill_offered,
            spill_served=self.spill_served,
            spill_lat_area_us=self.spill_lat_area,
            spill_awake_us=self.spill_awake,
            spill_energy_uj=self.spill_energy)


def queue_reservoirs(cfg: SimRunConfig, n_queues: int) -> list[Reservoir]:
    """One latency reservoir per Rx queue, each with an independently
    derived seed (``SeedSequence.spawn``) so eviction choices are
    decorrelated across queues — seeding every queue's reservoir with the
    same default seed would correlate which samples survive once the
    reservoirs overflow."""
    seeds = np.random.SeedSequence(cfg.seed).spawn(n_queues)
    return [Reservoir(cfg.latency_reservoir,
                      seed=int(ss.generate_state(1)[0]))
            for ss in seeds]
