"""Deprecated shim: the discrete-event simulator lives in ``repro.runtime``.

The engine (``repro.runtime.sim.simulate_run``) now executes any
``RetrievalPolicy`` against any ``Workload``; this module keeps the
original paper-specific surface — ``SimConfig`` (one flat dataclass of
paper knobs), ``SimResult``, ``simulate``, ``simulate_busy_poll`` — as a
thin translation layer:

    SimConfig(adaptive=..., equal_timeouts=...)  ->  MetronomePolicy /
                                                     EqualTimeoutsPolicy
    SimConfig(arrival_rate_mpps / arrival_profile) -> PoissonWorkload
    everything else                              ->  SimRunConfig

Prefer the new API for new code:

    from repro_torch.runtime import MetronomePolicy, PoissonWorkload, simulate_run
    stats = simulate_run(MetronomePolicy(cfg), PoissonWorkload(14.88))
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.runtime.policy import EqualTimeoutsPolicy, MetronomePolicy
from repro_torch.runtime.sim import (
    HR_SLEEP_MODEL,
    NANOSLEEP_MODEL,
    PERFECT_SLEEP_MODEL,
    SimRunConfig,
    SleepModel,
    simulate_run,
)
from repro_torch.runtime.stats import RunStats
from repro_torch.runtime.workload import PoissonWorkload

from .controller import MetronomeConfig

__all__ = [
    "SleepModel",
    "HR_SLEEP_MODEL",
    "NANOSLEEP_MODEL",
    "PERFECT_SLEEP_MODEL",
    "SimConfig",
    "SimResult",
    "simulate",
    "simulate_busy_poll",
]


@dataclass(frozen=True)
class SimConfig:
    """Legacy flat knob set (paper Sec 5 defaults) — see module docstring."""

    m: int = 3
    arrival_rate_mpps: float = 14.88          # lambda  (packets / us)
    service_rate_mpps: float = 29.76          # mu      (packets / us)
    queue_capacity: int = 1024                # Rx descriptors (paper default)
    duration_us: float = 1_000_000.0
    v_target_us: float = 10.0                 # V-bar
    t_long_us: float = 500.0                  # T_L
    alpha: float = 0.125                      # EWMA (Eq 10)
    adaptive: bool = True                     # Eq 12 on/off (off => T_S = V-bar)
    equal_timeouts: bool = False              # T_L := T_S (Fig 5/7 scenarios)
    sleep_model: SleepModel = HR_SLEEP_MODEL
    wake_cost_us: float = 1.0                 # poll+return CPU cost per wake
    interference_prob: float = 0.0
    interference_mean_us: float = 0.0
    stall_rate_per_us: float = 0.0
    stall_mean_us: float = 0.0
    arrival_profile: Callable[[float], float] | None = None
    seed: int = 0
    ts_min_us: float = 1.0
    timeseries_bin_us: float = 0.0            # >0: emit binned time series

    # -- new-API decomposition -------------------------------------------------
    def policy(self):
        mcfg = MetronomeConfig(m=self.m, v_target_us=self.v_target_us,
                               t_long_us=self.t_long_us, alpha=self.alpha,
                               ts_min_us=self.ts_min_us)
        cls = EqualTimeoutsPolicy if self.equal_timeouts else MetronomePolicy
        return cls(mcfg, adaptive=self.adaptive)

    def workload(self) -> PoissonWorkload:
        return PoissonWorkload(self.arrival_rate_mpps,
                               profile=self.arrival_profile)

    def run_config(self) -> SimRunConfig:
        return SimRunConfig(
            duration_us=self.duration_us,
            service_rate_mpps=self.service_rate_mpps,
            queue_capacity=self.queue_capacity,
            sleep_model=self.sleep_model,
            wake_cost_us=self.wake_cost_us,
            interference_prob=self.interference_prob,
            interference_mean_us=self.interference_mean_us,
            stall_rate_per_us=self.stall_rate_per_us,
            stall_mean_us=self.stall_mean_us,
            seed=self.seed,
            timeseries_bin_us=self.timeseries_bin_us,
        )


@dataclass
class SimResult:
    vacations_us: np.ndarray
    busies_us: np.ndarray
    n_v: np.ndarray                     # backlog found at each busy start
    offered: int
    dropped: int
    serviced: int
    busy_tries: int
    wakeups: int
    cpu_fraction: float                 # total awake time / duration (sums threads)
    mean_latency_us: float
    p99_latency_us: float
    worst_latency_us: float
    rho_series: np.ndarray = field(default_factory=lambda: np.empty(0))
    ts_series: np.ndarray = field(default_factory=lambda: np.empty(0))
    tput_series_mpps: np.ndarray = field(default_factory=lambda: np.empty(0))
    offered_series_mpps: np.ndarray = field(default_factory=lambda: np.empty(0))
    series_t_us: np.ndarray = field(default_factory=lambda: np.empty(0))

    @property
    def loss_fraction(self) -> float:
        return self.dropped / max(self.offered, 1)

    @property
    def mean_vacation_us(self) -> float:
        return float(np.mean(self.vacations_us)) if self.vacations_us.size else 0.0

    @property
    def mean_busy_us(self) -> float:
        return float(np.mean(self.busies_us)) if self.busies_us.size else 0.0

    @property
    def mean_nv(self) -> float:
        return float(np.mean(self.n_v)) if self.n_v.size else 0.0

    @classmethod
    def from_run_stats(cls, rs: RunStats) -> "SimResult":
        return cls(
            vacations_us=rs.vacations_us, busies_us=rs.busies_us, n_v=rs.n_v,
            offered=rs.offered, dropped=rs.dropped, serviced=rs.items,
            busy_tries=rs.busy_tries, wakeups=rs.wakeups,
            cpu_fraction=rs.cpu_fraction,
            mean_latency_us=rs.mean_latency_us,
            p99_latency_us=rs.p99_latency_us,
            worst_latency_us=rs.worst_latency_us,
            rho_series=rs.rho_series, ts_series=rs.ts_series,
            tput_series_mpps=rs.tput_series_mpps,
            offered_series_mpps=rs.offered_series_mpps,
            series_t_us=rs.series_t_us,
        )


def simulate(cfg: SimConfig) -> SimResult:
    rs = simulate_run(cfg.policy(), cfg.workload(), cfg.run_config())
    return SimResult.from_run_stats(rs)


def simulate_busy_poll(cfg: SimConfig) -> SimResult:
    """Baseline: classic DPDK continuous polling (paper Listing 1)."""
    from repro_torch.runtime.policy import BusyPollPolicy

    rs = simulate_run(BusyPollPolicy(), cfg.workload(), cfg.run_config())
    return SimResult.from_run_stats(rs)
