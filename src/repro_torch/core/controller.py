"""Adaptive Metronome controller — the paper's Sec 4.3 control law.

One ``MetronomeController`` is shared by the M pollers of a queue.  After
every renewal cycle (vacation V followed by busy period B) the finishing
primary calls ``on_cycle_end(B, V)``; the controller updates the EWMA load
estimate (Eq 10) and re-derives the primary timeout T_S from the
constant-vacation-target rule (Eq 12).  Backups always sleep T_L.

A calibrated *feed-forward* term can ride alongside the Eq 10/12 loop: any
object with ``timeouts_us(rho) -> (t_s_us, t_l_us)`` (duck-typed so the
controller doesn't import the calibration layer — in practice an
``repro.runtime.calibrate.OperatingTable`` built from a batched sweep)
maps the EWMA load estimate straight to a pre-validated operating point,
and ``cfg.feedforward_weight`` blends it with the analytic Eq 12 timeout
(1.0 = trust the table, 0.0 = pure paper behavior).  Eq 10 still supplies
rho either way; the table replaces only the rho -> T_S mapping, which is
exactly the part the closed form gets wrong when sleep overshoot / role
churn matter.

The controller is deliberately lock-free-ish: rho/T_S are plain Python
floats updated by whichever thread ends a cycle; stale reads by other
threads are harmless (the control law is a fixed point, and the paper's own
threads race the same way).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import analytics

__all__ = ["MetronomeConfig", "MetronomeController"]


@dataclass(frozen=True)
class MetronomeConfig:
    """Tuning knobs, defaults = the paper's evaluation settings (Sec 5)."""

    m: int = 3                   # deployed pollers (paper: 3)
    v_target_us: float = 10.0    # constant vacation target V-bar (paper: 10us)
    t_long_us: float = 500.0     # backup timeout T_L (paper: 500us)
    alpha: float = 0.125         # EWMA smoothing for rho (Eq 10)
    rho_init: float = 0.5
    ts_min_us: float = 1.0       # clamp: never spin faster than 1us cadence
    ts_max_us: float | None = None  # default M * v_target (the rho->0 limit)
    # weight of the calibrated feed-forward timeout when an operating
    # table is installed (0.0 = ignore it, 1.0 = replace Eq 12 with it)
    feedforward_weight: float = 1.0
    # record the (cycle, rho, T_S, T_L) trajectory on every cycle end —
    # the control-plane trace adaptation studies compare feed-forward vs
    # pure-Eq-12 behavior on (bounded; off by default: the hot path
    # should not grow a list per cycle unless asked to)
    record_trajectory: bool = False
    trajectory_cap: int = 65_536

    def resolved_ts_max(self) -> float:
        return self.ts_max_us if self.ts_max_us is not None else self.m * self.v_target_us


@dataclass
class MetronomeController:
    cfg: MetronomeConfig = field(default_factory=MetronomeConfig)
    # calibrated feed-forward: any object with timeouts_us(rho) ->
    # (t_s_us, t_l_us), e.g. repro.runtime.calibrate.OperatingTable
    feedforward: object | None = None

    def __post_init__(self) -> None:
        self.rho: float = self.cfg.rho_init
        self.t_long_us: float = float(self.cfg.t_long_us)
        self.t_short_us: float = self._derive_ts()
        self.cycles: int = 0
        # (cycle, rho, t_s_us, t_l_us) per on_cycle_end when
        # cfg.record_trajectory — the rho/T_S trace that lets
        # feed-forward and pure-Eq-12 control be compared point by point
        self.trajectory: list[tuple[int, float, float, float]] = []

    def _derive_ts(self) -> float:
        """rho -> T_S: Eq 12, blended with the calibrated table if one
        is installed (both clamped to the configured band)."""
        ts = float(
            analytics.adaptive_ts(
                self.cfg.v_target_us, self.rho, self.cfg.m,
                ts_min=self.cfg.ts_min_us, ts_max=self.cfg.resolved_ts_max(),
            )
        )
        tl = float(self.cfg.t_long_us)
        if self.feedforward is not None:
            w = min(max(self.cfg.feedforward_weight, 0.0), 1.0)
            ts_ff, tl_ff = self.feedforward.timeouts_us(self.rho)
            ts = (1.0 - w) * ts + w * float(ts_ff)
            tl = (1.0 - w) * self.cfg.t_long_us + w * float(tl_ff)
            # table points are pre-validated against the latency target,
            # so only the safety floor applies (the Eq-12 upper clamp
            # would undo the table's low-load CPU savings)
            ts = max(ts, self.cfg.ts_min_us)
        # T_L >= T_S, always: the role split only works if backups fire
        # *after* primaries.  A calibrated table rung (or a pathological
        # config) with T_L below the derived T_S would invert the
        # backup/primary timeouts, so the backup timeout rises to meet
        # T_S (re-derived each cycle, so it falls back once T_S does).
        self.t_long_us = max(tl, ts)
        return ts

    # -- control-plane updates ------------------------------------------------
    def on_cycle_end(self, busy_us: float, vacation_us: float) -> float:
        """Feed one (B, V) observation; returns the new T_S in us."""
        self.rho = float(
            analytics.ewma_rho(self.rho, busy_us, vacation_us, self.cfg.alpha)
        )
        self.t_short_us = self._derive_ts()
        self.cycles += 1
        if (self.cfg.record_trajectory
                and len(self.trajectory) < self.cfg.trajectory_cap):
            self.trajectory.append((self.cycles, self.rho,
                                    self.t_short_us, self.t_long_us))
        return self.t_short_us

    # -- data-plane reads -----------------------------------------------------
    def timeout_us(self, *, primary: bool) -> float:
        """Paper Listing 2 lines 11-14: T_S for primaries, T_L for backups."""
        return self.t_short_us if primary else self.t_long_us

    def timeout_ns(self, *, primary: bool) -> int:
        return int(self.timeout_us(primary=primary) * 1_000)
