"""Fleet-scale batched simulation: N Metronome hosts in one kernel launch.

The port's counterpart of ``repro.runtime.fleet``.  The batched engine
(``batched``) runs a ``SweepGrid`` of single-host operating points; this
module adds the *host* axis on top: a ``FleetGrid`` stacks ``n_hosts``
replica hosts per sweep point and runs the single-host slot dynamics on
every host, with three fleet-level stages around the per-host body (the
reference's docstring, ``src/repro/runtime/fleet.py:1-61``, gives the
model): the load balancer (``uniform``, ``weighted`` or a stale
``least-loaded`` softmin), the topology's rack costs and bottleneck-link
wait (charged to ``topo_area``, never to the host queues), and fluid
hedged requests duplicated onto the least-loaded other host (counted in
``hedge_dup``, not in ``offered``).  ``FleetStats`` rolls the hosts up
through ``RunStats`` and scores tails with ``hedged_latency_quantile``.

The whole (point x host) sweep runs in ONE launch of the hand-written CUDA
kernel ``repro_torch.kernels.fleet_sweep`` (one block a point, its hosts
across the block's threads, the cross-host stages as block reductions), or
in its plain PyTorch version with ``device="cpu"``.

What differs from the reference:

  - the noise comes from the fixed-slot sweep's Philox contract
    (``repro_torch.kernels.slot_sweep.philox``); the per-host rule is the
    reference's: host ``h`` of a point seeded ``s`` keys as seed ``s + h``
    (low word ``(lo + h) mod 2**32``), so under uniform round-robin with
    topology and hedging off host ``h`` IS the port's single-host
    ``simulate_batch`` at ``rate/H`` seeded ``s + h``, bit for bit;
  - sums over a point's hosts run in the kernel's one stated order
    (``kernels/fleet_sweep/ops.py``), not XLA's;
  - ``device`` picks where the sweep runs: CUDA (the default) launches the
    kernel or raises, ``"cpu"`` runs its plain version;
  - one device runs the whole sweep: ``shard`` is accepted and means what
    it means in the reference with one device visible (no split), and
    ``FleetStats.backend`` names what ran (``"fleet_sweep"``, the kernel,
    or ``"plain"``);
  - ``stepping="adaptive"`` (the event-jump fleet sweep) is not ported yet
    and raises ``NotImplementedError``;
  - nothing is compiled per shape, so the reference's ``CompileCache`` has
    no counterpart: the kernel is built once, at first use, and the slot
    loop stops at the run's duration, so ``bucket_steps`` only bounds it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.fleet_sweep import FleetParams, fleet_sweep
from ..kernels.fleet_sweep.ops import STAT_NAMES
from .batched import SweepGrid, sweep_inputs, validate_batched_config
from .simcore import FleetConfig, SimRunConfig
from .stats import Reservoir, RunStats, hedged_latency_quantile

__all__ = ["FleetGrid", "FleetStats", "simulate_fleet"]

_LB_CODE = {"uniform": 0, "weighted": 1, "least-loaded": 2}


@dataclass(frozen=True)
class FleetGrid:
    """A flat batch of fleet operating points.

    ``grid`` holds the per-host knobs (T_S, T_L, M, n_queues, seed) and
    the FLEET-AGGREGATE offered rate per point (``rate_mpps`` is what
    the balancer receives; each host sees its share).  ``fleet`` is the
    shared environment (host count, LB policy, topology) and
    ``hedge_deadline_us`` is a per-point operating knob — it is a
    *traced* kernel input, so one compilation sweeps hedge deadlines
    next to (T_S, T_L, M) without re-tracing.
    """

    grid: SweepGrid
    fleet: FleetConfig
    hedge_deadline_us: np.ndarray     # (len(grid),); <= 0 disables
    shape: tuple = ()

    @classmethod
    def product(cls, *, fleet: FleetConfig, t_s_us, t_l_us, rate_mpps,
                m=(3,), n_queues=(1,), seeds=(0,),
                hedge_deadline_us=(0.0,), schedules=None) -> "FleetGrid":
        """Dense cartesian grid with a trailing hedge-deadline axis on
        top of ``SweepGrid.product``'s axes (``rate_mpps`` entries are
        fleet aggregates)."""
        fleet.validate()
        base = SweepGrid.product(t_s_us=t_s_us, t_l_us=t_l_us,
                                 rate_mpps=rate_mpps, m=m,
                                 n_queues=n_queues, seeds=seeds,
                                 schedules=schedules)
        hedge = np.atleast_1d(np.asarray(hedge_deadline_us,
                                         dtype=np.float64))
        nh = hedge.size
        shape = base.shape + (nh,)
        grid = SweepGrid(
            t_s_us=np.repeat(base.t_s_us, nh),
            t_l_us=np.repeat(base.t_l_us, nh),
            m=np.repeat(base.m, nh),
            n_queues=np.repeat(base.n_queues, nh),
            rate_mpps=np.repeat(base.rate_mpps, nh),
            seed=np.repeat(base.seed, nh),
            shape=shape,
            schedules=(tuple(s for s in base.schedules
                             for _ in range(nh))
                       if base.schedules else ()))
        return cls(grid=grid, fleet=fleet,
                   hedge_deadline_us=np.tile(hedge, len(base)),
                   shape=shape)

    @classmethod
    def of_points(cls, points, *, fleet: FleetConfig) -> "FleetGrid":
        """Arbitrary point list; each dict takes ``SweepGrid`` keys plus
        an optional ``hedge_deadline_us`` (default 0 = no hedging)."""
        fleet.validate()
        pts = list(points)
        base = SweepGrid.of_points(pts)
        hedge = np.asarray([p.get("hedge_deadline_us", 0.0) for p in pts],
                           dtype=np.float64)
        return cls(grid=base, fleet=fleet, hedge_deadline_us=hedge,
                   shape=(len(pts),))

    def __len__(self) -> int:
        return len(self.grid)

    def point(self, i: int) -> dict:
        d = self.grid.point(i)
        d["hedge_deadline_us"] = float(self.hedge_deadline_us[i])
        d["n_hosts"] = self.fleet.n_hosts
        d["lb"] = self.fleet.lb
        return d


@dataclass
class FleetStats:
    """Per-(point, host) results of one fleet sweep.

    All arrays are float64 of shape ``(len(fgrid), n_hosts)``.  Fleet-
    level metrics reduce over the host axis; tail quantiles come from
    the hedged-tail closed form on the per-host measured means (the
    slot engine keeps no samples).  ``reshaped(name)`` appends the host
    axis to the grid's logical shape.
    """

    fgrid: FleetGrid
    cfg: SimRunConfig
    slot_us: float
    backend: str = "vmap"           # "vmap" | "shard_map(n)"
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
    ts_arms: np.ndarray = field(default_factory=lambda: np.empty(0))
    energy_uj: np.ndarray = field(default_factory=lambda: np.empty(0))
    topo_area: np.ndarray = field(default_factory=lambda: np.empty(0))
    hedge_dup: np.ndarray = field(default_factory=lambda: np.empty(0))
    # stepping diagnostics (see BatchStats): which kernel ran, its
    # compiled scan length, and per-POINT live/forced step counts and
    # exact simulated time (host axis shares one dt, so these are (P,))
    stepping: str = "fixed"
    scan_len: int = 0
    n_steps: np.ndarray = field(default_factory=lambda: np.empty(0))
    forced_steps: np.ndarray = field(default_factory=lambda: np.empty(0))
    sim_time_us: np.ndarray = field(default_factory=lambda: np.empty(0))

    # -- derived ---------------------------------------------------------------
    @property
    def n_hosts(self) -> int:
        return self.fgrid.fleet.n_hosts

    @property
    def host_mean_latency_us(self) -> np.ndarray:
        """(P, H) end-to-end mean sojourn per host: Little's-law host
        component plus the network delay charged to its packets."""
        return ((self.lat_area + self.topo_area)
                / np.maximum(self.serviced, 1.0))

    @property
    def host_weight(self) -> np.ndarray:
        """(P, H) served-traffic share per host (tail-mixture weights)."""
        tot = np.maximum(self.serviced.sum(axis=1, keepdims=True), 1.0)
        return self.serviced / tot

    @property
    def host_cpu_fraction(self) -> np.ndarray:
        return self.awake_us / self.cfg.duration_us

    @property
    def total_cpu_cores(self) -> np.ndarray:
        """(P,) cores burned by the whole fleet (the verdict metric —
        a busy-poll fleet pins n_hosts cores)."""
        return self.awake_us.sum(axis=1) / self.cfg.duration_us

    @property
    def host_power_w(self) -> np.ndarray:
        """(P, H) mean package power per host."""
        return self.energy_uj / self.cfg.duration_us

    @property
    def total_energy_uj(self) -> np.ndarray:
        """(P,) cluster energy (the power half of the verdict metric)."""
        return self.energy_uj.sum(axis=1)

    @property
    def energy_per_packet_nj(self) -> np.ndarray:
        """(P,) cluster energy per served packet."""
        return (1e3 * self.energy_uj.sum(axis=1)
                / np.maximum(self.serviced.sum(axis=1), 1.0))

    @property
    def mean_latency_us(self) -> np.ndarray:
        """(P,) fleet mean end-to-end sojourn (served-weighted)."""
        return ((self.lat_area + self.topo_area).sum(axis=1)
                / np.maximum(self.serviced.sum(axis=1), 1.0))

    @property
    def loss_fraction(self) -> np.ndarray:
        return (self.dropped.sum(axis=1)
                / np.maximum(self.offered.sum(axis=1), 1.0))

    @property
    def offered_total(self) -> np.ndarray:
        return self.offered.sum(axis=1)

    @property
    def offered_with_hedges(self) -> np.ndarray:
        """(P,) offered load including hedge duplicates — strictly
        increasing as the hedge deadline tightens (the cost side of the
        hedging sanity test)."""
        return (self.offered + self.hedge_dup).sum(axis=1)

    @property
    def rho(self) -> np.ndarray:
        """(P,) per-host utilization at uniform split."""
        return (self.fgrid.grid.rate_mpps
                / (self.cfg.service_rate_mpps * self.n_hosts))

    def quantile(self, i: int, q: float = 0.999) -> float:
        """Fleet latency quantile of point ``i`` from the hedged-tail
        closed form on the measured per-host means, with the config's
        correlated-stall environment as the tail component."""
        tail_prob = min(self.cfg.stall_rate_per_us
                        * self.cfg.stall_mean_us, 0.5)
        return hedged_latency_quantile(
            q, self.host_mean_latency_us[i], self.host_weight[i],
            hedge_deadline_us=float(self.fgrid.hedge_deadline_us[i]),
            tail_prob=tail_prob,
            tail_scale_us=self.cfg.stall_mean_us)

    @property
    def p999_latency_us(self) -> np.ndarray:
        return np.asarray([self.quantile(i, 0.999)
                           for i in range(len(self))])

    def reshaped(self, name: str) -> np.ndarray:
        val = np.asarray(getattr(self, name))
        shape = self.fgrid.shape or (len(self),)
        if val.ndim == 2:
            return val.reshape(shape + (self.n_hosts,))
        return val.reshape(shape)

    # -- RunStats rollups ------------------------------------------------------
    def host_run_stats(self, i: int) -> list[RunStats]:
        """One ``RunStats`` per host for point ``i`` (host-level view;
        latency override mean includes the host's network share)."""
        p = self.fgrid.point(i)
        out = []
        for h in range(self.n_hosts):
            mean = float(self.host_mean_latency_us[i, h])
            cap = self.cfg.queue_capacity * max(int(p["n_queues"]), 1)
            out.append(RunStats(
                backend="fleet",
                policy=(f"sleepwake(t_s={p['t_s_us']:g},"
                        f"t_l={p['t_l_us']:g},m={p['m']})"),
                workload=(f"fleet-share({p['rate_mpps']:g}mpps"
                          f"/{self.n_hosts})"),
                wakeups=int(self.wakeups[i, h]),
                cycles=int(self.cycles[i, h]),
                busy_tries=int(self.busy_tries[i, h]),
                items=int(self.serviced[i, h]),
                offered=int(self.offered[i, h]),
                dropped=int(self.dropped[i, h]),
                awake_ns=round(self.awake_us[i, h] * 1e3),
                started_ns=0,
                stopped_ns=round(self.cfg.duration_us * 1e3),
                latency_us=Reservoir(4, seed=int(p["seed"]) + h),
                latency_area_us=float(self.lat_area[i, h]
                                      + self.topo_area[i, h]),
                energy_uj=float(self.energy_uj[i, h]),
                latency_override={
                    "mean": mean,
                    "p99": mean * 3.0,
                    "worst": float(cap / self.cfg.service_rate_mpps
                                   + p["t_l_us"]),
                },
            ))
        return out

    def to_run_stats(self, i: int) -> RunStats:
        """Cluster rollup of point ``i``: n-way ``RunStats.merge_all``
        over the per-host stats, with the fleet-level hedged-tail p99
        replacing the per-host heuristic."""
        hosts = self.host_run_stats(i)
        head = hosts[0]
        head.merge_all(hosts[1:])
        head.latency_override["p99"] = self.quantile(i, 0.99)
        return head

    def __len__(self) -> int:
        return len(self.fgrid)


def fleet_inputs(fgrid: FleetGrid, cfg: SimRunConfig, slot_us: float,
                 device) -> tuple[tuple, object, FleetParams]:
    """The arguments of ``fleet_sweep`` for ``fgrid`` in ``cfg`` on
    ``device``: the per-point columns (T_S, T_L, M, n_queues, the fleet
    rate, the seed's two words, the hedge deadline, the schedule rows or
    ``None``), the sweep's ``SweepParams`` (no windows: the fleet keeps
    none) and the fleet's ``FleetParams``."""
    fleet = fgrid.fleet.validate()
    args, params = sweep_inputs(fgrid.grid, cfg, slot_us, device)
    params = dataclasses.replace(params, n_windows=0, n_win_pad=0, window_us=0.0)
    hedge = torch.as_tensor(np.asarray(fgrid.hedge_deadline_us, dtype=np.float64),
                            device=device).to(torch.float32)
    shares = (tuple(float(w) for w in fleet.shares())
              if fleet.lb != "least-loaded" else ())
    fparams = FleetParams(
        n_hosts=int(fleet.n_hosts), lb_code=_LB_CODE[fleet.lb], shares=shares,
        lb_softness_pkts=float(fleet.lb_softness_pkts),
        stale_every_slots=max(int(round(fleet.lb_stale_us / slot_us)), 1),
        far_count=fleet.far_hosts(), near_cost_us=float(fleet.near_cost_us),
        far_cost_us=float(fleet.far_cost_us), link_rate_mpps=float(fleet.link_rate_mpps))
    return (*args[:7], hedge, *args[7:]), params, fparams


def simulate_fleet(fgrid: FleetGrid, cfg: SimRunConfig | None = None, *,
                   slot_us: float = 0.5, shard: bool | None = None,
                   stepping: str = "fixed", device="cuda") -> FleetStats:
    """Simulate every fleet operating point: ONE launch of the fleet sweep
    kernel over the whole (point x host) batch; no Python loop over hosts.

    ``cfg`` supplies the environment as for ``simulate_batch`` (its windows
    and binned series are not read: the fleet keeps per-host totals); the
    fleet (host count, balancer, topology) and the per-point hedge
    deadlines come from ``fgrid``.  ``shard`` is accepted for the
    reference's signature: the port runs the sweep on ``device`` alone, as
    the reference does with one device visible.  ``stepping="adaptive"``
    (the event-jump fleet sweep) is not ported yet and raises.

    ``device`` (default ``"cuda"``) is where the sweep runs: a CUDA device
    launches the kernel (or raises), ``"cpu"`` runs its plain version.
    """
    if stepping not in ("fixed", "adaptive"):
        raise ValueError(
            f"stepping must be 'fixed' or 'adaptive', got {stepping!r}")
    if stepping == "adaptive":
        raise NotImplementedError(
            "simulate_fleet(stepping='adaptive'), the fleet sweep by event jumps "
            "(S3b), is not ported yet; use stepping='fixed'")
    cfg = cfg or SimRunConfig()
    validate_batched_config(cfg)
    device = resolve_device(device)
    n_pts = len(fgrid)
    args, params, fparams = fleet_inputs(fgrid, cfg, float(slot_us), device)
    out = fleet_sweep(*args, params=params, fleet=fparams)
    vals = {k: out[k].cpu().numpy().astype(np.float64) for k in STAT_NAMES}
    # the reference's float32 step count: live slots, capped by the scan
    dt = np.float32(slot_us)
    n_live = np.minimum(np.ceil(np.float32(cfg.duration_us) * (np.float32(1.0) / dt)),
                        np.float32(params.n_slots))
    return FleetStats(
        fgrid=fgrid, cfg=cfg, slot_us=float(slot_us),
        backend="fleet_sweep" if device.type == "cuda" else "plain",
        stepping=stepping, scan_len=params.n_slots,
        n_steps=np.full(n_pts, float(n_live)),
        forced_steps=np.zeros(n_pts),
        sim_time_us=np.full(n_pts, float(n_live * dt)),
        **vals)
