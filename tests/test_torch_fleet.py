"""The port's fleet sweep: the ``fleet_sweep`` kernel's module and
``simulate_fleet(stepping="fixed")`` of ``repro_torch.runtime`` on the CPU,
where ``fleet_sweep`` runs its plain version
(``kernels/fleet_sweep/ops.py:reference_fleet_sweep``), and on the card
(``gpu``).

Exact parity with the reference is held through the noise, as for the
fixed-slot sweep: ``ReplayDraws`` (``test_torch_batched.py``) derives the
reference's threefry draws of every host (host ``h`` of seed ``s`` draws
the stream of seed ``s + h``, ``src/repro/runtime/fleet.py:243-249``) and
feeds them to the plain version, whose results must then be the reference
``simulate_fleet``'s: counters (wakeups, busy tries, cycles, T_S arms)
equal, float sums within 1e-5 relative, for the uniform and weighted
balancers with topology on or off, for least-loaded over 4 hosts, and for
hedging under the uniform balancer.  The sums over a point's hosts run in
the kernel's order and not XLA's (the softmax's denominator, the far
rack's rate, the scatter-add of duplicates), and PyTorch's float32 ``exp``
on the CPU (softmax, hedge gate) is not XLA's; each moves a value by an
ulp.  Least-loaded over 5 hosts with hedging and topology
(``CHAOTIC_CASE``) shows what such an ulp does when it feeds back: the
shares and the duplicates reach every host's queues each slot.  Its
counters stay exact and its sums are held within 3e-2 relative.  The gap
is the reference's own: it sits at one point (m 1, n_queues 2, deadline
20 us), where the port differs from JAX by 8.9e-3 and from JAX with XLA's
fused multiply-add off by 1.2e-2, and the two JAX runs differ from each
other by 3.4e-3; at that point the first ulp differs after 3 live slots,
the gap passes 1e-5 after 2,793 and 1e-4 after 2,891, and grows to
8.9e-3 by slot 3,000.  ``python tests/test_torch_fleet.py`` prints these
readings.

Then the ports of ``tests/test_fleet.py`` (all but its two compile-cache
tests: the port compiles nothing per shape), each on the CPU; where the
reference's duration is too long for the plain version (~10^3-10^4
slots/s here) the duration alone is cut, as each docstring says, and the
assertions are the reference's.  The reference's
``test_fleet_hosts_bit_exact_vs_single_host_batched`` keeps its 30 ms and
holds the port's per-host rule: plain fleet host ``h`` == the plain
fixed-slot sweep at seed ``s + h``, bit for bit."""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_batched import ReplayDraws

from repro.runtime import FleetGrid as RefFleetGrid
from repro.runtime import SimRunConfig as RefConfig
from repro.runtime import SweepGrid as RefGrid
from repro.runtime import simulate_fleet as ref_simulate_fleet
from repro.runtime.schedule import StepSchedule as RefStep
from repro.runtime.simcore import FleetConfig as RefFleetConfig
from repro.runtime.simcore import SleepModel as RefSleepModel
from repro_torch.core import MetronomeConfig
from repro_torch.kernels.fleet_sweep import FleetParams, fleet_sweep, reference_fleet_sweep
from repro_torch.kernels.fleet_sweep.ops import STAT_NAMES, host_lanes, host_sum
from repro_torch.runtime import (
    FleetConfig,
    FleetGrid,
    FleetStats,
    MetronomePolicy,
    Reservoir,
    RunStats,
    SimRunConfig,
    SleepModel,
    StepSchedule,
    SweepGrid,
    fleet_tail_reference,
    hedged_latency_quantile,
    simulate_batch,
    simulate_fleet,
    simulate_fleet_run,
)
from repro_torch.runtime.fleet import fleet_inputs

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
COUNTERS = ("wakeups", "busy_tries", "cycles", "ts_arms")
RTOL = 1e-5
MU = 29.76
NOISY = dict(interference_prob=0.25, interference_mean_us=20.0,
             stall_rate_per_us=1.0 / 400.0, stall_mean_us=150.0)
TAIL_SLEEP = dict(base_us=2.8, slope=0.027, sigma_us=0.5, tail_prob=0.01, tail_mean_us=40.0)

# tests/test_fleet.py's bands (the batched engine's quiet parity bands)
LAT_ABS_US, LAT_REL = 1.5, 0.12
CPU_ABS, CPU_REL = 0.02, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain sweeps' small tensors gain nothing from intra-op threads;
    one keeps a parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fgrid(fleet, *, rate_per_host=0.4 * MU, hedge=(0.0,), seeds=(3,), t_s=12.0):
    return FleetGrid.product(
        fleet=fleet, t_s_us=(t_s,), t_l_us=(500.0,), m=(3,),
        rate_mpps=(rate_per_host * fleet.n_hosts,), seeds=seeds,
        hedge_deadline_us=hedge)


# -- the reference's draws, replayed into the plain version --------------------

def _points(n_hosts, hedges, scheduled, step):
    """Every (m, n_queues) pair in 1..4 x 1..4, knobs drawn from a seed, the
    rates fleet aggregates; hedge deadlines cycle over ``hedges``; with
    ``scheduled`` every other point on a step schedule."""
    rng = np.random.default_rng(1)
    pts = []
    for m in (1, 2, 3, 4):
        for q in (1, 2, 3, 4):
            p = dict(t_s_us=float(rng.uniform(4.0, 40.0)),
                     t_l_us=float(rng.uniform(100.0, 600.0)), m=m, n_queues=q,
                     rate_mpps=float(rng.uniform(0.2, 0.8) * MU * q / 2.0 * n_hosts),
                     seed=int(rng.integers(0, 3)),
                     hedge_deadline_us=hedges[len(pts) % len(hedges)])
            if scheduled and len(pts) % 2:
                p["schedule"] = step(times_us=(0.0, 700.0), scales=(0.4, 1.5))
            pts.append(p)
    return pts


# name -> (FleetConfig kwargs, hedge deadlines, noisy, scheduled); the last
# case (CHAOTIC_CASE) is held to LB_HEDGE_RTOL on its sums, its counters
# exact (the module's docstring says why)
LB_HEDGE_RTOL = 3e-2
CHAOTIC_CASE = "least-loaded, hedged, topology"
PARITY_CASES = {
    "uniform, bottleneck link": (dict(n_hosts=3, far_fraction=1 / 3, near_cost_us=2.0,
                                      far_cost_us=8.0, link_rate_mpps=8.0), (0.0,), True, True),
    "weighted": (dict(n_hosts=4, lb="weighted", host_weights=(4.0, 1.0, 1.0, 2.0)), (0.0,),
                 False, False),
    "weighted, topology": (dict(n_hosts=4, lb="weighted", host_weights=(1.0, 2.0, 1.0, 3.0),
                                far_fraction=0.5, near_cost_us=1.0, far_cost_us=6.0,
                                link_rate_mpps=40.0), (0.0,), True, False),
    "least-loaded": (dict(n_hosts=4, lb="least-loaded", lb_stale_us=50.0), (0.0,), True,
                     True),
    "uniform, hedged": (dict(n_hosts=4), (0.0, 20.0, 80.0), True, False),
    "least-loaded, hedged, topology": (
        dict(n_hosts=5, lb="least-loaded", lb_stale_us=20.0, far_fraction=0.4,
             near_cost_us=2.0, far_cost_us=8.0, link_rate_mpps=30.0), (0.0, 20.0, 80.0),
        True, True),
}


PARITY_US, PARITY_SLOT_US = 1_500.0, 0.5


def _ref_parity_inputs(case, duration_us=PARITY_US):
    """The reference's points and config of a parity case."""
    fkw, hedges, noisy, scheduled = PARITY_CASES[case]
    env = dict(duration_us=duration_us, queue_capacity=64, **(NOISY if noisy else {}))
    ref_cfg = RefConfig(sleep_model=RefSleepModel(**TAIL_SLEEP), **env)
    return _points(fkw["n_hosts"], hedges, scheduled, RefStep), ref_cfg


def _ref_parity_run(case, duration_us=PARITY_US):
    """The reference ``simulate_fleet`` of a parity case: its outputs as
    float64 arrays, and its scan length."""
    ref_pts, ref_cfg = _ref_parity_inputs(case, duration_us)
    fgrid = RefFleetGrid.of_points(ref_pts, fleet=RefFleetConfig(**PARITY_CASES[case][0]))
    ref = ref_simulate_fleet(fgrid, ref_cfg, slot_us=PARITY_SLOT_US, shard=False)
    out = {name: np.asarray(getattr(ref, name), dtype=np.float64) for name in STAT_NAMES}
    return out | {"scan_len": ref.scan_len}


def _port_parity_run(case, duration_us=PARITY_US):
    """Plain S3 on a parity case, fed the reference's per-host draws:
    (outputs, the port's grid, its sweep parameters, its fleet parameters)."""
    fkw, hedges, noisy, scheduled = PARITY_CASES[case]
    n_h = fkw["n_hosts"]
    ref_pts, ref_cfg = _ref_parity_inputs(case, duration_us)
    rows = RefGrid.of_points([dict(p, seed=p["seed"] + h) for p in ref_pts for h in range(n_h)])
    draws = ReplayDraws(rows, ref_cfg, PARITY_SLOT_US, math.ceil(duration_us / PARITY_SLOT_US))
    env = dict(duration_us=duration_us, queue_capacity=64, **(NOISY if noisy else {}))
    cfg = SimRunConfig(sleep_model=SleepModel(**TAIL_SLEEP), **env)
    fgrid = FleetGrid.of_points(_points(n_h, hedges, scheduled, StepSchedule),
                                fleet=FleetConfig(**fkw))
    args, params, fparams = fleet_inputs(fgrid, cfg, PARITY_SLOT_US, CPU)
    out = reference_fleet_sweep(*args, params, fparams, draws)
    return {k: v.double().numpy() for k, v in out.items()}, fgrid, params, fparams


def _gaps(got, want):
    """Per point, the largest gap over every output and host, relative to
    max(|want|, 1)."""
    return np.max([np.max(np.abs(got[k] - want[k]) / np.maximum(np.abs(want[k]), 1.0), axis=1)
                   for k in STAT_NAMES], axis=0)


def _assert_parity(got, want, chaotic):
    for name in STAT_NAMES:
        if name in COUNTERS:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want[name],
                                       rtol=LB_HEDGE_RTOL if chaotic else RTOL, atol=1e-3,
                                       err_msg=name)


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_plain_fleet_sweep_on_replayed_draws_equals_reference(case):
    """Plain S3 fed the reference's per-host draws == JAX ``simulate_fleet``
    over 1,500 us of 0.5 us slots (3,000 live slots of a 3,615-slot scan,
    so the run ends before the bucketed scan does): counters exact, every
    sum (the host ones, ``topo_area`` and ``hedge_dup``) within 1e-5
    relative; least-loaded over 5 hosts with hedging within
    ``LB_HEDGE_RTOL``."""
    ref = _ref_parity_run(case)
    out, fgrid, params, fparams = _port_parity_run(case)
    n_h = fparams.n_hosts
    assert params.live_slots() == 3_000 and params.n_slots == ref["scan_len"] == 3_615
    if fparams.lb_code == 2:       # the snapshot refreshes many times
        assert params.live_slots() // fparams.stale_every_slots >= 2
    assert float(ref["wakeups"].sum()) > 100
    if fparams.topo_on:
        assert float(ref["topo_area"].sum()) > 0.0
    if float(fgrid.hedge_deadline_us.max()) > 0.0:
        assert float(ref["hedge_dup"].sum()) > 0.0
    for name in STAT_NAMES:
        assert out[name].shape == ref[name].shape == (len(fgrid), n_h)
    _assert_parity(out, ref, case == CHAOTIC_CASE)


# the reference run again in a process with XLA's fused multiply-add off
_REF_NO_FMA = """
import sys
import numpy as np
sys.path[:0] = sys.argv[2:4]
import test_torch_fleet as T
np.savez(sys.argv[1], **T._ref_parity_run(T.CHAOTIC_CASE))
"""


def _ref_without_fma(tmp_dir):
    path = tmp_dir / "ref_no_fma.npz"
    flags = (f"{os.environ.get('XLA_FLAGS', '')} --xla_cpu_max_isa=AVX "
             "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1").strip()
    env = {**os.environ, "XLA_FLAGS": flags, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-c", _REF_NO_FMA, str(path), str(ROOT / "src"), str(ROOT / "tests")],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(path))


def test_least_loaded_hedged_case_against_the_reference_without_fma(tmp_path):
    """The chaotic case against the reference run with XLA's fused
    multiply-add off (a subprocess): the port is held to ``LB_HEDGE_RTOL``,
    counters exact, and so is the reference against itself (fma on in this
    process).  ``python tests/test_torch_fleet.py`` prints the readings."""
    no_fma = _ref_without_fma(tmp_path)
    _assert_parity(_port_parity_run(CHAOTIC_CASE)[0], no_fma, True)
    _assert_parity(no_fma, _ref_parity_run(CHAOTIC_CASE), True)


def _first_slot_over(case, point, threshold):
    """The fewest live slots after which the port's outputs at ``point``
    differ from the reference's by more than ``threshold`` (``_gaps``), by
    bisection over the duration, and the outputs that differ there."""
    lo, hi = 1, int(PARITY_US / PARITY_SLOT_US)
    while lo < hi:
        mid = (lo + hi) // 2
        dur = mid * PARITY_SLOT_US
        if _gaps(_port_parity_run(case, dur)[0], _ref_parity_run(case, dur))[point] > threshold:
            hi = mid
        else:
            lo = mid + 1
    dur = lo * PARITY_SLOT_US
    got, want = _port_parity_run(case, dur)[0], _ref_parity_run(case, dur)
    return lo, [k for k in STAT_NAMES if not np.array_equal(got[k][point], want[k][point])]


def witness():
    """The readings behind ``LB_HEDGE_RTOL``: per point of the chaotic case,
    its (m, n_queues, deadline) and the largest gap of the port against the
    reference with XLA's fma on and off, and of the reference against
    itself; then, at the point of the largest gap, the first slot after
    which the port leaves the reference by more than 0, 1e-5 and 1e-4."""
    import tempfile
    torch.set_num_threads(1)
    fma = _ref_parity_run(CHAOTIC_CASE)
    with tempfile.TemporaryDirectory() as tmp:
        no_fma = _ref_without_fma(Path(tmp))
    out, fgrid, _, _ = _port_parity_run(CHAOTIC_CASE)
    pairs = {"port vs JAX fma on": (out, fma), "port vs JAX fma off": (out, no_fma),
             "JAX fma on vs off": (no_fma, fma)}
    gaps = {k: _gaps(*pair) for k, pair in pairs.items()}
    g = fgrid.grid
    for i in range(len(fgrid)):
        print(f"point {i} (m {int(g.m[i])}, n_queues {int(g.n_queues[i])}, deadline "
              f"{float(fgrid.hedge_deadline_us[i]):g} us): "
              + ", ".join(f"{k} {v[i]:.3e}" for k, v in gaps.items()))
    for k, (a, b) in pairs.items():
        exact = all(np.array_equal(a[c], b[c]) for c in COUNTERS)
        print(f"{k}: largest gap {gaps[k].max():.4e} at point {int(gaps[k].argmax())}; "
              f"counters exact: {exact}")
    point = int(gaps["port vs JAX fma on"].argmax())
    for threshold in (0.0, 1e-5, 1e-4):
        n, differ = _first_slot_over(CHAOTIC_CASE, point, threshold)
        print(f"point {point}: past {threshold:g} from live slot {n} on (outputs {differ})")


# -- the kernel's reduction order ----------------------------------------------

def _lane_tree_sum(values: np.ndarray) -> np.float32:
    """The kernel's sum over a point's hosts, written out lane by lane in
    numpy float32: W lanes, each summing its hosts j, j + W, ...; a halving
    tree within each warp of min(W, 32) lanes; then over the warps."""
    n = len(values)
    w = 1
    while w < min(n, 256):
        w *= 2
    lanes = [np.float32(0.0)] * w
    for j in range(w):
        hosts = list(range(j, n, w))
        if hosts:
            s = values[hosts[0]]
            for h in hosts[1:]:
                s = np.float32(s + values[h])
            lanes[j] = s
    width = min(w, 32)
    warps = [lanes[g * width:(g + 1) * width] for g in range(w // width)]
    sums = []
    for lane_vals in warps:
        v = list(lane_vals)
        off = width // 2
        while off:
            v = [np.float32(v[i] + v[i + off]) if i < off else v[i] for i in range(len(v))]
            off //= 2
        sums.append(v[0])
    off = len(sums) // 2
    while off:
        sums = [np.float32(sums[i] + sums[i + off]) if i < off else sums[i]
                for i in range(len(sums))]
        off //= 2
    return sums[0]


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 5, 32, 33, 64, 100, 256, 257, 1000])
def test_host_sum_takes_the_kernels_order(n_hosts):
    rng = np.random.default_rng(n_hosts)
    vals = (rng.standard_normal((3, n_hosts)) * 10.0 ** rng.integers(-3, 4, (3, n_hosts)))
    vals = vals.astype(np.float32)
    got = host_sum(torch.from_numpy(vals))
    want = [_lane_tree_sum(v) for v in vals]
    assert got.dtype == torch.float32
    assert got.tolist() == [float(x) for x in want]


# -- the port's surface ---------------------------------------------------------

def test_cpu_runs_the_plain_version_and_cuda_never_falls_back():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; asked for CUDA where there is none, ``simulate_fleet`` raises."""
    fg = _fgrid(FleetConfig(n_hosts=2), hedge=(20.0,))
    cfg = SimRunConfig(duration_us=200.0)
    launches, by_build = fleet_sweep.launches, dict(fleet_sweep.launches_by_build)
    fs = simulate_fleet(fg, cfg, slot_us=1.0, device="cpu")
    assert fleet_sweep.launches == launches and fleet_sweep.launches_by_build == by_build
    assert isinstance(fs, FleetStats) and fs.backend == "plain" and fs.stepping == "fixed"
    assert fs.serviced.shape == (1, 2) and np.all(fs.serviced > 0)
    np.testing.assert_array_equal(fs.n_steps, [200.0])
    np.testing.assert_array_equal(fs.sim_time_us, [200.0])
    assert fs.scan_len == 247        # bucket_steps(200)
    args, params, fparams = fleet_inputs(fg, cfg, 1.0, CPU)
    plain = reference_fleet_sweep(*args, params, fparams)
    for name in STAT_NAMES:
        np.testing.assert_array_equal(getattr(fs, name), plain[name].double().numpy())
    if not torch.cuda.is_available():
        # the default device is the card: no quiet fall back to the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            simulate_fleet(fg, cfg, slot_us=1.0)
        assert fleet_sweep.launches == launches


def test_stepping_modes():
    fg = _fgrid(FleetConfig(n_hosts=2))
    cfg = SimRunConfig(duration_us=100.0)
    with pytest.raises(NotImplementedError, match="S3b"):
        simulate_fleet(fg, cfg, stepping="adaptive", device="cpu")
    with pytest.raises(ValueError, match="stepping"):
        simulate_fleet(fg, cfg, stepping="magic", device="cpu")


def test_wrapper_checks_its_inputs():
    fg = _fgrid(FleetConfig(n_hosts=3, lb="weighted", host_weights=(1.0, 2.0, 1.0)))
    args, params, fparams = fleet_inputs(fg, SimRunConfig(duration_us=50.0), 0.5, CPU)
    assert fparams.lb_code == 1 and fparams.shares == pytest.approx((0.25, 0.5, 0.25))
    with pytest.raises(ValueError, match="static shares"):
        fleet_sweep(*args, params=params, fleet=FleetParams(n_hosts=3, lb_code=1))
    with pytest.raises(ValueError, match="hedge_d"):
        fleet_sweep(*args[:7], args[7].double(), *args[8:], params=params, fleet=fparams)
    with pytest.raises(ValueError, match="m <= 4"):
        fleet_sweep(args[0], args[1], torch.full_like(args[2], 5), *args[3:], params=params,
                    fleet=fparams)


def test_reduction_lanes():
    assert [host_lanes(h) for h in (1, 2, 3, 4, 33, 64, 256, 257, 1000)] == \
        [1, 2, 4, 4, 64, 64, 256, 256, 256]


# -- tests/test_fleet.py on the port ------------------------------------------

def test_fleet_config_validates():
    with pytest.raises(ValueError):
        FleetConfig(n_hosts=0).validate()
    with pytest.raises(ValueError):
        FleetConfig(n_hosts=2, lb="magic").validate()
    with pytest.raises(ValueError):
        FleetConfig(n_hosts=3, lb="weighted",
                    host_weights=(1.0, 2.0)).validate()
    with pytest.raises(ValueError):
        FleetConfig(n_hosts=2, far_fraction=1.5).validate()
    f = FleetConfig(n_hosts=4, lb="weighted",
                    host_weights=(1.0, 1.0, 2.0, 4.0)).validate()
    assert f.shares() == pytest.approx([0.125, 0.125, 0.25, 0.5])
    assert FleetConfig(n_hosts=4, far_fraction=0.5).far_hosts() == 2


def test_fleet_grid_product_and_points():
    fleet = FleetConfig(n_hosts=8)
    fg = FleetGrid.product(fleet=fleet, t_s_us=(8.0, 16.0),
                           t_l_us=(500.0,), rate_mpps=(40.0,),
                           hedge_deadline_us=(0.0, 25.0))
    assert len(fg) == 4
    assert fg.shape == (2, 1, 1, 1, 1, 1, 2)
    p = fg.point(1)
    assert p["hedge_deadline_us"] == 25.0
    assert p["n_hosts"] == 8 and p["lb"] == "uniform"
    fg2 = FleetGrid.of_points(
        [dict(t_s_us=8.0, t_l_us=500.0, rate_mpps=40.0,
              hedge_deadline_us=30.0),
         dict(t_s_us=16.0, t_l_us=500.0, rate_mpps=40.0)],
        fleet=fleet)
    assert list(fg2.hedge_deadline_us) == [30.0, 0.0]


@pytest.mark.parametrize("shard", [False, True])
def test_fleet_hosts_bit_exact_vs_single_host_batched(shard):
    """Uniform RR, no topology, no hedging: every fleet host replays the
    single-host batched kernel at rate/H with seed s+h, bit for bit (here
    the plain versions of both sweeps; ``shard`` means what the reference
    gives it with one device visible)."""
    H, seed, rate_h = 4, 11, 0.45 * MU
    cfg = SimRunConfig(duration_us=30_000.0)
    fs = simulate_fleet(_fgrid(FleetConfig(n_hosts=H),
                               rate_per_host=rate_h, seeds=(seed,)),
                        cfg, slot_us=1.0, shard=shard, device="cpu")
    bs = simulate_batch(
        SweepGrid.of_points([dict(t_s_us=12.0, t_l_us=500.0, m=3,
                                  rate_mpps=rate_h, seed=seed + h)
                             for h in range(H)]),
        cfg, slot_us=1.0, device="cpu")
    np.testing.assert_array_equal(fs.serviced[0], bs.serviced)
    np.testing.assert_array_equal(fs.lat_area[0], bs.lat_area)
    np.testing.assert_array_equal(fs.awake_us[0], bs.awake_us)
    assert float(fs.topo_area[0].sum()) == 0.0
    assert float(fs.hedge_dup[0].sum()) == 0.0
    # every other sum the two engines share, too
    for name in ("offered", "dropped", "wakeups", "busy_tries", "cycles", "vac_sum", "nv_sum",
                 "ts_arms", "energy_uj"):
        np.testing.assert_array_equal(getattr(fs, name)[0], getattr(bs, name), err_msg=name)


@pytest.mark.slow
@pytest.mark.parametrize("shard", [False, True])
def test_fleet_matches_merged_event_engine_hosts(shard):
    """A uniform-RR fleet of k identical hosts agrees with the n-way
    ``RunStats.merge_all`` of k event-engine runs at rate/k (seeds
    s..s+k-1) within the quiet parity bands."""
    H, seed, rate_h = 4, 5, 0.4 * MU
    cfg = SimRunConfig(duration_us=60_000.0)
    fs = simulate_fleet(_fgrid(FleetConfig(n_hosts=H),
                               rate_per_host=rate_h, seeds=(seed,)),
                        cfg, slot_us=0.5, shard=shard, device="cpu")

    hosts = simulate_fleet_run(
        lambda h: MetronomePolicy(
            MetronomeConfig(m=3, v_target_us=12.0, t_long_us=500.0,
                            ts_min_us=1.0),
            adaptive=False),
        rate_h * H, cfg, FleetConfig(n_hosts=H))
    merged = hosts[0].merge_all(hosts[1:])

    lat_f, lat_e = float(fs.mean_latency_us[0]), merged.mean_sojourn_us
    assert abs(lat_f - lat_e) <= max(LAT_ABS_US, LAT_REL * lat_e), \
        (lat_f, lat_e)
    # both sides' CPU is fleet-total cores (merge sums awake time over
    # hosts at a fixed wall-clock duration)
    cpu_f, cpu_e = float(fs.total_cpu_cores[0]), merged.cpu_fraction
    assert abs(cpu_f - cpu_e) <= H * (CPU_ABS + CPU_REL * cpu_e / H), \
        (cpu_f, cpu_e)
    assert float(fs.loss_fraction[0]) < 1e-3
    assert merged.loss_fraction < 1e-3


@pytest.mark.parametrize("n_points", [1, 6])
def test_shard_path_matches_vmap_path(n_points):
    """shard=True and shard=False produce identical results (including
    when the point count does not divide the device count — padding).
    Cut from 10 ms to 2 ms (the plain version's speed)."""
    fleet = FleetConfig(n_hosts=3)
    fg = FleetGrid.product(
        fleet=fleet, t_s_us=tuple(8.0 + 2.0 * i for i in range(n_points)),
        t_l_us=(400.0,), rate_mpps=(0.4 * MU * 3,),
        hedge_deadline_us=(30.0,))
    cfg = SimRunConfig(duration_us=2_000.0)
    a = simulate_fleet(fg, cfg, slot_us=1.0, shard=False, device="cpu")
    b = simulate_fleet(fg, cfg, slot_us=1.0, shard=True, device="cpu")
    for f in ("serviced", "lat_area", "awake_us", "hedge_dup"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                   rtol=1e-6, atol=1e-3, err_msg=f)


def test_hedging_tightening_deadline_tail_and_cost():
    """On the noisy cluster, tightening the hedge deadline (above the
    drain-time scale) drives p99.9 monotonically down while the offered
    load including duplicates rises strictly — the tail/cost trade.  Cut
    from 30 ms to 6 ms (the plain version's speed)."""
    cfg = SimRunConfig(duration_us=6_000.0, stall_rate_per_us=2.5e-4,
                       stall_mean_us=150.0)
    fs = simulate_fleet(_fgrid(FleetConfig(n_hosts=8),
                               hedge=(0.0, 80.0, 40.0, 20.0)),
                        cfg, slot_us=1.0, device="cpu")
    p999 = fs.p999_latency_us
    offered = fs.offered_with_hedges
    assert np.all(np.diff(p999) <= 1e-9), p999
    assert p999[-1] < 0.5 * p999[0], p999
    assert np.all(np.diff(offered) > 0), offered


def test_hedge_deadline_zero_leaves_dynamics_untouched():
    cfg = SimRunConfig(duration_us=10_000.0)
    a = simulate_fleet(_fgrid(FleetConfig(n_hosts=4), hedge=(0.0,)),
                       cfg, slot_us=1.0, device="cpu")
    b = simulate_fleet(_fgrid(FleetConfig(n_hosts=4), hedge=(-5.0,)),
                       cfg, slot_us=1.0, device="cpu")
    np.testing.assert_array_equal(a.serviced, b.serviced)
    assert float(a.hedge_dup.sum()) == 0.0


def test_hedged_quantile_closed_form_pinned_against_exact_mc():
    """``hedged_latency_quantile`` vs the exact first-completion-wins
    reference on hosts whose latency IS the model's mixture: within 8%
    at p99/p99.9 across the deadline ladder."""
    rng = np.random.default_rng(42)
    H, N = 3, 60_000
    L = np.array([8.0, 12.0, 10.0])
    p, c = 0.05, 120.0
    hosts = []
    for h in range(H):
        tail = rng.random(N) < p
        lat = rng.exponential(L[h], N)
        lat[tail] = rng.exponential(L[h] + c, tail.sum())
        res = Reservoir(capacity=N, seed=h)
        res.extend(lat)
        hosts.append(RunStats(backend="synthetic", items=N, offered=N,
                              awake_ns=int(1e9), latency_us=res))
    fleet = FleetConfig(n_hosts=H)
    for d in (0.0, 150.0, 60.0, 25.0):
        mc = fleet_tail_reference(hosts, fleet, d, n_samples=400_000,
                                  seed=9)
        for q in (0.99, 0.999):
            emp = float(np.percentile(mc, 100 * q))
            ana = hedged_latency_quantile(q, L, hedge_deadline_us=d,
                                          tail_prob=p, tail_scale_us=c)
            assert abs(emp - ana) <= 0.08 * ana, (d, q, emp, ana)


def test_hedged_quantile_monotone_in_deadline():
    means = np.array([9.0, 11.0])
    qs = [hedged_latency_quantile(0.999, means, hedge_deadline_us=d,
                                  tail_prob=0.04, tail_scale_us=150.0)
          for d in (0.0, 200.0, 100.0, 50.0, 25.0)]
    assert all(a >= b - 1e-9 for a, b in zip(qs, qs[1:])), qs


def test_topology_adds_network_delay_without_touching_host_queues():
    """Cut from 20 ms to 5 ms (the plain version's speed)."""
    cfg = SimRunConfig(duration_us=5_000.0)
    flat = simulate_fleet(_fgrid(FleetConfig(n_hosts=4)), cfg, slot_us=1.0, device="cpu")
    topo = simulate_fleet(
        _fgrid(FleetConfig(n_hosts=4, far_fraction=0.5, near_cost_us=2.0,
                           far_cost_us=8.0, link_rate_mpps=60.0)),
        cfg, slot_us=1.0, device="cpu")
    # host-side dynamics are bit-identical: network delay is charged to
    # a separate integral, never to the host queues
    np.testing.assert_array_equal(flat.serviced, topo.serviced)
    np.testing.assert_array_equal(flat.lat_area, topo.lat_area)
    assert float(topo.topo_area.sum()) > 0.0
    # direction and rough size: every packet pays its rack cost, far
    # packets also wait on the link
    added = float(topo.mean_latency_us[0] - flat.mean_latency_us[0])
    assert added > 0.5 * 5.0          # at least half the mean rack cost
    assert added < 50.0


def test_weighted_lb_skew_degrades_vs_uniform():
    """Cut from 20 ms to 5 ms (the plain version's speed)."""
    cfg = SimRunConfig(duration_us=5_000.0)
    H = 4
    uni = simulate_fleet(_fgrid(FleetConfig(n_hosts=H),
                                rate_per_host=0.55 * MU), cfg, slot_us=1.0, device="cpu")
    skew = simulate_fleet(
        _fgrid(FleetConfig(n_hosts=H, lb="weighted",
                           host_weights=(4.0, 1.0, 1.0, 1.0)),
               rate_per_host=0.55 * MU),
        cfg, slot_us=1.0, device="cpu")
    # the hot host saturates: worse fleet mean latency (or real loss)
    assert (float(skew.mean_latency_us[0])
            > float(uni.mean_latency_us[0])
            or float(skew.loss_fraction[0]) > 0.01)


def test_stale_least_loaded_lag_hurts():
    """Cut from 20 ms to 5 ms (the plain version's speed); the stale
    snapshot's 4 ms lag still refreshes twice."""
    cfg = SimRunConfig(duration_us=5_000.0, stall_rate_per_us=2.5e-4,
                       stall_mean_us=150.0)
    fresh = simulate_fleet(
        _fgrid(FleetConfig(n_hosts=4, lb="least-loaded", lb_stale_us=1.0)),
        cfg, slot_us=1.0, device="cpu")
    stale = simulate_fleet(
        _fgrid(FleetConfig(n_hosts=4, lb="least-loaded",
                           lb_stale_us=4_000.0)),
        cfg, slot_us=1.0, device="cpu")
    assert (float(stale.mean_latency_us[0])
            >= float(fresh.mean_latency_us[0]) - 0.5)


def test_fleet_rollup_through_run_stats_merge_all():
    cfg = SimRunConfig(duration_us=10_000.0)
    fs = simulate_fleet(_fgrid(FleetConfig(n_hosts=4)), cfg, slot_us=1.0, device="cpu")
    hosts = fs.host_run_stats(0)
    assert len(hosts) == 4
    rolled = fs.to_run_stats(0)
    assert rolled.items == sum(int(v) for v in fs.serviced[0])
    assert rolled.offered == sum(int(v) for v in fs.offered[0])
    assert rolled.mean_sojourn_us == pytest.approx(
        float(fs.mean_latency_us[0]), rel=1e-3)
    assert rolled.latency_override["p99"] == pytest.approx(
        fs.quantile(0, 0.99))


def test_event_fleet_reference_contract():
    """simulate_fleet_run: per-host seeds s..s+H-1, rates split by the
    static shares; fleet_tail_reference hedging never hurts the tail."""
    fleet = FleetConfig(n_hosts=3, lb="weighted",
                        host_weights=(2.0, 1.0, 1.0))
    cfg = SimRunConfig(duration_us=20_000.0, seed=9)
    hosts = simulate_fleet_run(
        lambda h: MetronomePolicy(MetronomeConfig()), 0.9 * MU, cfg, fleet)
    assert len(hosts) == 3
    items = np.asarray([rs.items for rs in hosts], dtype=np.float64)
    # the 2x-weighted host serves about twice the others' traffic
    assert items[0] / items[1:].mean() == pytest.approx(2.0, rel=0.25)
    unhedged = fleet_tail_reference(hosts, fleet, 0.0, n_samples=50_000,
                                    seed=1)
    hedged = fleet_tail_reference(hosts, fleet, 40.0, n_samples=50_000,
                                  seed=1)
    assert (np.percentile(hedged, 99.9)
            <= np.percentile(unhedged, 99.9) + 1e-9)


# -- on the card ----------------------------------------------------------------

@pytest.mark.gpu
def test_kernel_equals_plain_version_on_the_card():
    """The kernel against its plain version on the card, every output bit
    for bit: each balancer with topology and hedging on, the noise families
    and a schedule, one queue a point (<4, 1>) and up to four (<4, 4>), one
    host, and more hosts than a block has lanes; and the per-host rule
    against the fixed-slot sweep's kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fleet sweep kernel has no CPU mode")
    from repro_torch.kernels.slot_sweep import slot_sweep
    from repro_torch.runtime.batched import sweep_inputs
    cfg = SimRunConfig(duration_us=400.0, sleep_model=SleepModel(**TAIL_SLEEP),
                       queue_capacity=64, **NOISY)
    cases = [(FleetConfig(n_hosts=h, **kw), hedges, sched)
             for h, kw, hedges, sched in (
                 (1, {}, (0.0, 20.0), False),
                 (3, dict(lb="weighted", host_weights=(1.0, 2.0, 3.0), far_fraction=0.34,
                          near_cost_us=1.0, far_cost_us=5.0, link_rate_mpps=10.0),
                  (0.0, 20.0, 80.0), True),
                 (33, dict(lb="least-loaded", lb_stale_us=5.0), (0.0, 20.0), True),
                 (300, dict(lb="least-loaded", lb_stale_us=2.0, far_fraction=0.5,
                            near_cost_us=1.0, far_cost_us=4.0, link_rate_mpps=900.0),
                  (0.0, 80.0), False))]
    for fleet, hedges, sched in cases:
        for one_queue in (True, False):
            pts = _points(fleet.n_hosts, hedges, sched, StepSchedule)
            if one_queue:
                pts = [dict(p, n_queues=1) for p in pts]
            fg = FleetGrid.of_points(pts, fleet=fleet)
            args, params, fparams = fleet_inputs(fg, cfg, 0.5, "cuda")
            launches = fleet_sweep.launches
            out = fleet_sweep(*args, params=params, fleet=fparams)
            assert fleet_sweep.launches == launches + 1
            ref = reference_fleet_sweep(*args, params, fparams)
            for name in STAT_NAMES:
                assert torch.equal(out[name], ref[name]), (fleet, one_queue, name)
    # per host: uniform, no topology or hedging == S1 at seed s + h
    fg = _fgrid(FleetConfig(n_hosts=4), rate_per_host=0.45 * MU, seeds=(11,))
    fs = simulate_fleet(fg, cfg, slot_us=0.5)
    grid = SweepGrid.of_points([dict(t_s_us=12.0, t_l_us=500.0, m=3, rate_mpps=0.45 * MU,
                                     seed=11 + h) for h in range(4)])
    args, params = sweep_inputs(grid, cfg, 0.5, "cuda")
    s1 = slot_sweep(*args, params=params)
    for name in ("offered", "serviced", "lat_area", "awake_us", "energy_uj", "wakeups"):
        np.testing.assert_array_equal(getattr(fs, name)[0],
                                      s1[name].double().cpu().numpy(), err_msg=name)


if __name__ == "__main__":
    witness()
