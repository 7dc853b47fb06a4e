"""The port's fleet sweep by event jumps: the ``fleet_adaptive_sweep``
kernel's module and ``simulate_fleet(stepping="adaptive")`` of
``repro_torch.runtime`` on the CPU, where ``fleet_adaptive_sweep`` runs its
plain version (``kernels/fleet_adaptive_sweep/ops.py:
reference_fleet_adaptive_sweep``), and on the card (``gpu``).

Exact parity with the reference is held through the noise, as for the
event-jump sweep: ``replay_step_draws`` (``test_torch_adaptive_sweep.py``)
derives the reference's threefry draws of every host (host ``h`` of seed
``s`` draws the event-jump stream of seed ``s + h``, with the adaptive
build's extra split for the first stall, ``src/repro/runtime/fleet.py:
243-258``) and feeds them to the plain version, whose results must then be
the reference ``simulate_fleet(stepping="adaptive")``'s, run in a process
of its own with XLA's fused multiply-add off (``test_torch_adaptive_sweep.
py``'s ``_REF_SCRIPT`` says why), at the six cases of
``test_torch_fleet.py``: counters, live and forced steps, the simulated
time and the step budget equal; float sums within 1e-5 relative.

The event-jump fleet turns on the last bit of a sum: a queue that drains
out in a step releases its thread where ``backlog <= 1e-6``, and the next
jump's length is a quotient of backlogs.  Where the balancer's softmax or
the hedge stage carries a last-bit difference from one host to the others,
it grows into other wakes and claims within a few hundred steps.  The JAX
reference does so against itself: with XLA's fused multiply-add on and off
(``python tests/test_torch_fleet_adaptive.py`` prints the gaps) its
least-loaded, hedged and chaotic cases differ at every point, by up to
several times a host's served packets.  So the plain version is held to
the reference with the reference's compiled choices put in place of the
kernel's (``reference_choices``: XLA's exp, its orders of the sums over
hosts and of two sums over queues), and as it ships where none of them
feeds back (``UNCOUPLED_CASES``).

Then: a one-host fleet is the event-jump sweep of its seed, bit for bit;
the step budget is the reference's; the plain version does not depend on
the length of the chunks its draws are made in (what the kernel's
producers rely on); the ring's layout against the source; and, on the
card, the kernel against its plain version bit for bit."""

import contextlib
import dataclasses
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_adaptive_sweep import ArrayDraws, replay_step_draws
from test_torch_fleet import NOISY, PARITY_CASES, TAIL_SLEEP, _points

from repro.runtime import FleetGrid as RefFleetGrid
from repro.runtime import SimRunConfig as RefConfig
from repro.runtime import SweepGrid as RefGrid
from repro.runtime.batched import bucket_steps as ref_bucket
from repro.runtime.batched_adaptive import estimate_adaptive_steps as ref_estimate
from repro.runtime.schedule import StepSchedule as RefStep
from repro.runtime.simcore import FleetConfig as RefFleetConfig
from repro.runtime.simcore import SleepModel as RefSleepModel
from repro_torch.kernels.adaptive_sweep.ops import SUM_NAMES, reference_adaptive_sweep
from repro_torch.kernels.fleet_adaptive_sweep import (
    fleet_adaptive_sweep,
    reference_fleet_adaptive_sweep,
)
from repro_torch.kernels.fleet_adaptive_sweep import kernel as fa_kernel
from repro_torch.kernels.fleet_adaptive_sweep import ops as fa_ops
from repro_torch.kernels.fleet_adaptive_sweep.ops import POINT_NAMES, STAT_NAMES
from repro_torch.kernels.fleet_sweep.ops import host_lanes, host_sum
from repro_torch.runtime import (
    FleetConfig,
    FleetGrid,
    SimRunConfig,
    SleepModel,
    StepSchedule,
    SweepGrid,
    simulate_fleet,
)
from repro_torch.runtime.batched_adaptive import adaptive_sweep_inputs
from repro_torch.runtime.fleet import fleet_adaptive_budget, fleet_adaptive_inputs

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
COUNTERS = ("wakeups", "busy_tries", "cycles", "ts_arms")
STEPS = ("n_steps", "forced_steps")
RTOL = 1e-5
MU = 29.76
PARITY_US, PARITY_SLOT_US = 1_500.0, 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain sweeps' small tensors gain nothing from intra-op threads;
    one keeps a parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the reference's draws, replayed into the plain version --------------------

def _parity_env(case):
    """(FleetConfig kwargs, hedge deadlines, scheduled, the environment's
    SimRunConfig kwargs) of a parity case of ``test_torch_fleet.py``."""
    fkw, hedges, noisy, scheduled = PARITY_CASES[case]
    env = dict(duration_us=PARITY_US, queue_capacity=64, **(NOISY if noisy else {}))
    return fkw, hedges, scheduled, env


def _ref_adaptive_run(case) -> dict:
    """The reference ``simulate_fleet(stepping="adaptive")`` of a parity
    case: its outputs, steps, simulated time and budget, and its hosts'
    draws (``replay_step_draws`` on the host rows, seed s + h)."""
    from repro.runtime import simulate_fleet as ref_simulate_fleet

    fkw, hedges, scheduled, env = _parity_env(case)
    pts = _points(fkw["n_hosts"], hedges, scheduled, RefStep)
    cfg = RefConfig(sleep_model=RefSleepModel(**TAIL_SLEEP), **env)
    fgrid = RefFleetGrid.of_points(pts, fleet=RefFleetConfig(**fkw))
    ref = ref_simulate_fleet(fgrid, cfg, slot_us=PARITY_SLOT_US, shard=False,
                             stepping="adaptive")
    out = {f"ref/{k}": np.asarray(getattr(ref, k), dtype=np.float64)
           for k in (*STAT_NAMES, *STEPS, "sim_time_us")}
    out["ref/scan_len"] = np.asarray(ref.scan_len)
    rows = RefGrid.of_points([dict(p, seed=p["seed"] + h) for p in pts
                              for h in range(fkw["n_hosts"])])
    out.update(replay_step_draws(rows, cfg, ref.scan_len))
    return out


@contextlib.contextmanager
def reference_choices():
    """The plain version with the reference's compiled choices in place of
    the kernel's, where the arithmetic leaves one open (``ops._exp``,
    ``ops._queue_sum``, ``ops.host_sum``): XLA's float32 exp, every sum over
    a point's hosts left to right (XLA:CPU's reduction and scatter-add), and
    a host's admissions and hedge-gate backlog over four queues as (q0 + q2)
    + (q1 + q3) (XLA:CPU's vectorised reduction in that program).  Run in the
    reference's process: XLA's exp there is the one its sweep evaluated."""
    import jax
    import jax.numpy as jnp

    xla_exp = jax.jit(jnp.exp)

    def exp(x):
        return torch.from_numpy(np.array(xla_exp(x.numpy())))

    def in_order(x):
        s = x[..., 0]
        for j in range(1, x.shape[-1]):
            s = s + x[..., j]
        return s

    def vectorised(x):
        if x.shape[-1] != 4:
            return in_order(x)
        return (x[..., 0] + x[..., 2]) + (x[..., 1] + x[..., 3])

    saved = (fa_ops._exp, fa_ops._queue_sum, fa_ops.host_sum)
    fa_ops._exp, fa_ops._queue_sum, fa_ops.host_sum = exp, vectorised, in_order
    try:
        yield
    finally:
        fa_ops._exp, fa_ops._queue_sum, fa_ops.host_sum = saved


_REF_SCRIPT = """
import sys
import numpy as np
sys.path[:0] = sys.argv[2:4]
import jax
a = np.random.default_rng(0).standard_normal((3, 4096)).astype(np.float32)
fused = np.asarray(jax.jit(lambda x, y, z: x * y + z)(*a))
assert np.array_equal(fused, a[0] * a[1] + a[2]), "XLA still contracts a * b + c"
import torch
torch.set_num_threads(1)
import test_torch_fleet_adaptive as T
out = {}
for i, case in enumerate(T.PARITY_CASES):
    runs = T._ref_adaptive_run(case)
    out.update({f"{i}/{k}": v for k, v in runs.items()})
    draws = T.ArrayDraws({k: v for k, v in runs.items() if not k.startswith("ref/")})
    with T.reference_choices():
        port, _, params, _ = T._port_adaptive_run(case, draws)
    port["budget"] = np.asarray(params.max_steps)
    out.update({f"{i}/choices/{k}": v for k, v in port.items()})
np.savez(sys.argv[1], **out)
"""


def _reference_runs(tmp_dir: Path):
    """Per parity case (keyed by its index): the reference's
    ``simulate_fleet(stepping="adaptive")``, its hosts' draws, and the plain
    version on those draws under ``reference_choices``, all from a process
    with XLA's contraction off."""
    path = tmp_dir / "runs.npz"
    # one core, like the rest of a parallel test run's workers
    flags = (f"{os.environ.get('XLA_FLAGS', '')} --xla_cpu_max_isa=AVX "
             "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1").strip()
    env = {**os.environ, "XLA_FLAGS": flags, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(path), str(ROOT / "src"), str(ROOT / "tests")],
        capture_output=True, text=True, timeout=900, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return np.load(path)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    return _reference_runs(tmp_path_factory.mktemp("fleet_adaptive_reference"))


def _port_adaptive_run(case, draws):
    """Plain S3b on a parity case, fed ``draws``: (outputs as float64
    arrays, the port's grid, its AdaptiveParams, its FleetParams)."""
    fkw, hedges, scheduled, env = _parity_env(case)
    cfg = SimRunConfig(sleep_model=SleepModel(**TAIL_SLEEP), **env)
    fgrid = FleetGrid.of_points(_points(fkw["n_hosts"], hedges, scheduled, StepSchedule),
                                fleet=FleetConfig(**fkw))
    args, params, fparams = fleet_adaptive_inputs(fgrid, cfg, PARITY_SLOT_US, CPU)
    out = reference_fleet_adaptive_sweep(*args, params, fparams, draws)
    return {k: v.double().numpy() for k, v in out.items()}, fgrid, params, fparams


def _case_runs(reference_runs, case):
    """(the reference's outputs, its hosts' draws, the plain version's
    outputs under ``reference_choices``) of a parity case."""
    i = list(PARITY_CASES).index(case)
    runs = {k.split("/", 1)[1]: reference_runs[k] for k in reference_runs.keys()
            if k.startswith(f"{i}/")}
    part = {kind: {k.split("/", 1)[1]: v for k, v in runs.items() if k.startswith(kind + "/")}
            for kind in ("ref", "choices")}
    draws = ArrayDraws({k: v for k, v in runs.items()
                        if not k.startswith(("ref/", "choices/"))})
    return part["ref"], draws, part["choices"]


def _assert_parity(out, ref, n_points, n_hosts, rtol):
    """Counters, live and forced steps and the simulated time exact; every
    sum within ``rtol``."""
    assert float(ref["wakeups"].sum()) > 100
    for name in STAT_NAMES:
        assert out[name].shape == ref[name].shape == (n_points, n_hosts)
        if name in COUNTERS:
            np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
        else:
            np.testing.assert_allclose(out[name], ref[name], rtol=rtol, atol=1e-3, err_msg=name)
    for name in STEPS:
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    np.testing.assert_array_equal(out["sim_time"], ref["sim_time_us"])
    np.testing.assert_array_equal(out["sim_time"], np.float32(PARITY_US))


# the cases where no sum over hosts, no exp and no order of a sum over
# queues feeds back into the dynamics: the plain version as it ships is the
# reference's there
UNCOUPLED_CASES = ("uniform, bottleneck link", "weighted", "weighted, topology")


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_plain_sweep_on_replayed_draws_equals_reference(case, reference_runs):
    """Plain S3b fed the reference's per-host draws, with the reference's
    compiled choices (``reference_choices``) == JAX
    ``simulate_fleet(stepping="adaptive")`` over 1,500 us: counters, live
    and forced steps, the simulated time and the budget exact; every sum
    (the host ones, ``topo_area`` and ``hedge_dup``) within 1e-5
    relative."""
    ref, _, out = _case_runs(reference_runs, case)
    fkw, hedges, _, _ = _parity_env(case)
    assert int(out["budget"]) == int(ref["scan_len"])
    assert float(ref["n_steps"].max()) < int(ref["scan_len"])
    if fkw.get("near_cost_us") or fkw.get("link_rate_mpps"):
        assert float(ref["topo_area"].sum()) > 0.0
    if max(hedges) > 0.0:
        assert float(ref["hedge_dup"].sum()) > 0.0
    _assert_parity(out, ref, 16, fkw["n_hosts"], RTOL)


@pytest.mark.parametrize("case", UNCOUPLED_CASES)
def test_plain_sweep_as_shipped_equals_reference(case, reference_runs):
    """Where no choice of ``reference_choices`` feeds back (no balancer's
    softmax, no hedging), the plain version as it ships (the kernel's
    orders and PyTorch's exp) meets the same exact parity."""
    ref, draws, _ = _case_runs(reference_runs, case)
    out, fgrid, params, fparams = _port_adaptive_run(case, draws)
    assert params.max_steps == int(ref["scan_len"])
    _assert_parity(out, ref, len(fgrid), fparams.n_hosts, RTOL)


# -- one host is the event-jump sweep ------------------------------------------

def _one_host_points():
    """m 1-4 x n_queues 1, 2 and 4 (where 1/n_queues is exact, so the
    fleet's rate (lam * 1 * scale) * (1/nq) rounds as the event-jump
    sweep's lam * scale / nq), every other point on a step schedule."""
    rng = np.random.default_rng(7)
    pts = []
    for m in (1, 2, 3, 4):
        for q in (1, 2, 4):
            p = dict(t_s_us=float(rng.uniform(4.0, 40.0)), t_l_us=float(rng.uniform(100.0, 600.0)),
                     m=m, n_queues=q, rate_mpps=float(rng.uniform(0.2, 0.8) * MU * q / 2.0),
                     seed=int(rng.integers(0, 3)))
            if len(pts) % 2:
                p["schedule"] = StepSchedule(times_us=(0.0, 700.0), scales=(0.4, 1.5))
            pts.append(p)
    return pts


@pytest.mark.parametrize("slot_us", (0.5, 10.0), ids=("free", "tail pacing"))
def test_one_host_fleet_is_the_event_jump_sweep(slot_us):
    """A one-host fleet (uniform, no topology, no hedging) at the
    event-jump sweep's budget equals the plain event-jump sweep at the same
    seed, bit for bit: its draws (host 0 keys as the point's seed), its jumps
    (a minimum over one host) and its sums; with slots of 10 us the budget's
    tail paces the run."""
    pts = _one_host_points()
    cfg = SimRunConfig(duration_us=1_500.0, sleep_model=SleepModel(**TAIL_SLEEP),
                       queue_capacity=64, **NOISY)
    s2_args, s2_params = adaptive_sweep_inputs(SweepGrid.of_points(pts), cfg, slot_us, CPU)
    assert s2_params.n_windows == 0 and all(s2_params.flags.values())
    s2 = reference_adaptive_sweep(*s2_args, s2_params)
    fgrid = FleetGrid.of_points(pts, fleet=FleetConfig(n_hosts=1))
    args, params, fparams = fleet_adaptive_inputs(fgrid, cfg, slot_us, CPU)
    assert fparams.lb_code == 0 and not fparams.topo_on
    out = reference_fleet_adaptive_sweep(*args, s2_params, fparams)
    if slot_us == 10.0:
        assert float(s2["forced_steps"].sum()) > 0
    assert float(s2["wakeups"].sum()) > 100 and float(s2["busy_tries"].sum()) > 0
    for name in SUM_NAMES:
        got = out[name] if name in POINT_NAMES else out[name][:, 0]
        assert torch.equal(got, s2[name]), name
    assert torch.equal(out["sim_time"], s2["sim_time"])
    assert float(out["topo_area"].abs().sum()) == 0.0 and float(out["hedge_dup"].sum()) == 0.0


# -- the step budget -------------------------------------------------------------

def _fleet_bench_shapes():
    """benchmarks/fleet.py's ten shapes (full mode): 4, 16 and 64 hosts x
    three balancers x the hedge ladder over 60 ms of 0.5 us slots with stall
    windows, and the scale row (1000 hosts x 8 points, 5 ms of 1 us slots),
    as (name, fleet kwargs, grid kwargs, duration_us, slot_us)."""
    out = []
    for hosts in (4, 16, 64):
        for lb, kw in (("uniform", {}),
                       ("weighted", dict(lb="weighted", host_weights=tuple(
                           1.0 + 0.5 * (h % 2) for h in range(hosts)))),
                       ("least-loaded", dict(lb="least-loaded", lb_stale_us=200.0))):
            out.append((f"H{hosts}/{lb}", dict(n_hosts=hosts, **kw),
                        dict(t_s_us=(12.0,), t_l_us=(500.0,), m=(3,),
                             rate_mpps=(0.5 * MU * hosts,),
                             hedge_deadline_us=(0.0, 80.0, 40.0, 20.0)), 60_000.0, 0.5))
    out.append(("scale", dict(n_hosts=1000),
                dict(t_s_us=(12.0,), t_l_us=(500.0,), m=(3,),
                     rate_mpps=(0.35 * MU * 1000, 0.55 * MU * 1000),
                     hedge_deadline_us=(0.0, 80.0, 40.0, 20.0)), 5_000.0, 1.0))
    return out


def _ref_budget(ref_fgrid, ref_cfg, slot_us):
    """The reference's step budget (``src/repro/runtime/fleet.py:1030-1039``)
    from its own ``estimate_adaptive_steps`` and ``bucket_steps``, without
    running its sweep."""
    fleet = ref_fgrid.fleet
    stale_every = max(int(round(fleet.lb_stale_us / slot_us)), 1)
    n_slots_true = max(int(math.ceil(ref_cfg.duration_us / slot_us)), 1)
    est = ref_estimate(ref_fgrid.grid, ref_cfg, slot_us, 0)
    if fleet.lb == "least-loaded":
        est += int(math.ceil(ref_cfg.duration_us / (stale_every * slot_us)))
    return ref_bucket(min(fleet.n_hosts * est + 64, n_slots_true))


@pytest.mark.parametrize("shape", _fleet_bench_shapes(), ids=lambda s: s[0])
def test_step_budget_is_the_references(shape):
    """The fleet's budget (``fleet_adaptive_budget``, the sweep's
    ``max_steps`` and ``FleetStats.scan_len``) equals the reference's at
    benchmarks/fleet.py's shapes (the parity cases' budgets are checked
    against the reference's own runs)."""
    _, fkw, gkw, dur, slot_us = shape
    stalls = dict(stall_rate_per_us=2.5e-4, stall_mean_us=150.0)
    ref = _ref_budget(RefFleetGrid.product(fleet=RefFleetConfig(**fkw), **gkw),
                      RefConfig(duration_us=dur, **stalls), slot_us)
    fgrid = FleetGrid.product(fleet=FleetConfig(**fkw), **gkw)
    cfg = SimRunConfig(duration_us=dur, **stalls)
    assert fleet_adaptive_budget(fgrid, cfg, slot_us) == ref
    _, params, _ = fleet_adaptive_inputs(fgrid, cfg, slot_us, CPU)
    assert params.max_steps == ref and params.steps == ref
    assert ref <= ref_bucket(int(math.ceil(dur / slot_us)))


# -- the plain version in chunks; the kernel's ring --------------------------------

STAGE = fa_kernel.STAGE_STEPS
# budgets one under, at and one over the boundary of four stages (the ring
# of two wraps there twice)
EDGE_BUDGETS = (4 * STAGE - 1, 4 * STAGE, 4 * STAGE + 1)
EDGE_HOSTS = (1, 5, 33)


def _edge_case(n_hosts, budget):
    """``test_torch_fleet.py``'s ring-edge fleet (least-loaded refreshing
    every 3 slots, the link, hedging, every noise family, schedules; four
    points, m = n_queues = 1..4) over 150 us at a budget of ``budget``
    steps, short enough that its tail paces every point."""
    from test_torch_fleet import _edge_case as fixed_edge_case

    fgrid, cfg = fixed_edge_case(n_hosts, 300, 3)
    args, params, fparams = fleet_adaptive_inputs(fgrid, cfg, 0.5, CPU)
    return args, dataclasses.replace(params, max_steps=budget), fparams


@pytest.mark.parametrize("budget", EDGE_BUDGETS)
@pytest.mark.parametrize("n_hosts", EDGE_HOSTS)
def test_plain_version_does_not_depend_on_its_chunk_length(n_hosts, budget, monkeypatch):
    """What the kernel's producers rely on: a step's state-free values depend
    on the step and the host alone, so they can be made ahead of the jumps
    for any run of steps.  The plain version gives the same bits with them
    made 16 steps (two stages) at a time, 20 (a split inside a stage) and
    all at once, at budgets on the ring's edges (the tail paces every
    point)."""
    args, params, fparams = _edge_case(n_hosts, budget)
    assert all(params.flags.values()) and fparams.link_on and args[8] is not None
    n_rows = 4 * n_hosts
    outs = []
    for chunk in (16, 20, None):
        if chunk is not None:
            monkeypatch.setattr(fa_ops, "_CHUNK_ELEMS", chunk * n_rows)
        else:
            monkeypatch.undo()
        outs.append(reference_fleet_adaptive_sweep(*args, params, fparams))
    assert float(outs[0]["n_steps"].max()) == budget
    assert float(outs[0]["forced_steps"].sum()) > 0
    assert float(outs[0]["hedge_dup"].sum()) > 0
    assert bool((outs[0]["sim_time"] == np.float32(150.0)).all())
    for out in outs[1:]:
        for name in (*STAT_NAMES, *POINT_NAMES):
            assert torch.equal(out[name], outs[0][name]), name


# -- the kernel's hedge tree, mirrored ---------------------------------------------

F32 = np.float32
NO_HOST = 0x7FFFFFFF


def _before(v, i, w, j):
    return v < w or (v == w and i < j)


def _top2_merge(a, o):
    """``Top2::merge`` (the argmin half of ``Hedge::combine``): the other
    subtree's record ``o`` merged into ``a``; returns (the merged record,
    whether the other held the first).  A record: the first two
    least-loaded hosts (v1, i1) and (v2, i2) and the far rack's sum."""
    a = dict(a, far=F32(a["far"] + o["far"]))
    other_first = _before(o["v1"], o["i1"], a["v1"], a["i1"])
    if other_first:
        mine = _before(a["v1"], a["i1"], o["v2"], o["i2"])
        a["v2"], a["i2"] = (a["v1"], a["i1"]) if mine else (o["v2"], o["i2"])
        a["v1"], a["i1"] = o["v1"], o["i1"]
    elif _before(o["v1"], o["i1"], a["v2"], a["i2"]):
        a["v2"], a["i2"] = o["v1"], o["i1"]
    return a, other_first


def _dup_merge(d, o, other_first):
    """``DupSums::merge`` (the sums of ``Hedge::combine``): the duplicates'
    sum (full), that sum with the first's zeroed (excl), the first's own
    (d1)."""
    d = {k: d[k] for k in ("full", "excl", "d1")}
    if other_first:
        d["excl"], d["d1"] = F32(d["full"] + o["excl"]), o["d1"]
    else:
        d["excl"] = F32(d["excl"] + o["full"])
    d["full"] = F32(d["full"] + o["full"])
    return d


def _hedge_combine(a, o):
    """``Hedge::combine``: both halves in one round."""
    top, first = _top2_merge(a, o)
    return {**top, **_dup_merge(a, o, first)}


def kernel_hedge_tree(btot, dup_q, far_adm):
    """The kernel's hedge tree over one point's H hosts, thread by thread:
    W = host_lanes(H) lanes.  Up to 32 lanes one warp, thread t running host
    t mod W (every group of W lanes holds the hosts), the two passes over
    offsets W / 2, ..., 1: ``Top2`` first, then ``DupSums`` replaying its
    recorded rounds.  Above, ``Hedge::combine`` within each warp and then
    over the W / 32 warps' lane-0 records (``reduce``).  Returns every
    consumer thread's result."""
    n = len(btot)
    w = host_lanes(n)
    threads = max(w, 32)
    out = []
    for t in range(threads):
        h = t & (w - 1)
        if h < n:     # Hedge::leaf
            dq = F32(dup_q[h])
            out.append(dict(full=dq, excl=F32(0.0), v1=F32(btot[h]), v2=F32(np.inf), d1=dq,
                            far=F32(far_adm[h]), i1=h, i2=NO_HOST))
        else:
            out.append(dict(full=F32(0.0), excl=F32(0.0), v1=F32(np.inf), v2=F32(np.inf),
                            d1=F32(0.0), far=F32(0.0), i1=NO_HOST, i2=NO_HOST))
    offsets = [off for off in (16, 8, 4, 2, 1) if off < min(w, 32)]
    if w <= 32:
        firsts = [[] for _ in range(threads)]
        for off in offsets:
            prev = list(out)
            for t in range(threads):
                top, first = _top2_merge(prev[t], prev[t ^ off])
                out[t] = {**prev[t], **top}
                firsts[t].append(first)
        for r, off in enumerate(offsets):
            prev = list(out)
            out = [{**prev[t], **_dup_merge(prev[t], prev[t ^ off], firsts[t][r])}
                   for t in range(threads)]
        return out
    for off in offsets:
        prev = list(out)
        out = [_hedge_combine(prev[t], prev[t ^ off]) for t in range(threads)]
    groups = w // 32
    slots = [out[32 * g] for g in range(groups)]
    out = [dict(slots[(t & 31) & (groups - 1)]) for t in range(threads)]
    for off in (4, 2, 1):
        if off < groups:
            prev = list(out)
            out = [_hedge_combine(prev[t], prev[t ^ off]) for t in range(threads)]
    return out


def hedge_stage_result(tree, n_hosts):
    """What the consumer takes from the tree (``consume``): b1, b2, the
    duplicates that land on b1 and on b2, and the far rack's sum; a lone
    host's duplicates come back to it."""
    b1, b2, to_b1, to_b2 = tree["i1"], tree["i2"], tree["excl"], tree["d1"]
    if n_hosts == 1:
        to_b1, b2 = to_b2, b1
    return dict(b1=b1, b2=b2, to_b1=F32(to_b1), to_b2=F32(to_b2), far=F32(tree["far"]))


def hedge_stage_direct(btot, dup_q, far_adm):
    """The plain version's hedge stage on one point (``ops.py``, step 5): b1
    and b2 by argmin (the lowest index among equal backlogs), the duplicates
    to b1 a ``host_sum`` with b1's zeroed, b1's own to b2, a lone host's back
    to it; the far rack's sum by ``host_sum``."""
    n = len(btot)
    b = torch.tensor(np.asarray(btot, dtype=np.float32))[None]
    dq = torch.tensor(np.asarray(dup_q, dtype=np.float32))[None]
    b1 = torch.argmin(b, dim=1)
    is_b1 = torch.arange(n)[None] == b1[:, None]
    far = F32(host_sum(torch.tensor(np.asarray(far_adm, dtype=np.float32))[None])[0])
    if n == 1:
        return dict(b1=0, b2=0, to_b1=F32(dq[0, 0]), to_b2=F32(dq[0, 0]), far=far)
    b2 = torch.argmin(torch.where(is_b1, float("inf"), b), dim=1)
    return dict(b1=int(b1[0]), b2=int(b2[0]),
                to_b1=F32(host_sum(torch.where(is_b1, 0.0, dq))[0]),
                to_b2=F32(dq[0, int(b1[0])]), far=far)


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                   # pragma: no cover
    HAVE_HYPOTHESIS = False


if HAVE_HYPOTHESIS:
    _finite = st.floats(min_value=0.0, max_value=1e4, allow_nan=False, allow_infinity=False,
                        width=32)
    # backlogs from a handful of values, so that equal backlogs are common
    _backlog = st.one_of(st.sampled_from([0.0, 1.0, 2.5, 7.0]), _finite)

    @st.composite
    def _hedge_leaves(draw):
        n = draw(st.one_of(st.integers(1, 40), st.sampled_from([63, 64, 65, 127, 128, 129,
                                                                 200, 255, 256])))
        btot = draw(st.lists(_backlog, min_size=n, max_size=n))
        dup_q = draw(st.lists(_finite, min_size=n, max_size=n))
        far_adm = draw(st.lists(_finite, min_size=n, max_size=n))
        return btot, dup_q, far_adm

    @settings(max_examples=60, deadline=None)
    @given(leaves=_hedge_leaves())
    def test_kernel_hedge_tree_equals_the_direct_hedge_stage(leaves):
        """The kernel's hedge tree (mirrored thread by thread,
        ``kernel_hedge_tree``: the two passes within one warp, the single
        tree across warps) gives every consumer thread the same record,
        below 32 lanes with no broadcast (every group of W lanes holds the
        hosts), and its stage result is the plain version's, bit for bit:
        random leaves, equal backlogs (the lowest host index wins), padding
        lanes (H below W), 1 to 256 hosts (one to eight warps), a lone
        host."""
        btot, dup_q, far_adm = leaves
        out = kernel_hedge_tree(btot, dup_q, far_adm)
        first = out[0]
        for rec in out[1:]:
            assert rec == first
        got = hedge_stage_result(first, len(btot))
        want = hedge_stage_direct(btot, dup_q, far_adm)
        assert got == want


@pytest.mark.parametrize("n_hosts", (1, 2, 3, 5, 32, 33, 64, 256))
def test_kernel_hedge_tree_on_equal_backlogs_and_infinities(n_hosts):
    """Every host at the same backlog (b1 = host 0, b2 = host 1), then
    infinite backlogs on all but the last two hosts, and infinite
    duplicates: the mirrored tree still equals the direct stage."""
    rng = np.random.default_rng(n_hosts)
    dup_q = rng.uniform(0.0, 3.0, n_hosts).astype(np.float32)
    far_adm = rng.uniform(0.0, 9.0, n_hosts).astype(np.float32)
    cases = [np.full(n_hosts, 4.0, np.float32),
             np.concatenate([np.full(max(n_hosts - 2, 0), np.inf), [3.0, 3.0]])[-n_hosts:]]
    for btot in cases:
        for dq in (dup_q, np.where(np.arange(n_hosts) == n_hosts - 1, np.inf, dup_q)):
            got = hedge_stage_result(kernel_hedge_tree(btot, dq, far_adm)[0], n_hosts)
            want = hedge_stage_direct(btot, dq, far_adm)
            assert got == want, (btot, dq)
            if n_hosts > 1 and (btot == btot[0]).all():
                assert (got["b1"], got["b2"]) == (0, 1)


SMEM_PER_BLOCK = 232_448     # the shared memory a block can use on an H100 (227 KB)
STATIC_SMEM = 2 * 8 * 32 + 2 * 2 * 8 + 4   # reduction buffers, mbarriers, the stop word


def test_ring_layout_matches_the_kernel_source():
    """The Python side's ring (``kernel.STAGES``, ``STAGE_STEPS`` and the
    byte count ``ring_bytes``) is the source's, a step the event-jump
    sweep's fields; with the block's static shared memory it fits at every
    host count of the ring route, both builds, stalls on and off; beyond 256
    hosts the scratch route keeps no ring.  The lanes: one host a consumer
    lane up to 256 hosts (below 32 lanes thread t runs host t mod W, every
    group of W lanes of the one consumer warp holding the hosts; a warp per
    32 lanes above), and beyond 256 hosts the cluster route's ring of 32 K
    lanes a block (``tests/test_torch_fleet_cluster.py`` pins that route)."""
    src = (Path(fa_kernel.__file__).parents[1] / "csrc" / "fleet_adaptive_sweep.cu").read_text()
    flat = " ".join(src.split())

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kStageSteps") == fa_kernel.STAGE_STEPS
    assert const("kStages") == fa_kernel.STAGES
    assert const("kMaxLanes") == 256 == host_lanes(10_000)
    assert const("kNumFParams") == len(fa_kernel._FPARAMS) + len(fa_kernel._FLEET_FPARAMS)
    for line in ("static constexpr int kZ = 0, kOver = QQ, kLen = QQ + MM, kGap = QQ + MM + 1, "
                 "kJit = QQ + MM + 2;",
                 "return (flags & kStallOn) ? kJit + MM : kLen;",
                 "return kStageSteps * fields(flags) * lanes;",
                 "return sizeof(float) * (size_t)kStages * stage_floats(lanes, flags);",
                 "unsigned char slot[2][kMaxWarps][32];",
                 "__shared__ __align__(8) uint64_t bars[2 * kStages];",
                 "inline int consumer_warps(int lanes) { return lanes < 32 ? 1 : lanes / 32; }",
                 "const int h = threadIdx.x & (BlockRoute<LW>::kLanes - 1);",
                 "(int)threadIdx.x < BlockRoute<LW>::kLanes, pt,",
                 "const bool live = h < H;",
                 "if (!live || !first) return;",
                 "P.hosts_per_lane = (n_hosts + P.lanes - 1) / P.lanes;"):
        assert line in flat, line
    stages, steps = const("kStages"), const("kStageSteps")
    for n_hosts in range(1, 257):
        for q_max in (1, 4):
            for stalls in (False, True):
                fields = q_max + 4 + (2 + 4 if stalls else 0)
                want = 4 * stages * steps * fields * host_lanes(n_hosts)
                got = fa_kernel.ring_bytes(n_hosts, q_max, stalls)
                assert got == want, (n_hosts, q_max, stalls)
                assert got + STATIC_SMEM <= SMEM_PER_BLOCK, (n_hosts, q_max, stalls)
    assert fa_kernel.ring_bytes(256, 4, True) == 229_376
    # 257 hosts: the cluster route, two hosts a lane, 64 ring lanes a block
    assert fa_kernel.ring_bytes(257, 4, True) == 229_376 // 4
    assert fa_kernel.ring_bytes(256 * fa_kernel.MAX_HOSTS_PER_LANE + 1, 4, True) == 0


# -- the port's surface ------------------------------------------------------------

def test_cpu_runs_the_plain_version_and_cuda_never_falls_back():
    """On CPU tensors ``simulate_fleet(stepping="adaptive")`` runs the plain
    version and launches nothing; its ``FleetStats`` carry the run's steps,
    forced steps, simulated time and the budget; asked for CUDA where there
    is none, it raises."""
    fg = FleetGrid.product(fleet=FleetConfig(n_hosts=2), t_s_us=(12.0,), t_l_us=(500.0,),
                           m=(3,), rate_mpps=(0.4 * MU * 2,), hedge_deadline_us=(0.0, 20.0))
    cfg = SimRunConfig(duration_us=300.0)
    launches, by_build = fleet_adaptive_sweep.launches, dict(
        fleet_adaptive_sweep.launches_by_build)
    fs = simulate_fleet(fg, cfg, slot_us=0.5, stepping="adaptive", device="cpu")
    assert fleet_adaptive_sweep.launches == launches
    assert fleet_adaptive_sweep.launches_by_build == by_build
    assert fs.backend == "plain" and fs.stepping == "adaptive"
    assert fs.scan_len == fleet_adaptive_budget(fg, cfg, 0.5)
    args, params, fparams = fleet_adaptive_inputs(fg, cfg, 0.5, CPU)
    plain = reference_fleet_adaptive_sweep(*args, params, fparams)
    for name in STAT_NAMES:
        np.testing.assert_array_equal(getattr(fs, name), plain[name].double().numpy())
    np.testing.assert_array_equal(fs.n_steps, plain["n_steps"].double().numpy())
    np.testing.assert_array_equal(fs.forced_steps, plain["forced_steps"].double().numpy())
    np.testing.assert_array_equal(fs.sim_time_us, np.full(2, 300.0))
    assert np.all(fs.n_steps < 600) and float(fs.hedge_dup[1].sum()) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            simulate_fleet(fg, cfg, slot_us=0.5, stepping="adaptive")
        assert fleet_adaptive_sweep.launches == launches


# -- on the card ---------------------------------------------------------------------

@pytest.mark.gpu
def test_kernel_equals_plain_version_on_the_card():
    """The kernel against its plain version on the card, every output bit
    for bit: 1, 3, 4, 33, 64, 256 and 257 hosts (the ring and cluster routes
    and the lane edges; the scratch route: ``test_torch_fleet_cluster.py``),
    each balancer, topology with the link, hedge deadlines 0, 20 and
    80, every noise family and a schedule, one queue a point (<4, 1>) and
    up to four (<4, 4>); runs that stop more than three stages before the
    budget's end, some of them on a stage's first step; the tail's pacing
    (slots of 10 us); the ring's edges (``_edge_case``); and the tree's
    corners at 33, 48, 63 and 64 hosts (two consumer warps) and at 5 and 40:
    least-loaded refreshing every 2 us with every point hedged (a refresh
    step right after a hedged one), the link without hedging, a load of 5%
    with every point hedged (most steps every backlog equal, so b1 and b2
    are the lowest indices)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fleet sweep kernel has no CPU mode")
    cfg = SimRunConfig(duration_us=400.0, sleep_model=SleepModel(**TAIL_SLEEP),
                       queue_capacity=64, **NOISY)
    link = dict(near_cost_us=1.0, far_cost_us=5.0)
    cases = []
    for hosts, kw in ((1, dict(near_cost_us=2.0)),
                      (3, dict(lb="weighted", host_weights=(1.0, 2.0, 3.0), far_fraction=0.34,
                               link_rate_mpps=10.0, **link)),
                      (4, dict(lb="least-loaded", lb_stale_us=5.0)),
                      (33, dict(lb="least-loaded", lb_stale_us=5.0, far_fraction=0.5,
                                link_rate_mpps=300.0, **link)),
                      (64, dict(far_fraction=0.25, link_rate_mpps=400.0, **link)),
                      (256, dict(lb="least-loaded", lb_stale_us=5.0)),
                      (257, dict(lb="least-loaded", lb_stale_us=2.0, far_fraction=0.5,
                                 link_rate_mpps=10_000.0, **link))):
        for one_queue in (True, False):
            pts = _points(hosts, (0.0, 20.0, 80.0), True, StepSchedule)
            if one_queue:
                pts = [dict(p, n_queues=1) for p in pts]
            for slot_us in (0.5, 10.0):
                cases.append((FleetGrid.of_points(pts, fleet=FleetConfig(n_hosts=hosts, **kw)),
                              cfg, slot_us, {}))
    for hosts in EDGE_HOSTS:
        for budget in EDGE_BUDGETS:
            fgrid, c = __import__("test_torch_fleet")._edge_case(hosts, 300, 3)
            cases.append((fgrid, c, 0.5, {"max_steps": budget}))
    hedged_all = (20.0, 40.0, 80.0)
    for hosts, kw, hedges, load in (
            (33, dict(lb="least-loaded", lb_stale_us=2.0), hedged_all, 1.0),
            (48, dict(far_fraction=0.5, link_rate_mpps=200.0, **link), (0.0,), 1.0),
            (63, dict(lb="weighted", host_weights=tuple(1.0 + (h % 3) for h in range(63))),
             (0.0, 20.0, 80.0), 1.0),
            (64, dict(lb="least-loaded", lb_stale_us=2.0, far_fraction=0.25,
                      link_rate_mpps=400.0, **link), hedged_all, 1.0),
            (5, {}, hedged_all, 0.05),
            (40, dict(lb="least-loaded", lb_stale_us=2.0), hedged_all, 0.05)):
        pts = [dict(p, rate_mpps=p["rate_mpps"] * load)
               for p in _points(hosts, hedges, True, StepSchedule)]
        cases.append((FleetGrid.of_points(pts, fleet=FleetConfig(n_hosts=hosts, **kw)),
                      dataclasses.replace(cfg, duration_us=250.0), 0.5, {}))
    routes, kinds, edge_stops = set(), set(), 0
    for fgrid, c, slot_us, replace in cases:
        args, params, fparams = fleet_adaptive_inputs(fgrid, c, slot_us, "cuda")
        params = dataclasses.replace(params, **replace)
        launches = fleet_adaptive_sweep.launches
        before = dict(fleet_adaptive_sweep.launches_by_build)
        out = fleet_adaptive_sweep(*args, params=params, fleet=fparams)
        assert fleet_adaptive_sweep.launches == launches + 1
        routes |= {b for b, n in fleet_adaptive_sweep.launches_by_build.items()
                   if n != before.get(b, 0)}
        plain = reference_fleet_adaptive_sweep(*args, params, fparams)
        # every case either stops more than three stages before its budget's
        # end or is paced by the budget's tail (from 33 hosts on, the fleet's
        # boundaries lie closer than the slot and the reference's budget
        # binds); slots of 10 us and the ring's edges always pace
        early = float(plain["n_steps"].max()) < params.max_steps - 3 * STAGE
        paced = float(plain["forced_steps"].sum()) > 0
        assert early or paced, (fparams.n_hosts, slot_us, replace)
        if slot_us == 10.0 or replace:
            assert paced, (fparams.n_hosts, slot_us, replace)
        kinds |= {k for k, on in (("early stop", early), ("paced", paced)) if on}
        if early:
            edge_stops += int((plain["n_steps"].long() % STAGE == 0).sum())
        for name in (*STAT_NAMES, *POINT_NAMES):
            assert torch.equal(out[name], plain[name]), (fparams.n_hosts, slot_us, name)
    assert routes == {(4, q, r) for q in (1, 4) for r in ("ring", "cluster")}
    assert kinds == {"early stop", "paced"}
    assert edge_stops > 0


def _gaps(got, want):
    """Per point, the largest gap over every output and host, relative to
    max(|want|, 1)."""
    return np.max([np.max(np.abs(np.reshape(got[k], (16, -1)) - np.reshape(want[k], (16, -1)))
                          / np.maximum(np.abs(np.reshape(want[k], (16, -1))), 1.0), axis=1)
                   for k in (*STAT_NAMES, *STEPS)], axis=0)


def witness():
    """The readings behind the module's docstring: per parity case, the
    largest gap over the points of JAX with XLA's fma on (this process)
    against JAX with it off, of the plain version as it ships against JAX
    (fma off), and of the plain version under ``reference_choices`` against
    JAX (fma off); and the fleet's live steps on each side."""
    import tempfile
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        runs = _reference_runs(Path(tmp))
        runs = {k: runs[k] for k in runs.keys()}
    for case in PARITY_CASES:
        ref, draws, choices = _case_runs(runs, case)
        on = {k.split("/", 1)[1]: v for k, v in _ref_adaptive_run(case).items()
              if k.startswith("ref/")}
        shipped = _port_adaptive_run(case, draws)[0]
        gaps = {"JAX fma on vs off": _gaps(on, ref), "shipped vs JAX": _gaps(shipped, ref),
                "reference choices vs JAX": _gaps(choices, ref)}
        print(f"{case}: " + "; ".join(f"{k} {v.max():.3e} (points over 1e-5: "
                                        f"{int((v > 1e-5).sum())} of 16)"
                                        for k, v in gaps.items())
              + f"; live steps JAX fma off {ref['n_steps'].sum():.0f}, on "
                f"{on['n_steps'].sum():.0f}, shipped {shipped['n_steps'].sum():.0f}")


if __name__ == "__main__":
    witness()
