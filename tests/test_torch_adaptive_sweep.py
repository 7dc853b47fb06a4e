"""The port's event-jump sweep: the ``adaptive_sweep`` kernel's module and
``simulate_batch(stepping="adaptive")`` of ``repro_torch.runtime`` on the
CPU, where ``adaptive_sweep`` runs its plain version
(``kernels/adaptive_sweep/ops.py:reference_adaptive_sweep``), and on the
card (``gpu``).

The port draws its noise from a Philox contract, the reference from jax's
threefry, so equal grids give other sample paths.  Exact parity is held
through the noise instead: ``replay_step_draws`` derives the reference's own
draws with ``jax.random`` exactly as ``src/repro/runtime/batched_adaptive.py``
does (:208-217, :227-235, :360-396) and feeds them to the plain version
through its draw-provider argument; the result must then be the reference
``simulate_batch(stepping="adaptive")``'s, run in a process of its own with
XLA's fused multiply-add off (``_REF_SCRIPT`` says why).  Counters
(wakeups, busy tries, cycles, T_S arms, live and forced steps), the step
budget and the simulated time must be equal; float sums agree to 1e-5 relative (both sides make the
same float32 operations; XLA may sum a point's queues in another order).

Then the step budget against the reference's, the Philox contract's S2
streams, the sweep's exact invariants, the port's own surface, the kernel's
ring (its layout against the source; the plain version at the ring's edges),
and, on the card, the kernel against its plain version bit for bit."""

import dataclasses
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import SimRunConfig as RefConfig
from repro.runtime import SweepGrid as RefGrid
from repro.runtime import batched_adaptive as ref_adaptive
from repro.runtime.schedule import RampSchedule as RefRamp
from repro.runtime.schedule import StepSchedule as RefStep
from repro.runtime.simcore import DEEP_CSTATE_ENERGY_MODEL as REF_DEEP
from repro.runtime.simcore import HR_SLEEP_MODEL as REF_HR
from repro.runtime.simcore import SleepModel as RefSleepModel
from repro_torch.kernels.adaptive_sweep import kernel as adaptive_kernel
from repro_torch.kernels.adaptive_sweep import ops as adaptive_ops
from repro_torch.kernels.adaptive_sweep import philox as step_philox
from repro_torch.kernels.adaptive_sweep.ops import (
    SUM_NAMES,
    adaptive_sweep,
    reference_adaptive_sweep,
)
from repro_torch.kernels.slot_sweep import philox
from repro_torch.runtime import (
    DEEP_CSTATE_ENERGY_MODEL,
    DEFAULT_ENERGY_MODEL,
    HR_SLEEP_MODEL,
    RampSchedule,
    SimRunConfig,
    SleepModel,
    StepSchedule,
    SweepGrid,
    simulate_batch,
)
from repro_torch.runtime import batched_adaptive

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
COUNTERS = ("wakeups", "busy_tries", "cycles", "ts_arms", "n_steps", "forced_steps")
SUMS = ("offered", "dropped", "serviced", "awake_us", "lat_area", "vac_sum", "nv_sum",
        "energy_uj", "final_backlog")
RTOL = 1e-5

# tests/test_torch_batched.py's noisy host (its stalls 10x as frequent as
# tests/test_batched_engine.py's band, so that a short run opens some) and
# sleep model with a tail
NOISY = dict(interference_prob=0.25, interference_mean_us=20.0,
             stall_rate_per_us=1.0 / 400.0, stall_mean_us=150.0)
TAIL_SLEEP = dict(base_us=2.8, slope=0.027, sigma_us=0.5, tail_prob=0.01, tail_mean_us=40.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain sweeps' small tensors gain nothing from intra-op threads;
    one keeps a parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the reference's draws, replayed into the plain version --------------------

def replay_step_draws(grid, cfg, n_steps) -> dict[str, np.ndarray]:
    """The reference kernel's draws for ``grid`` (per point, per step), as
    arrays named ``d0/<name>`` (the initial draws, point first) and
    ``d/<name>`` (step first), the names of ``StepDraws``."""
    m, q = int(grid.m.max()), int(grid.n_queues.max())
    tail = cfg.sleep_model.tail_prob > 0.0
    intf = cfg.interference_prob > 0.0
    stall = cfg.stall_rate_per_us > 0.0

    def point(lo, hi):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), lo), hi)
        key, k0 = jax.random.split(key)
        d0 = {"sleep_u": jax.random.uniform(k0, (m,))}
        if stall:
            key, kst = jax.random.split(key)
            d0["stall_e"] = jax.random.exponential(kst, ())

        def step(t):
            kt = jax.random.fold_in(key, t)
            if tail:
                kt, kp, ku = jax.random.split(kt, 3)
            if intf:
                kt, kip, kie = jax.random.split(kt, 3)
            if stall:
                kt, kse, ksg, ksu = jax.random.split(kt, 4)
            zs = jax.random.normal(kt, (q + m,))
            d = {"z_q": zs[:q], "z_m": zs[q:]}
            if tail:
                d["tail_u"] = jax.random.uniform(kp, (m,))
                d["tail_e"] = jax.random.exponential(ku, (m,))
            if intf:
                d["intf_u"] = jax.random.uniform(kip, (m,))
                d["intf_e"] = jax.random.exponential(kie, (m,))
            if stall:
                d["stall_len_e"] = jax.random.exponential(kse, ())
                d["stall_gap_e"] = jax.random.exponential(ksg, ())
                d["stall_jitter"] = jax.random.uniform(ksu, (m,))
            return d

        return d0, jax.vmap(step)(jnp.arange(n_steps, dtype=jnp.int32))

    seed64 = np.asarray(grid.seed, dtype=np.uint64)
    lo = jnp.asarray((seed64 & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((seed64 >> np.uint64(32)).astype(np.uint32))
    d0, d = jax.jit(jax.vmap(point))(lo, hi)
    out = {f"d0/{k}": np.asarray(v) for k, v in d0.items()}
    # (P, T, ...) -> (T, P, ...)
    out.update({f"d/{k}": np.ascontiguousarray(np.swapaxes(np.asarray(v), 0, 1))
                for k, v in d.items()})
    return out


class ArrayDraws:
    """Draws held as arrays (``replay_step_draws``' names), in the form
    ``reference_adaptive_sweep`` consumes (``StepDraws``)."""

    def __init__(self, arrays: dict):
        def part(kind):
            return {k.split("/", 1)[1]: torch.from_numpy(np.asarray(v))
                    for k, v in arrays.items() if k.startswith(kind + "/")}
        self.d0, self.d = part("d0"), part("d")

    def initial(self):
        return self.d0

    def chunk(self, t0, t1):
        return {k: v[t0:t1] for k, v in self.d.items()}


def _replayed(draws, grid, cfg, slot_us, monkeypatch):
    """``simulate_batch(stepping="adaptive", device="cpu")`` of the port for
    ``grid`` in ``cfg``, its plain sweep drawing ``draws``."""
    def replayed_sweep(*args, params):
        return reference_adaptive_sweep(*args, params, draws)

    with monkeypatch.context() as mp:
        mp.setattr(batched_adaptive, "adaptive_sweep", replayed_sweep)
        return simulate_batch(grid, cfg, slot_us=slot_us, stepping="adaptive", device="cpu")


# The reference runs in a process of its own with XLA:CPU's fused
# multiply-add off.  XLA lets LLVM contract a product and a sum into one
# rounding wherever it can; the event-jump step's drain-out test (backlog <=
# 1e-6 after draining dt = backlog / (mu - lam) over the step) turns on the
# last bit of such sums, in the reference as in the port, so with
# contraction a counter can differ for the compiler's reasons and not the
# model's.  Without it both sides make the reference's float32 operations as
# written, and their counters agree exactly.
_REF_SCRIPT = """
import sys
import numpy as np
sys.path[:0] = sys.argv[2:4]
import jax
a = np.random.default_rng(0).standard_normal((3, 4096)).astype(np.float32)
fused = np.asarray(jax.jit(lambda x, y, z: x * y + z)(*a))
assert np.array_equal(fused, a[0] * a[1] + a[2]), "XLA still contracts a * b + c"
import test_torch_adaptive_sweep as T
from repro.runtime import SweepGrid, simulate_batch
out = {}
for case in T.PARITY_CASES:
    _, pts, _, cfg, slot_us = T._parity_case(case)
    grid = SweepGrid.of_points(pts)
    bs = simulate_batch(grid, cfg, slot_us=slot_us, stepping="adaptive")
    for name in (*T.COUNTERS, *T.SUMS, "win", "sim_time_us", "scan_len"):
        out[f"{case}/ref/{name}"] = np.asarray(getattr(bs, name))
    out.update({f"{case}/{k}": v
                for k, v in T.replay_step_draws(grid, cfg, bs.scan_len).items()})
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's ``simulate_batch(stepping="adaptive")`` of every
    parity case and its draws, from a process with XLA's contraction off."""
    path = tmp_path_factory.mktemp("adaptive_reference") / "runs.npz"
    # one core, like the rest of a parallel test run's workers
    flags = (f"{os.environ.get('XLA_FLAGS', '')} --xla_cpu_max_isa=AVX "
             "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1").strip()
    env = {**os.environ, "XLA_FLAGS": flags, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(path), str(ROOT / "src"), str(ROOT / "tests")],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return np.load(path)


def _multi_points(seed, schedules=(), t_s=(4.0, 40.0)):
    """Every (m, n_queues) pair in 1..4 x 1..4, knobs drawn from a seed;
    seeds repeat so that points share draws."""
    rng = np.random.default_rng(seed)
    pts = []
    for m in (1, 2, 3, 4):
        for q in (1, 2, 3, 4):
            pts.append(dict(t_s_us=float(rng.uniform(*t_s)),
                            t_l_us=float(rng.uniform(100.0, 600.0)), m=m, n_queues=q,
                            rate_mpps=float(rng.uniform(0.1, 0.9) * 29.76 * q / 2.0),
                            seed=int(rng.integers(0, 3))))
    for i, s in enumerate(schedules):
        pts[i]["schedule"] = s
    return pts


def _parity_case(name):
    """(points for the port, points for the reference, port cfg, ref cfg,
    slot_us)."""
    dur = 1_500.0
    slot_us = 0.5
    if name == "quiet":
        kw_p = kw_r = dict(duration_us=dur)
        sl_p, sl_r = HR_SLEEP_MODEL, REF_HR
        pts_p = pts_r = _multi_points(1)
    elif name == "noisy":                   # tails, interference, stalls
        kw_p = kw_r = dict(duration_us=dur, queue_capacity=64, **NOISY)
        sl_p, sl_r = SleepModel(**TAIL_SLEEP), RefSleepModel(**TAIL_SLEEP)
        pts_p = pts_r = _multi_points(2)
    elif name == "scheduled":   # per-point schedules, windows, a deep energy model
        kw_p = dict(duration_us=dur, window_us=130.0, energy_model=DEEP_CSTATE_ENERGY_MODEL)
        kw_r = dict(kw_p, energy_model=REF_DEEP)
        sl_p, sl_r = HR_SLEEP_MODEL, REF_HR
        pts_p = _multi_points(3, [StepSchedule(times_us=(0.0, 600.0), scales=(0.3, 1.6)),
                                  RampSchedule(t_start_us=200.0, t_end_us=1_200.0,
                                               scale_from=0.2, scale_to=1.5)] * 4)
        pts_r = _multi_points(3, [RefStep(times_us=(0.0, 600.0), scales=(0.3, 1.6)),
                                  RefRamp(t_start_us=200.0, t_end_us=1_200.0,
                                          scale_from=0.2, scale_to=1.5)] * 4)
    else:   # "tail pacing": slots of 10 us cap the budget at 157 steps, under need
        kw_p = kw_r = dict(duration_us=dur, queue_capacity=64, **NOISY)
        sl_p, sl_r = SleepModel(**TAIL_SLEEP), RefSleepModel(**TAIL_SLEEP)
        pts_p = pts_r = _multi_points(5, t_s=(20.0, 60.0))
        slot_us = 10.0
    return (pts_p, pts_r, SimRunConfig(sleep_model=sl_p, **kw_p),
            RefConfig(sleep_model=sl_r, **kw_r), slot_us)


PARITY_CASES = ("quiet", "noisy", "scheduled", "tail pacing")


@pytest.mark.parametrize("case", PARITY_CASES)
def test_plain_sweep_on_replayed_draws_equals_reference(case, reference_runs, monkeypatch):
    pts_p, _, cfg_p, _, slot_us = _parity_case(case)
    ref = {k.split("/")[-1]: reference_runs[k] for k in reference_runs.files
           if k.startswith(f"{case}/ref/")}
    draws = ArrayDraws({k[len(case) + 1:]: reference_runs[k] for k in reference_runs.files
                        if k.startswith(f"{case}/d")})
    port = _replayed(draws, SweepGrid.of_points(pts_p), cfg_p, slot_us, monkeypatch)
    assert float(ref["wakeups"].sum()) > 100      # the run exercises the claim logic
    if case in ("noisy", "tail pacing"):
        assert float(ref["dropped"].sum()) > 0 and float(ref["busy_tries"].sum()) > 0
    if case == "tail pacing":
        assert float(ref["forced_steps"].sum()) > 0
    else:
        assert float(ref["forced_steps"].sum()) == 0
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(port, name), ref[name], err_msg=name)
    for name in SUMS:
        np.testing.assert_allclose(getattr(port, name), ref[name], rtol=RTOL, atol=1e-3,
                                   err_msg=name)
    assert port.win.shape == ref["win"].shape
    if ref["win"].size:
        np.testing.assert_allclose(port.win, ref["win"], rtol=RTOL, atol=1e-3)
    assert port.scan_len == int(ref["scan_len"]) and port.stepping == "adaptive"
    np.testing.assert_array_equal(port.sim_time_us, ref["sim_time_us"])


# -- the step budget -----------------------------------------------------------

def _budget_cases():
    """(name, port grid, port cfg, ref grid, ref cfg, slot_us)."""
    out = []
    for name in PARITY_CASES:
        pts_p, pts_r, cfg_p, cfg_r, slot_us = _parity_case(name)
        out.append((name, SweepGrid.of_points(pts_p), cfg_p, RefGrid.of_points(pts_r), cfg_r,
                    slot_us))
    # sweep_frontier's lattice (benchmarks/sweep_frontier.py:73-84) and
    # benchmarks/stepping.py's grid (:44-51), at their full durations
    lattice = dict(t_s_us=np.linspace(3.0, 80.0, 14), t_l_us=[120.0, 250.0, 500.0, 900.0],
                   m=(2, 3, 4), rate_mpps=np.asarray([0.1, 0.25, 0.4, 0.55, 0.7, 0.85]) * 29.76,
                   seeds=(0, 1))
    out.append(("sweep_frontier", SweepGrid.product(**lattice), SimRunConfig(duration_us=5e4),
                RefGrid.product(**lattice), RefConfig(duration_us=5e4), 0.5))
    pts = [dict(t_s_us=50.0, t_l_us=500.0, m=3, n_queues=2, rate_mpps=0.2 * 29.76, seed=s)
           for s in range(48)]
    out.append(("stepping", SweepGrid.of_points(pts),
                SimRunConfig(duration_us=120_000.0, sleep_model=HR_SLEEP_MODEL),
                RefGrid.of_points(pts), RefConfig(duration_us=120_000.0, sleep_model=REF_HR),
                0.5))
    return out


@pytest.mark.parametrize("case", _budget_cases(), ids=lambda c: c[0])
def test_step_budget_is_the_references(case):
    """``estimate_adaptive_steps`` and the bucketed budget (``max_steps``,
    the sweep's ``scan_len``) equal the reference's, and the budget is the
    grid's maximum, whatever point sets it."""
    from repro.runtime.batched import bucket_steps as ref_bucket

    _, grid, cfg, ref_grid, ref_cfg, slot_us = case
    n_win = int(math.ceil(cfg.duration_us / cfg.window_us)) if cfg.window_us > 0 else 0
    est = batched_adaptive.estimate_adaptive_steps(grid, cfg, slot_us, n_win)
    assert est == ref_adaptive.estimate_adaptive_steps(ref_grid, ref_cfg, slot_us, n_win)
    _, params = batched_adaptive.adaptive_sweep_inputs(grid, cfg, slot_us, CPU)
    assert params.max_steps == ref_bucket(est)
    assert params.steps == params.max_steps


# -- the Philox contract's streams for the event-jump sweep --------------------

def test_step_draws_follow_the_contract():
    """Each family of the event-jump sweep sits on its stream, block and
    lane of the contract, with the counter's fourth word 1 (the fixed-slot
    sweep's is 0, so the two never share a draw); points that share a seed
    share every draw; a lane does not depend on how many are drawn."""
    lo = torch.tensor([5, 5, 6, 5], dtype=torch.int32)
    hi = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    d = step_philox.StepDraws(lo, hi, m=3, q=2, sigma=True, tail=True, intf=True, stall=True)
    c = d.chunk(10, 20)
    init = d.initial()
    assert set(c) == {"z_q", "z_m", "tail_u", "tail_e", "intf_u", "intf_e", "stall_len_e",
                      "stall_gap_e", "stall_jitter"}
    assert set(init) == {"sleep_u", "stall_e"}
    for v in (*c.values(), *(x[None] for x in init.values())):
        assert torch.equal(v[:, 0], v[:, 1])
        assert not torch.equal(v[:, 0], v[:, 2]) and not torch.equal(v[:, 0], v[:, 3])

    def words(stream, block, step=13, k0=5, k1=0):
        return philox.philox4x32_10(torch.tensor([step]), stream, block, 1, k0, k1)

    same = dict(rtol=0, atol=0)
    torch.testing.assert_close(c["z_q"][3, 0],
                               philox.lanes(words(step_philox.NORMAL, 0), "z", 2)[0], **same)
    torch.testing.assert_close(c["z_m"][3, 0],
                               philox.lanes(words(step_philox.NORMAL, 1), "z", 3)[0], **same)
    torch.testing.assert_close(c["tail_u"][3, 0],
                               philox.lanes(words(step_philox.TAIL, 0), "u", 3)[0], **same)
    torch.testing.assert_close(c["intf_e"][3, 0],
                               philox.lanes(words(step_philox.INTF, 1), "e", 3)[0], **same)
    st = words(step_philox.STALL, 0, k0=6)
    assert c["stall_len_e"][3, 2] == philox.exponential(philox.uniform(st[0]))[0]
    assert c["stall_gap_e"][3, 2] == philox.exponential(philox.uniform(st[1]))[0]
    torch.testing.assert_close(c["stall_jitter"][3, 0],
                               philox.lanes(words(step_philox.STALL, 1), "u", 3)[0], **same)
    torch.testing.assert_close(init["sleep_u"][3],
                               philox.lanes(words(step_philox.INIT, 0, 0, 5, 1), "u", 3)[0],
                               **same)
    st0 = words(step_philox.INIT, 1, 0, 6, 0)
    assert init["stall_e"][2] == philox.exponential(philox.uniform(st0[0]))[0]
    # the fixed-slot sweep's normals of the same step and key differ
    fixed = philox.SlotDraws(lo, hi, m=3, q=2, sigma=True, tail=False, intf=False,
                             stall=False).chunk(10, 20)
    assert not torch.equal(fixed["z_q"], c["z_q"])
    # a lane does not depend on how many lanes are drawn
    d4 = step_philox.StepDraws(lo, hi, m=4, q=4, sigma=True, tail=True, intf=True, stall=True)
    c4 = d4.chunk(10, 20)
    for k in ("z_m", "tail_e", "stall_jitter"):
        torch.testing.assert_close(c4[k][..., :3], c[k], **same)
    torch.testing.assert_close(c4["z_q"][..., :2], c["z_q"], **same)


# -- the sweep's exact invariants (Philox draws) -------------------------------

def _mixed_points(n=8, seed=4):
    rng = np.random.default_rng(seed)
    return [dict(t_s_us=(t_s := float(rng.uniform(5.0, 50.0))),
                 t_l_us=float(t_s * rng.uniform(4.0, 20.0)), m=int(rng.integers(1, 5)),
                 n_queues=int(rng.integers(1, 4)),
                 rate_mpps=float(rng.uniform(0.1, 0.8) * 29.76), seed=2000 + i)
            for i in range(n)]


@pytest.mark.parametrize("em", (DEFAULT_ENERGY_MODEL, DEEP_CSTATE_ENERGY_MODEL),
                         ids=("default", "deep"))
def test_sweep_conserves_packets_windows_energy_and_time(em):
    """offered = served + dropped + final backlog, the windows sum to the
    totals, energy = active power x awake + per-arm charges, all to float32
    rounding (each side a float32 sum over the run's n steps, within n *
    2^-24 of its size); and the simulated time is the duration exactly."""
    cfg = SimRunConfig(duration_us=2_500.0, sleep_model=HR_SLEEP_MODEL, window_us=250.0,
                       energy_model=em, queue_capacity=128, **NOISY)
    bs = simulate_batch(SweepGrid.of_points(_mixed_points()), cfg, stepping="adaptive",
                        device="cpu")
    rel = float(bs.n_steps.max()) * 2.0**-24
    assert float(bs.dropped.sum()) > 0 and float(bs.busy_tries.sum()) > 0
    np.testing.assert_allclose(bs.offered, bs.serviced + bs.dropped + bs.final_backlog,
                               rtol=rel)
    for col, name in enumerate(("offered", "serviced", "lat_area", "awake_us", "energy_uj")):
        np.testing.assert_allclose(bs.win[:, :, col].sum(1), getattr(bs, name), rtol=rel,
                                   err_msg=name)
    arm_s = np.array([em.arm_energy_uj(t) for t in bs.grid.t_s_us])
    arm_l = np.array([em.arm_energy_uj(t) for t in bs.grid.t_l_us])
    pred = em.active_power_w * bs.awake_us + bs.ts_arms * arm_s + bs.busy_tries * arm_l
    np.testing.assert_allclose(bs.energy_uj, pred, rtol=rel)
    assert np.all(bs.sim_time_us == np.float64(np.float32(cfg.duration_us)))
    assert np.all(bs.n_steps <= bs.scan_len) and np.all(bs.forced_steps == 0)
    for name in ("wakeups", "busy_tries", "cycles", "ts_arms", "n_steps"):
        assert np.array_equal(getattr(bs, name), np.round(getattr(bs, name)))


def test_a_point_depends_on_its_batch_only_through_the_budget():
    """A point's lanes past its m and n_queues add exact zeros and its draws
    depend on its seed alone, so alone (with the batch's step budget) or
    inside a batch padded to four threads and four queues it gives the same
    numbers; the budget itself is the grid's (the reference's tail pacing
    reads it), so a point alone gets a smaller one."""
    pts = _mixed_points(6)
    cfg = SimRunConfig(duration_us=600.0, sleep_model=SleepModel(**TAIL_SLEEP), **NOISY)
    grid = SweepGrid.of_points(pts)
    args, params = batched_adaptive.adaptive_sweep_inputs(grid, cfg, 0.5, CPU)
    batch = reference_adaptive_sweep(*args, params)
    for i in (0, 3):
        one = SweepGrid.of_points([pts[i]])
        one_args, one_params = batched_adaptive.adaptive_sweep_inputs(one, cfg, 0.5, CPU)
        assert one_params.max_steps <= params.max_steps
        out = reference_adaptive_sweep(*one_args, params)
        for name in (*SUM_NAMES, "backlog", "sim_time"):
            assert out[name][0] == batch[name][i], name


def test_a_prefix_of_the_run_is_the_runs_first_steps():
    """``run_steps`` stops every point after that many steps (the chip
    check bisects a divergence with it): n steps then the rest equals the
    whole run, step counts and time add up, and the budget's pacing does not
    move."""
    import dataclasses

    pts = _mixed_points(4)
    cfg = SimRunConfig(duration_us=800.0, sleep_model=SleepModel(**TAIL_SLEEP), **NOISY)
    args, params = batched_adaptive.adaptive_sweep_inputs(SweepGrid.of_points(pts), cfg, 0.5,
                                                          CPU)
    full = reference_adaptive_sweep(*args, params)
    n = int(full["n_steps"].max())
    cut = reference_adaptive_sweep(*args, dataclasses.replace(params, run_steps=n // 2))
    assert torch.equal(cut["n_steps"], full["n_steps"].clamp(max=n // 2))
    assert bool((cut["sim_time"] < full["sim_time"]).any())
    same = reference_adaptive_sweep(*args, dataclasses.replace(params, run_steps=n))
    for name in (*SUM_NAMES, "backlog", "sim_time"):
        assert torch.equal(same[name], full[name]), name


# -- the port's own surface ----------------------------------------------------

def test_cpu_runs_the_plain_version_and_cuda_never_falls_back():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; asked for CUDA where there is none, simulate_batch raises."""
    grid = SweepGrid.of_points(_mixed_points(3))
    cfg = SimRunConfig(duration_us=300.0)
    launches, by_build = adaptive_sweep.launches, dict(adaptive_sweep.launches_by_build)
    bs = simulate_batch(grid, cfg, stepping="adaptive", device="cpu")
    assert adaptive_sweep.launches == launches
    assert adaptive_sweep.launches_by_build == by_build
    args, params = batched_adaptive.adaptive_sweep_inputs(grid, cfg, 0.5, CPU)
    plain = reference_adaptive_sweep(*args, params)
    for name in SUM_NAMES:
        np.testing.assert_array_equal(getattr(bs, name), plain[name].double().numpy())
    assert bs.stepping == "adaptive" and bs.scan_len == params.max_steps
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            simulate_batch(grid, cfg, stepping="adaptive")   # device defaults to "cuda"
        assert adaptive_sweep.launches == launches


def test_kernel_bounds_are_checked():
    cfg = SimRunConfig(duration_us=10.0)
    with pytest.raises(ValueError, match="m <= 4"):
        simulate_batch(SweepGrid.of_points([dict(m=6)]), cfg, stepping="adaptive",
                       device="cpu")
    with pytest.raises(ValueError, match="n_queues <= 4"):
        simulate_batch(SweepGrid.of_points([dict(m=2, n_queues=5)]), cfg, stepping="adaptive",
                       device="cpu")


def test_source_constants_match_the_binding():
    """The kernel's source takes the binding's 21 float constants, in its
    order, and the reference's boundary epsilons."""
    from pathlib import Path

    from repro_torch.kernels.adaptive_sweep import kernel

    src = (Path(kernel.__file__).parents[1] / "csrc" / "adaptive_sweep.cu").read_text()
    assert f"constexpr int kNumFParams = {len(kernel._FPARAMS)};" in src
    fields = ("floor, duration, mu, inv_mu, cap, cap_fill, wake_cost, base, sigma, slope1;"
              "tail_prob, tail_mean, intf_prob, intf_mean, inv_stall, stall_mean;"
              "active_power, window, inv_window, steps_f, tail_steps;")
    struct = "".join(ln.strip().removeprefix("float ") for ln in src.splitlines()
                     if ln.strip().startswith("float ") and ln.strip().endswith(";")
                     and "," in ln)[:len(fields)]
    assert struct == fields
    for i, name in enumerate(kernel._FPARAMS):
        member = {"steps": "steps_f"}.get(name, name)
        assert f"P.{member} = f[{i}];" in src, name
    assert "kRateEps = 1e-9f" in src and "kWakeEps = 1e-6f" in src
    assert ref_adaptive._RATE_EPS == 1e-9 and ref_adaptive._WAKE_EPS_US == 1e-6


# -- the kernel's ring ------------------------------------------------------------

SMEM_PER_BLOCK = 232_448     # the shared memory a block can use on an H100 (227 KB)
STAGE = adaptive_kernel.STAGE_STEPS
# budgets one under, at and one over a stage, and inside the fifth stage (the
# ring of three stages wraps)
EDGE_BUDGETS = (STAGE - 1, STAGE, STAGE + 1, 4 * STAGE + 13)


def _noise(params, sigma, tail, intf, stall):
    return dataclasses.replace(params, sigma_us=0.5 * sigma, tail_prob=0.01 * tail,
                               interference_prob=0.25 * intf,
                               stall_rate_per_us=stall / 400.0)


def test_ring_layout_matches_the_kernel_source():
    """The Python side's ring (``kernel.STAGES``, ``STAGE_STEPS`` and
    ``layout``) is the source's: its constants, a step's fields (the
    queues' normals, the threads' overshoots and, with stalls on, the
    window's length and gap and the threads' jitters) and the bytes; and
    the ring fits a block's shared memory in both builds with every noise
    family on or off."""
    src = (Path(adaptive_kernel.__file__).parents[1] / "csrc" / "adaptive_sweep.cu").read_text()
    flat = " ".join(src.split())

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kStageSteps") == adaptive_kernel.STAGE_STEPS
    assert const("kStages") == adaptive_kernel.STAGES
    assert const("kPoints") == 32
    for line in ("static constexpr int kZ = 0, kOver = QQ, kLen = QQ + MM, kGap = QQ + MM + 1, "
                 "kJit = QQ + MM + 2;",
                 "return (flags & kStallOn) ? kJit + MM : kLen;",
                 "return kStageSteps * fields(flags) * kPoints;",
                 "return sizeof(float) * (size_t)kStages * stage_floats(flags);"):
        assert line in flat, line
    grid = SweepGrid.of_points(_mixed_points(2))
    _, base = batched_adaptive.adaptive_sweep_inputs(grid, SimRunConfig(duration_us=50.0), 0.5,
                                                     CPU)
    stages, steps = const("kStages"), const("kStageSteps")
    for bits in range(16):
        fl = [bool(bits >> k & 1) for k in range(4)]
        params = _noise(base, *fl)
        assert list(params.flags.values()) == fl
        for q_max in (1, 4):
            fields = q_max + 4 + (2 + 4 if fl[3] else 0)
            lay = adaptive_kernel.layout(params, q_max)
            want = {"stages": stages, "stage_steps": steps, "fields": fields,
                    "smem_bytes": 4 * stages * steps * fields * 32}
            assert lay == want, (fl, q_max)
            assert lay["smem_bytes"] <= SMEM_PER_BLOCK, (fl, q_max)
    # the largest ring: <4, 4> with stalls on, 14 fields a step
    assert adaptive_kernel.layout(_noise(base, 1, 1, 1, 1), 4)["smem_bytes"] == 172_032


def _edge_points():
    """Six mixed points, a step schedule on one and a ramp on another."""
    pts = _mixed_points(6)
    pts[0]["schedule"] = StepSchedule(times_us=(0.0, 570.0), scales=(0.4, 1.5))
    pts[1]["schedule"] = RampSchedule(t_start_us=50.0, t_end_us=1_450.0, scale_from=0.3,
                                      scale_to=1.4)
    return pts


@pytest.mark.parametrize("cut", (False, True), ids=("whole", "run_steps"))
@pytest.mark.parametrize("budget", EDGE_BUDGETS)
def test_plain_version_does_not_depend_on_its_chunk_length(budget, cut, monkeypatch):
    """What the kernel's producers rely on: a step's state-free values
    (``_step_inputs``) depend on the step alone, so they can be made ahead
    of the jumps for any run of steps.  The plain version gives the same
    bits with them made 16 steps at a time (half a stage of the ring), 20
    (a split inside a stage) and all at once, every noise family on, with
    schedules and windows, at budgets on the ring's edges (the budget's
    tail paces every point) and with ``run_steps`` ending inside a stage."""
    cfg = SimRunConfig(duration_us=2_000.0, sleep_model=SleepModel(**TAIL_SLEEP),
                       window_us=400.0, queue_capacity=128, **NOISY)
    pts = _edge_points()
    args, params = batched_adaptive.adaptive_sweep_inputs(SweepGrid.of_points(pts), cfg, 0.5,
                                                          CPU)
    params = dataclasses.replace(params, max_steps=budget,
                                 run_steps=budget - 5 if cut else None)
    assert all(params.flags.values()) and args[7] is not None and params.n_windows == 5
    outs = []
    for chunk in (16, 20, None):
        if chunk is not None:
            monkeypatch.setattr(adaptive_ops, "_CHUNK_ELEMS", chunk * len(pts))
        else:
            monkeypatch.undo()
        outs.append(reference_adaptive_sweep(*args, params))
    n, sim_time = outs[0]["n_steps"], outs[0]["sim_time"]
    assert float(n.max()) == params.steps       # the run reaches the ring's edge
    if cut:
        assert bool((sim_time[n == params.steps] < np.float32(cfg.duration_us)).all())
    else:
        assert float(outs[0]["forced_steps"].sum()) > 0
        assert bool((sim_time == np.float32(cfg.duration_us)).all())
    for out in outs[1:]:
        for name in (*SUM_NAMES, "win", "backlog", "sim_time"):
            assert torch.equal(out[name], outs[0][name]), name


def _early_stop_points(one_queue):
    """96 points in three warps, each but point 7 with T_S of 100-200 us and
    one thread, and point 7 with T_S 1 us and four threads: under a budget
    of ``EARLY_STOP_BUDGET`` steps, point 7 is paced by the budget's tail
    and every other point (warps 1 and 2 as a whole) stops more than three
    stages of the kernel's ring before the budget ends."""
    rng = np.random.default_rng(11)
    pts = []
    for i in range(96):
        busy = i == 7
        q = 1 if one_queue else int(rng.integers(1, 5))
        pts.append(dict(t_s_us=1.0 if busy else float(rng.uniform(100.0, 200.0)),
                        t_l_us=float(rng.uniform(200.0, 600.0)), m=4 if busy else 1,
                        n_queues=q,
                        rate_mpps=float((0.8 if busy else rng.uniform(0.05, 0.3)) * 29.76
                                        * q / 2.0),
                        seed=int(rng.integers(0, 5))))
    return pts


EARLY_STOP_BUDGET = 6 * STAGE


# -- the kernel on the card ------------------------------------------------------

EDGE_POINTS = (1, 5, 33)            # a lone lane, a partial warp, a warp and one more


@pytest.mark.gpu
def test_kernel_equals_plain_version_on_the_card():
    """Every output bit-equal to the plain version: the parity cases (both
    builds), the warp edges, a budget short enough for tail pacing, the
    ring's edges (budgets on a stage's edges, ``run_steps`` ending inside a
    stage) and the early stop (warps whose every point finishes more than
    three stages before the budget's end, and one paced lane among them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU mode")
    # (grid, cfg, slot_us, AdaptiveParams fields replaced, whether the
    # budget's tail paces a step).  Two of the slots of 10 us pace none, as
    # the plain version (the kernel's before this design too) counts it:
    # the tail-pacing case with one queue a point and the lone point of the
    # warp edges finish inside their 157-step budget's first seven eighths
    cases = []
    for name in PARITY_CASES:
        pts_p, _, cfg, _, slot_us = _parity_case(name)
        cases.append((SweepGrid.of_points(pts_p), cfg, slot_us, {}, slot_us == 10.0))
        cases.append((SweepGrid.of_points([dict(p, n_queues=1) for p in pts_p]), cfg, slot_us,
                      {}, False))
    pts_p, _, cfg, _, _ = _parity_case("noisy")
    for n in EDGE_POINTS:
        cases.append((SweepGrid.of_points((pts_p * 3)[:n]), cfg, 0.5, {}, False))
        cases.append((SweepGrid.of_points((pts_p * 3)[:n]), cfg, 10.0, {}, n > 1))
    for pts in (pts_p, [dict(p, n_queues=1) for p in pts_p]):
        for budget in EDGE_BUDGETS:
            cases.append((SweepGrid.of_points(pts), cfg, 0.5, {"max_steps": budget}, True))
            cases.append((SweepGrid.of_points(pts), cfg, 0.5,
                          {"max_steps": 10 * budget, "run_steps": budget}, False))
    quiet = _parity_case("quiet")[2]
    for one_queue in (False, True):
        for c in (quiet, cfg):
            cases.append((SweepGrid.of_points(_early_stop_points(one_queue)), c, 0.5,
                          {"max_steps": EARLY_STOP_BUDGET}, True))
    for grid, c, slot_us, replace, paces in cases:
        args, params = batched_adaptive.adaptive_sweep_inputs(grid, c, slot_us, "cuda")
        params = dataclasses.replace(params, **replace)
        launches = adaptive_sweep.launches
        out = adaptive_sweep(*args, params=params)
        assert adaptive_sweep.launches == launches + 1
        plain = reference_adaptive_sweep(*args, params)
        if paces:
            assert float(plain["forced_steps"].sum()) > 0, (len(grid), slot_us, replace)
        if len(grid) == 96:
            n = plain["n_steps"].cpu()
            assert float(n[7]) > EARLY_STOP_BUDGET - EARLY_STOP_BUDGET // 8
            assert float(plain["forced_steps"][7]) > 0
            assert float(torch.cat([n[:7], n[8:]]).max()) < EARLY_STOP_BUDGET - 3 * STAGE
        for name in (*SUM_NAMES, "win", "backlog", "sim_time"):
            assert torch.equal(out[name], plain[name]), (len(grid), slot_us, replace, name)
