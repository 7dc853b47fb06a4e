"""The port's fixed-slot sweep: the ``slot_sweep`` kernel's module and
``repro_torch.runtime.batched`` on the CPU, where ``slot_sweep`` runs its
plain version (``kernels/slot_sweep/ops.py:reference_slot_sweep``), and
on the card (``gpu``).

The port draws its noise from a Philox contract, the reference from jax's
threefry, so equal grids give other sample paths.  Exact parity is held
through the noise instead: ``ReplayDraws`` derives the reference's own
draws with ``jax.random`` exactly as ``src/repro/runtime/batched.py`` does
(:556-561, :573-581, :587-588, :617-628, :644) and feeds them to the plain
version through its draw-provider argument; the result must then be the
reference ``simulate_batch``'s.  Integer counters (wakeups, busy tries,
cycles, T_S arms) must be equal; float sums agree to 1e-5 relative (both
sides make the same float32 operations; XLA may sum a point's queues in
another order, which moves a sum by ~1e-7 relative).

Then the Philox contract against Random123's known answers, the sweep's
exact invariants, the port's own surface (no fallback from CUDA, the
kernel's bounds, the adaptive stepping's refusal, the reference's
engine-parity drift guard) and, on the card, the kernel against its plain
version: counters equal, sums within 1e-5."""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import SimRunConfig as RefConfig
from repro.runtime import SweepGrid as RefGrid
from repro.runtime import simulate_batch as ref_simulate_batch
from repro.runtime.schedule import RampSchedule as RefRamp
from repro.runtime.schedule import StepSchedule as RefStep
from repro.runtime.simcore import DEEP_CSTATE_ENERGY_MODEL as REF_DEEP
from repro.runtime.simcore import HR_SLEEP_MODEL as REF_HR
from repro.runtime.simcore import PERFECT_SLEEP_MODEL as REF_PERFECT
from repro.runtime.simcore import SleepModel as RefSleepModel
from repro_torch.kernels.slot_sweep import kernel as sweep_kernel
from repro_torch.kernels.slot_sweep import ops as sweep_ops
from repro_torch.kernels.slot_sweep import philox, slot_sweep
from repro_torch.kernels.slot_sweep.ops import STAT_NAMES, reference_slot_sweep
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
from repro_torch.runtime import batched
from repro_torch.runtime.simcore import PERFECT_SLEEP_MODEL

CPU = torch.device("cpu")
COUNTERS = ("wakeups", "busy_tries", "cycles", "ts_arms")
SUMS = ("offered", "dropped", "serviced", "awake_us", "lat_area", "vac_sum", "nv_sum",
        "energy_uj", "final_backlog")
RTOL = 1e-5

# the noisy-host environment of tests/test_batched_engine.py's interference
# band, with stalls 10x as frequent so that a short run opens some
NOISY = dict(interference_prob=0.25, interference_mean_us=20.0,
             stall_rate_per_us=1.0 / 400.0, stall_mean_us=150.0)
TAIL_SLEEP = dict(base_us=2.8, slope=0.027, sigma_us=0.5, tail_prob=0.01, tail_mean_us=40.0)


# -- the reference's draws, replayed into the plain version --------------------

class ReplayDraws:
    """The reference kernel's draws for ``grid`` (per point, per slot), in
    the form ``reference_slot_sweep`` consumes (``philox.SlotDraws``)."""

    def __init__(self, grid, cfg, slot_us, n_slots):
        m, q = int(grid.m.max()), int(grid.n_queues.max())
        tail = cfg.sleep_model.tail_prob > 0.0
        intf = cfg.interference_prob > 0.0
        stall = bool(cfg.stall_rate_per_us) and 1.0 - math.exp(
            -cfg.stall_rate_per_us * slot_us) > 0.0

        def point(lo, hi):
            key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), lo), hi)
            key, k0 = jax.random.split(key)

            def slot(t):
                kt = jax.random.fold_in(key, t)
                if tail:
                    kt, kp, ku = jax.random.split(kt, 3)
                if intf:
                    kt, kip, kie = jax.random.split(kt, 3)
                if stall:
                    kt, ksp, kse, ksu = jax.random.split(kt, 4)
                zs = jax.random.normal(kt, (q + m,))
                d = {"z_q": zs[:q], "z_m": zs[q:]}
                if tail:
                    d["tail_u"] = jax.random.uniform(kp, (m,))
                    d["tail_e"] = jax.random.exponential(ku, (m,))
                if intf:
                    d["intf_u"] = jax.random.uniform(kip, (m,))
                    d["intf_e"] = jax.random.exponential(kie, (m,))
                if stall:
                    d["stall_u"] = jax.random.uniform(ksp, ())
                    d["stall_e"] = jax.random.exponential(kse, ())
                    d["stall_jitter"] = jax.random.uniform(ksu, (m,))
                return d

            return jax.random.uniform(k0, (m,)), jax.vmap(slot)(
                jnp.arange(n_slots, dtype=jnp.int32))

        seed64 = np.asarray(grid.seed, dtype=np.uint64)
        lo = jnp.asarray((seed64 & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        hi = jnp.asarray((seed64 >> np.uint64(32)).astype(np.uint32))
        u0, d = jax.jit(jax.vmap(point))(lo, hi)
        self.u0 = torch.tensor(np.asarray(u0))
        # (P, T, ...) -> (T, P, ...)
        self.d = {k: torch.tensor(np.asarray(v)).transpose(0, 1).contiguous()
                  for k, v in d.items()}

    def initial(self):
        return self.u0

    def chunk(self, t0, t1):
        return {k: v[t0:t1] for k, v in self.d.items()}


def _replayed_sweep(ref_grid, ref_cfg, grid, cfg, slot_us):
    """The port's plain sweep of ``grid`` in ``cfg`` on the CPU, drawing the
    reference's noise for ``ref_grid`` in ``ref_cfg`` -> ``BatchStats``."""
    draws = ReplayDraws(ref_grid, ref_cfg, slot_us, math.ceil(ref_cfg.duration_us / slot_us))
    args, params = batched.sweep_inputs(grid, cfg, slot_us, CPU)
    out = reference_slot_sweep(*args, params, draws)
    return batched.stats_from_outputs(grid, cfg, slot_us, params, out)


def _multi_points(seed, schedules=()):
    """Every (m, n_queues) pair in 1..4 x 1..4, knobs drawn from a seed;
    seeds repeat so that points share draws."""
    rng = np.random.default_rng(seed)
    pts = []
    for m in (1, 2, 3, 4):
        for q in (1, 2, 3, 4):
            pts.append(dict(t_s_us=float(rng.uniform(4.0, 40.0)),
                            t_l_us=float(rng.uniform(100.0, 600.0)), m=m, n_queues=q,
                            rate_mpps=float(rng.uniform(0.1, 0.9) * 29.76 * q / 2.0),
                            seed=int(rng.integers(0, 3))))
    for i, s in enumerate(schedules):
        pts[i]["schedule"] = s
    return pts


def _parity_case(name):
    """(points for the port, points for the reference, port cfg, ref cfg)."""
    dur = 1_500.0
    if name == "quiet":
        kw_p = kw_r = dict(duration_us=dur)
        sl_p, sl_r = HR_SLEEP_MODEL, REF_HR
        pts_p = pts_r = _multi_points(1)
    elif name == "perfect timers":          # no overshoot noise at all
        kw_p = kw_r = dict(duration_us=dur, queue_capacity=32)
        sl_p, sl_r = PERFECT_SLEEP_MODEL, REF_PERFECT
        pts_p = pts_r = _multi_points(4)
    elif name == "noisy":
        kw_p = kw_r = dict(duration_us=dur, queue_capacity=64, **NOISY)
        sl_p, sl_r = SleepModel(**TAIL_SLEEP), RefSleepModel(**TAIL_SLEEP)
        pts_p = pts_r = _multi_points(2)
    else:          # "scheduled": per-point schedules, windows, a deep energy model
        kw_p = dict(duration_us=dur, window_us=130.0, energy_model=DEEP_CSTATE_ENERGY_MODEL)
        kw_r = dict(kw_p, energy_model=REF_DEEP)
        sl_p, sl_r = HR_SLEEP_MODEL, REF_HR
        pts_p = _multi_points(3, [StepSchedule(times_us=(0.0, 600.0), scales=(0.3, 1.6)),
                                  RampSchedule(t_start_us=200.0, t_end_us=1_200.0,
                                               scale_from=0.2, scale_to=1.5)] * 4)
        pts_r = _multi_points(3, [RefStep(times_us=(0.0, 600.0), scales=(0.3, 1.6)),
                                  RefRamp(t_start_us=200.0, t_end_us=1_200.0,
                                          scale_from=0.2, scale_to=1.5)] * 4)
    return (pts_p, pts_r, SimRunConfig(sleep_model=sl_p, **kw_p),
            RefConfig(sleep_model=sl_r, **kw_r))


@pytest.mark.parametrize("case", ["quiet", "perfect timers", "noisy", "scheduled"])
def test_plain_sweep_on_replayed_draws_equals_reference(case):
    pts_p, pts_r, cfg_p, cfg_r = _parity_case(case)
    slot_us = 0.5
    ref = ref_simulate_batch(RefGrid.of_points(pts_r), cfg_r, slot_us=slot_us)
    port = _replayed_sweep(RefGrid.of_points(pts_r), cfg_r, SweepGrid.of_points(pts_p),
                           cfg_p, slot_us)
    assert float(ref.wakeups.sum()) > 100      # the run exercises the claim logic
    if case == "noisy":
        assert float(ref.dropped.sum()) > 0 and float(ref.busy_tries.sum()) > 0
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    for name in SUMS:
        np.testing.assert_allclose(getattr(port, name), getattr(ref, name), rtol=RTOL,
                                   atol=1e-3, err_msg=name)
    assert port.win.shape == ref.win.shape
    if ref.win.size:
        np.testing.assert_allclose(port.win, ref.win, rtol=RTOL, atol=1e-3)
    for name in ("scan_len", "stepping"):
        assert getattr(port, name) == getattr(ref, name)
    np.testing.assert_array_equal(port.n_steps, ref.n_steps)
    np.testing.assert_array_equal(port.sim_time_us, ref.sim_time_us)


# -- the Philox contract -------------------------------------------------------

_M0, _M1, _W0, _W1, _MASK = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85, 0xFFFFFFFF
# Random123's published known answers for philox4x32_10 (kat_vectors):
# (counter, key, result)
KAT = (
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((_MASK,) * 4, (_MASK, _MASK), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
)


def _philox_int(c, k):
    """Philox4x32-10 in Python integers."""
    c, (k0, k1) = list(c), k
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        p0, p1 = _M0 * c[0], _M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & _MASK, (p0 >> 32) ^ c[3] ^ k1, p0 & _MASK]
    return tuple(c)


@pytest.mark.parametrize("ctr,key,want", KAT, ids=("zeros", "ones", "pi"))
def test_philox_meets_random123_known_answers(ctr, key, want):
    assert _philox_int(ctr, key) == want
    got = philox.philox4x32_10(*(torch.tensor([w]) for w in (*ctr, *key)))
    assert tuple(int(w[0]) for w in got) == want


def test_plain_philox_equals_integer_philox():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(6, 500), dtype=np.uint64)
    cols = [torch.tensor(w.astype(np.int64)) for w in words]
    got = torch.stack(philox.philox4x32_10(*cols), 1).tolist()
    want = [list(_philox_int(words[:4, j].tolist(), words[4:, j].tolist()))
            for j in range(500)]
    assert got == want


def test_transforms_follow_the_contract():
    w = torch.tensor([0, 255, 256, 0xFFFFFF00, _MASK, 0x80000000], dtype=torch.int64)
    u = philox.uniform(w)
    assert u.dtype == torch.float32
    assert u.tolist() == [0.0, 0.0, 2.0**-24, 1.0 - 2.0**-24, 1.0 - 2.0**-24, 0.5]
    e = philox.exponential(u)
    assert torch.isfinite(e).all() and (e >= 0).all()
    assert e[0] == 0.0 and e[4] == -torch.log(torch.tensor(2.0**-24))
    z0, z1 = philox.box_muller(u[:3], u[3:])
    r = torch.sqrt(-2.0 * torch.log(1.0 - u[:3]))
    torch.testing.assert_close(z0 * z0 + z1 * z1, r * r)
    # the lanes of a block: normals pair words (0, 1) and (2, 3); a lane
    # does not depend on how many lanes are drawn
    blk = philox.philox4x32_10(torch.arange(4), 1, 0, 0, 7, 9)
    z = philox.lanes(blk, "z", 4)
    a, b = philox.box_muller(philox.uniform(blk[2]), philox.uniform(blk[3]))
    torch.testing.assert_close(z[:, 2:], torch.stack([a, b], -1), rtol=0, atol=0)
    torch.testing.assert_close(philox.lanes(blk, "z", 3), z[:, :3], rtol=0, atol=0)
    torch.testing.assert_close(philox.lanes(blk, "e", 2), philox.lanes(blk, "e", 4)[:, :2],
                               rtol=0, atol=0)


def test_draws_follow_the_seed_not_the_point():
    """Common random numbers: points that share a seed share every draw;
    the seed's high word matters; each family sits on its stream and block
    of the contract."""
    lo = torch.tensor([5, 5, 6, 5], dtype=torch.int32)
    hi = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    d = philox.SlotDraws(lo, hi, m=3, q=2, sigma=True, tail=True, intf=True, stall=True)
    c = d.chunk(10, 20)
    assert set(c) == {"z_q", "z_m", "tail_u", "tail_e", "intf_u", "intf_e", "stall_u",
                      "stall_e", "stall_jitter"}
    for v in (*c.values(), d.initial()[None]):
        assert torch.equal(v[:, 0], v[:, 1])
        assert not torch.equal(v[:, 0], v[:, 2]) and not torch.equal(v[:, 0], v[:, 3])

    def words(stream, block, slot=13, k0=5, k1=0):
        return philox.philox4x32_10(torch.tensor([slot]), stream, block, 0, k0, k1)

    same = dict(rtol=0, atol=0)
    torch.testing.assert_close(c["z_q"][3, 0], philox.lanes(words(philox.NORMAL, 0), "z", 2)[0],
                               **same)
    torch.testing.assert_close(c["z_m"][3, 0], philox.lanes(words(philox.NORMAL, 1), "z", 3)[0],
                               **same)
    torch.testing.assert_close(c["intf_e"][3, 0],
                               philox.lanes(words(philox.INTF, 1), "e", 3)[0], **same)
    st = words(philox.STALL, 0, k0=6)
    assert c["stall_u"][3, 2] == philox.uniform(st[0])[0]
    assert c["stall_e"][3, 2] == philox.exponential(philox.uniform(st[1]))[0]
    torch.testing.assert_close(c["stall_jitter"][3, 0],
                               philox.lanes(words(philox.STALL, 1), "u", 3)[0], **same)
    init = philox.philox4x32_10(torch.tensor([0]), philox.INIT, 0, 0, 5, 1)
    torch.testing.assert_close(d.initial()[3], philox.lanes(init, "u", 3)[0], **same)


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
def test_sweep_conserves_packets_windows_and_energy(em):
    """offered = served + dropped + final backlog, the windows sum to the
    totals, and energy = active power x awake + per-arm charges (the
    identity of tests/test_energy.py), all to float32 rounding: each side
    is a float32 sum over the run's n slots, within n * 2^-24 of its size."""
    cfg = SimRunConfig(duration_us=2_500.0, sleep_model=HR_SLEEP_MODEL, window_us=250.0,
                       energy_model=em, queue_capacity=128, **NOISY)
    bs = simulate_batch(SweepGrid.of_points(_mixed_points()), cfg, device="cpu")
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
    assert np.all(bs.energy_per_packet_nj > 0.0) and np.all(bs.mean_power_w > 0.0)
    for name in COUNTERS:                     # counts, exact in float32
        assert np.array_equal(getattr(bs, name), np.round(getattr(bs, name)))


def test_a_point_does_not_depend_on_its_batch():
    """A point's lanes past its m and n_queues add exact zeros, and its
    draws depend on its seed alone: alone or inside a batch padded to four
    threads and four queues, it gives the same numbers."""
    pts = _mixed_points(6)
    cfg = SimRunConfig(duration_us=600.0, sleep_model=SleepModel(**TAIL_SLEEP), **NOISY)
    batch = simulate_batch(SweepGrid.of_points(pts), cfg, device="cpu")
    for i in (0, 3):
        one = simulate_batch(SweepGrid.of_points([pts[i]]), cfg, device="cpu")
        for name in (*STAT_NAMES, "final_backlog"):
            assert getattr(one, name)[0] == getattr(batch, name)[i], name


# -- the port's own surface ----------------------------------------------------

def test_adaptive_stepping_names_the_slice_that_brings_it():
    grid = SweepGrid.of_points([dict(t_s_us=10.0, t_l_us=100.0)])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        simulate_batch(grid, SimRunConfig(duration_us=100.0), stepping="adaptive",
                       device="cpu")


def test_kernel_bounds_are_checked():
    with pytest.raises(ValueError, match="m <= 4"):
        simulate_batch(SweepGrid.of_points([dict(m=6)]), SimRunConfig(duration_us=10.0),
                       device="cpu")
    with pytest.raises(ValueError, match="n_queues <= 4"):
        simulate_batch(SweepGrid.of_points([dict(m=2, n_queues=5)]),
                       SimRunConfig(duration_us=10.0), device="cpu")


def test_cpu_runs_the_plain_version_and_cuda_never_falls_back():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; asked for CUDA where there is none, simulate_batch raises."""
    grid = SweepGrid.of_points(_mixed_points(3))
    cfg = SimRunConfig(duration_us=300.0)
    launches, by_build = slot_sweep.launches, dict(slot_sweep.launches_by_build)
    bs = simulate_batch(grid, cfg, device="cpu")
    assert slot_sweep.launches == launches and slot_sweep.launches_by_build == by_build
    args, params = batched.sweep_inputs(grid, cfg, 0.5, CPU)
    plain = reference_slot_sweep(*args, params)
    for name in STAT_NAMES:
        np.testing.assert_array_equal(getattr(bs, name), plain[name].double().numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            simulate_batch(grid, cfg)          # device defaults to "cuda"
        assert slot_sweep.launches == launches


def test_engine_parity_pass_holds_on_the_port():
    """The reference's drift guard (PARITY001/002) over the port's runtime:
    its batched.py reads or declares every SimRunConfig field."""
    from repro.analysis.core import run_analysis
    from repro.analysis.parity import EngineParityPass

    root = Path(__file__).resolve().parents[1]
    res = run_analysis([root / "src" / "repro_torch" / "runtime"], root=root,
                       passes=[EngineParityPass()])
    assert any(f.rel.endswith("repro_torch/runtime/batched.py") for f in res.files)
    assert not res.findings, [f.format() for f in res.findings]


# -- the edges of the kernel's ring of stages ----------------------------------

# live slot counts around the kernel's stage length C, and one past the
# three-stage ring, ending inside a stage
EDGE_SLOTS = {"C-1": sweep_kernel.STAGE_SLOTS - 1, "C": sweep_kernel.STAGE_SLOTS,
              "C+1": sweep_kernel.STAGE_SLOTS + 1, "4C+13": 4 * sweep_kernel.STAGE_SLOTS + 13}
EDGE_POINTS = (1, 5, 33)            # a lone lane, a partial warp, a warp and one more


def _edge_case(n_points: int, live: str, one_queue: bool):
    """A grid of ``n_points`` and a config with every noise family on (tails
    and stalls frequent enough to reach in a short run) whose run has
    ``EDGE_SLOTS[live]`` slots of 0.5 us, windows of 10.5 slots and
    schedule edges at fractions of a slot, so that both fall inside a
    stage."""
    rng = np.random.default_rng(n_points)
    scheds = (StepSchedule(times_us=(0.0, 7.25), scales=(0.4, 1.5)),
              RampSchedule(t_start_us=3.1, t_end_us=41.3, scale_from=0.3, scale_to=1.4), None)
    pts = []
    for i in range(n_points):
        q = 1 if one_queue else int(rng.integers(1, 5))
        p = dict(t_s_us=(t_s := float(rng.uniform(1.5, 8.0))),
                 t_l_us=float(t_s * rng.uniform(2.0, 6.0)), m=int(rng.integers(1, 5)),
                 n_queues=q, rate_mpps=float(rng.uniform(0.2, 0.95) * 29.76 * q / 2.0),
                 seed=i // 2)
        if scheds[i % 3] is not None:
            p["schedule"] = scheds[i % 3]
        pts.append(p)
    sleep = SleepModel(**dict(TAIL_SLEEP, tail_prob=0.2, tail_mean_us=6.0))
    cfg = SimRunConfig(duration_us=0.5 * EDGE_SLOTS[live], sleep_model=sleep, window_us=5.25,
                       queue_capacity=24, interference_prob=0.25, interference_mean_us=4.0,
                       stall_rate_per_us=1.0 / 40.0, stall_mean_us=6.0)
    return SweepGrid.of_points(pts), cfg


def test_stage_length_matches_the_kernel_source():
    src = (Path(sweep_kernel.__file__).parents[1] / "csrc" / "slot_sweep.cu").read_text()
    assert f"constexpr int kStageSlots = {sweep_kernel.STAGE_SLOTS};" in src


@pytest.mark.parametrize("one_queue", (True, False), ids=("one queue", "up to four"))
@pytest.mark.parametrize("live", tuple(EDGE_SLOTS))
@pytest.mark.parametrize("n_points", EDGE_POINTS)
def test_plain_version_does_not_depend_on_its_chunk_length(n_points, live, one_queue,
                                                           monkeypatch):
    """What the kernel's producers rely on: the state-free part of a run can
    be made for any run of slots (the draws are counter-based, the stall
    end and schedule pointer carry across), so the plain version gives the
    same bits at chunks of 16 slots, of the kernel's stage length and of its
    default, at the ring's edges."""
    grid, cfg = _edge_case(n_points, live, one_queue)
    args, params = batched.sweep_inputs(grid, cfg, 0.5, CPU)
    assert params.live_slots() == EDGE_SLOTS[live]
    assert all(params.flags.values()) and params.n_windows > 1 and args[7] is not None
    outs = []
    for chunk in (16, sweep_kernel.STAGE_SLOTS, None):
        if chunk is not None:
            monkeypatch.setattr(sweep_ops, "_CHUNK_ELEMS", chunk * n_points)
        else:
            monkeypatch.undo()
        outs.append(reference_slot_sweep(*args, params))
    assert float(outs[0]["wakeups"].sum()) > 0
    for out in outs[1:]:
        for name in (*STAT_NAMES, "win", "backlog"):
            assert torch.equal(out[name], outs[0][name]), name


@pytest.mark.gpu
def test_kernel_equals_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU mode")
    pts_p, _, cfg, _ = _parity_case("scheduled")
    # both builds: up to 4 queues a point (<4, 4>), and one (<4, 1>)
    grids = ((SweepGrid.of_points(pts_p), (4, 4)),
             (SweepGrid.of_points([dict(p, n_queues=1) for p in pts_p]), (4, 1)))
    noisy = SimRunConfig(duration_us=1_500.0, sleep_model=SleepModel(**TAIL_SLEEP),
                         window_us=100.0, **NOISY)
    for (grid, build), c in ((g, c) for g in grids for c in (cfg, noisy)):
        args, params = batched.sweep_inputs(grid, c, 0.5, "cuda")
        launches = slot_sweep.launches
        on_build = slot_sweep.launches_by_build.get(build, 0)
        out = slot_sweep(*args, params=params)
        assert slot_sweep.launches == launches + 1
        assert slot_sweep.launches_by_build[build] == on_build + 1
        plain = reference_slot_sweep(*args, params)
        for name in COUNTERS:
            torch.testing.assert_close(out[name], plain[name], rtol=0, atol=0)
        for name in (*STAT_NAMES, "win", "backlog"):
            torch.testing.assert_close(out[name], plain[name], rtol=RTOL, atol=1e-3)
    # the ring's edges, both builds, partial warps: bit for bit
    for n_points, live, one_queue in ((n, lv, oq) for n in EDGE_POINTS for lv in EDGE_SLOTS
                                      for oq in (True, False)):
        grid, c = _edge_case(n_points, live, one_queue)
        args, params = batched.sweep_inputs(grid, c, 0.5, "cuda")
        build = (4, 1) if int(args[3].max()) == 1 else (4, 4)
        on_build = slot_sweep.launches_by_build.get(build, 0)
        out = slot_sweep(*args, params=params)
        assert slot_sweep.launches_by_build[build] == on_build + 1
        plain = reference_slot_sweep(*args, params)
        for name in (*STAT_NAMES, "win", "backlog"):
            assert torch.equal(out[name], plain[name]), (n_points, live, one_queue, name)
