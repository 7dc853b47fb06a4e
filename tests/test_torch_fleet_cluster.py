"""The fleet sweeps' cluster route (257 hosts up to the route's largest H):
``csrc/fleet_sweep.cu`` (S3) and ``csrc/fleet_adaptive_sweep.cu`` (S3b) run
a point as a cluster of 8 blocks, block g holding host lanes 32 g .. 32 g +
31 of ``host_sum``'s W = 256 and its consumer warp k host 32 g + i + 256 k in
lane i.  A reduction over the point's hosts (``cluster_reduce``) folds each
lane's K hosts in turn (the warps' records through the block's shared
memory, warp 0 folding them in k order), runs warp 0's 32-lane butterfly,
pushes the block's partial into every block of the cluster, and every
consumer thread of every block runs the tree over the 8 partials itself.

Here, on the CPU: that exchange mirrored thread by thread (``cluster_tree``)
equals ``host_sum`` and the plain version's stages bit for bit, and leaves
every consumer thread of the cluster with the same record; the routes and
the layout (blocks a point, hosts a lane, shared memory) against the
sources.  On the card (``gpu``): both kernels bit-equal to their plain
versions at 257, 1000 and 1500 hosts, at the route's largest H, and past it
(the scratch route).  This file imports no JAX."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.fleet_adaptive_sweep import kernel as fa_kernel
from repro_torch.kernels.fleet_sweep import kernel as fleet_kernel
from repro_torch.kernels.fleet_sweep.ops import host_lanes, host_sum

CSRC = Path(fleet_kernel.__file__).parents[1] / "csrc"
SOURCES = {"fleet_sweep.cu": fleet_kernel, "fleet_adaptive_sweep.cu": fa_kernel}
SMEM_PER_BLOCK = 232_448     # the shared memory a block can use on an H100 (227 KB)
F32 = np.float32
NO_HOST = 0x7FFFFFFF
G = 8                        # kClusterBlocks
LANES = 32                   # host lanes a block
MAX_H = 256 * max(k.MAX_HOSTS_PER_LANE for k in SOURCES.values())


# -- the exchange, thread by thread -------------------------------------------------

def _before(v, i, w, j):
    return v < w or (v == w and i < j)


def hedge_merge(a, o):
    """``Hedge::merge``: the subtree ``a`` and the one after it, ``o``: the
    two first least-loaded hosts, the first's duplicates (d1), the
    duplicates' sum (full) and that sum with the first's zeroed (excl), the
    far rack's sum."""
    a = dict(a, far=F32(a["far"] + o["far"]))
    if _before(o["v1"], o["i1"], a["v1"], a["i1"]):      # the other holds the first
        mine = _before(a["v1"], a["i1"], o["v2"], o["i2"])
        a["v2"], a["i2"] = (a["v1"], a["i1"]) if mine else (o["v2"], o["i2"])
        a["v1"], a["i1"], a["d1"] = o["v1"], o["i1"], o["d1"]
        a["excl"] = F32(a["full"] + o["excl"])
    else:
        if _before(o["v1"], o["i1"], a["v2"], a["i2"]):
            a["v2"], a["i2"] = o["v1"], o["i1"]
        a["excl"] = F32(a["excl"] + o["full"])
    a["full"] = F32(a["full"] + o["full"])
    return a


def hedge_leaf(h, btot, dup_q, far_adm):
    """``Hedge::leaf``: a live host is its own first least-loaded host; a
    host past H the identity."""
    if h >= len(btot):
        return dict(full=F32(0), excl=F32(0), v1=F32(np.inf), v2=F32(np.inf), d1=F32(0),
                    far=F32(0), i1=NO_HOST, i2=NO_HOST)
    dq = F32(dup_q[h])
    return dict(full=dq, excl=F32(0), v1=F32(btot[h]), v2=F32(np.inf), d1=dq,
                far=F32(far_adm[h]), i1=h, i2=NO_HOST)


# the records' merges (this, then the other) and their leaves
RECORDS = {
    "sum": (lambda a, o: F32(a + o), lambda vals, h: F32(vals[h]) if h < len(vals) else F32(0)),
    "max": (lambda a, o: F32(max(a, o)),
            lambda vals, h: F32(vals[h]) if h < len(vals) else F32(-np.inf)),
    "min2": (lambda a, o: (F32(min(a[0], o[0])), F32(min(a[1], o[1]))),
             lambda vals, h: (F32(vals[0][h]), F32(vals[1][h])) if h < len(vals[0])
             else (F32(np.inf), F32(np.inf))),
}


def cluster_tree(kind, vals, n_hosts):
    """``cluster_reduce`` over one point of ``n_hosts`` hosts, thread by
    thread: block g, consumer warp k, lane i holds host 32 g + i + 256 k
    (its leaf; a host past H the identity); warp 0's lane i folds the K
    warps' records in k order, warp 0 runs the butterfly over offsets 16 ..
    1, its lanes 0-7 push the partial into every block, and every consumer
    thread of every block reads partial (lane mod 8) and runs the butterfly
    over offsets 4, 2, 1.  Returns every consumer thread's result, (block,
    warp, lane)-major."""
    merge, leaf = RECORDS[kind] if kind != "hedge" else (hedge_merge, None)

    def leaf_of(h):
        return leaf(vals, h) if kind != "hedge" else hedge_leaf(h, *vals)

    K = -(-n_hosts // 256)
    partials = []
    for g in range(G):
        warp0 = []
        for i in range(LANES):
            a = leaf_of(32 * g + i)
            for k in range(1, K):
                a = merge(a, leaf_of(32 * g + i + 256 * k))
            warp0.append(a)
        for off in (16, 8, 4, 2, 1):
            prev = list(warp0)
            warp0 = [merge(prev[t], prev[t ^ off]) for t in range(LANES)]
        partials.append(warp0[:G])          # lane r pushes into block r
    out = []
    for g in range(G):
        got = [partials[r][g] for r in range(G)]     # block g's buffer, slot r from block r
        for _warp in range(K):
            lanes = [got[t & (G - 1)] for t in range(LANES)]
            for off in (4, 2, 1):
                prev = list(lanes)
                lanes = [merge(prev[t], prev[t ^ off]) for t in range(LANES)]
            out.extend(lanes)
    return out


def hedge_stage_direct(btot, dup_q, far_adm):
    """The plain version's hedge stage on one point (H > 1): b1 and b2 by
    argmin (the lowest index among equal backlogs), the duplicates to b1 a
    ``host_sum`` with b1's zeroed, b1's own to b2, the far rack's sum by
    ``host_sum``."""
    n = len(btot)
    b = torch.tensor(np.asarray(btot, dtype=np.float32))[None]
    dq = torch.tensor(np.asarray(dup_q, dtype=np.float32))[None]
    b1 = torch.argmin(b, dim=1)
    is_b1 = torch.arange(n)[None] == b1[:, None]
    b2 = torch.argmin(torch.where(is_b1, float("inf"), b), dim=1)
    return dict(b1=int(b1[0]), b2=int(b2[0]),
                to_b1=F32(host_sum(torch.where(is_b1, 0.0, dq))[0]),
                to_b2=F32(dq[0, int(b1[0])]),
                far=F32(host_sum(torch.tensor(np.asarray(far_adm, dtype=np.float32))[None])[0]))


def hedge_stage_result(rec):
    """What the consumer takes from the hedge tree (``consume``)."""
    return dict(b1=rec["i1"], b2=rec["i2"], to_b1=F32(rec["excl"]), to_b2=F32(rec["d1"]),
                far=F32(rec["far"]))


def _alike(out):
    """Every consumer thread's record is the first's; returns it."""
    first = out[0]
    for rec in out[1:]:
        assert rec == first
    return first


def _values(rng, n, pool=None):
    """float32 values over six decades of magnitude, or drawn from ``pool``
    (equal values common)."""
    if pool is not None:
        return rng.choice(np.asarray(pool, dtype=np.float32), n)
    return (rng.uniform(0.0, 1.0, n) * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32)


def _check_point(n_hosts, rng, tie_pool=None):
    """Every record of the route on one point: the sum (``host_sum``), the
    max, the jump's two minima and the hedge stage, each alike in every
    consumer thread of the cluster."""
    x = _values(rng, n_hosts) * rng.choice(np.float32([-1.0, 1.0]), n_hosts)
    got = _alike(cluster_tree("sum", x, n_hosts))
    assert got == F32(host_sum(torch.from_numpy(x)[None])[0]), n_hosts
    xs = -_values(rng, n_hosts, tie_pool)
    assert _alike(cluster_tree("max", xs, n_hosts)) == xs.max()
    wd, fs = _values(rng, n_hosts), _values(rng, n_hosts, tie_pool)
    assert _alike(cluster_tree("min2", (wd, fs), n_hosts)) == (wd.min(), fs.min())
    btot = _values(rng, n_hosts, tie_pool)
    dup_q, far_adm = _values(rng, n_hosts), _values(rng, n_hosts)
    rec = _alike(cluster_tree("hedge", (btot, dup_q, far_adm), n_hosts))
    assert hedge_stage_result(rec) == hedge_stage_direct(btot, dup_q, far_adm), n_hosts


@pytest.mark.parametrize("n_hosts", (257, 300, 511, 512, 513, 1000, 1500, 1792, 2048))
def test_cluster_exchange_equals_host_sum_and_the_plain_stages(n_hosts):
    """The mirrored exchange at the route's edges and the scale row's 1000
    hosts: each lane's hosts in turn, the 32-lane tree, the 8-group tree,
    every record alike in every consumer thread of every block; the sum is
    ``host_sum``'s, bit for bit; the hedge stage is the plain version's,
    also with every backlog equal (b1 = host 0, b2 = host 1)."""
    rng = np.random.default_rng(n_hosts)
    _check_point(n_hosts, rng)
    _check_point(n_hosts, rng, tie_pool=(0.0, 1.0, 2.5))
    equal = np.full(n_hosts, 4.0, np.float32)
    dup_q, far_adm = _values(rng, n_hosts), _values(rng, n_hosts)
    rec = _alike(cluster_tree("hedge", (equal, dup_q, far_adm), n_hosts))
    assert (rec["i1"], rec["i2"]) == (0, 1)
    assert hedge_stage_result(rec) == hedge_stage_direct(equal, dup_q, far_adm)


def test_cluster_hedge_first_host_in_every_fold_position():
    """b1 at each of a lane's K positions (a fold's first, middle and last
    host) and in each block: the duplicates that land on b1 are
    ``host_sum`` with b1's zeroed, bit for bit."""
    n_hosts = 1500                        # six hosts a lane, the last lanes short
    rng = np.random.default_rng(7)
    dup_q, far_adm = _values(rng, n_hosts), _values(rng, n_hosts)
    for b1 in (0, 31, 37, 256 + 5, 512 + 224, 1023, 1280 + 200, 1499):
        btot = rng.uniform(10.0, 20.0, n_hosts).astype(np.float32)
        btot[b1] = 1.0
        rec = _alike(cluster_tree("hedge", (btot, dup_q, far_adm), n_hosts))
        assert hedge_stage_result(rec) == hedge_stage_direct(btot, dup_q, far_adm), b1


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                   # pragma: no cover
    HAVE_HYPOTHESIS = False


if HAVE_HYPOTHESIS:
    @settings(max_examples=25, deadline=None)
    @given(n_hosts=st.one_of(st.integers(257, MAX_H), st.sampled_from([257, 1000, 1500, 1792,
                                                                        MAX_H])),
           seed=st.integers(0, 2**32 - 1), ties=st.booleans())
    def test_cluster_exchange_by_hypothesis(n_hosts, seed, ties):
        """The mirrored exchange over 257 to the routes' largest H, random
        values over six decades and equal values: ``host_sum``'s sum, the
        max, the minima, the plain version's hedge stage, every consumer
        thread alike."""
        _check_point(n_hosts, np.random.default_rng(seed),
                     tie_pool=(0.0, 1.0, 2.5, 7.0) if ties else None)


# -- the routes and their layout against the sources ----------------------------------

def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _static_bytes(src, kernel):
    """Static shared memory of a cluster kernel, from the source's
    constants: the exchange (``ClusterShared``: the K warps' records, two
    buffers of the 8 partials, two barriers), the ring's mbarriers, and S3b's
    stop word."""
    k, rec, g = (_const(src, n) for n in ("kMaxHostsPerLane", "kMaxRecord", "kClusterBlocks"))
    exchange = 4 * (k * rec * _const(src, "kClusterLanes") + 2 * rec * g) + 2 * 8
    return exchange + 2 * _const(src, "kStages") * 8 + (4 if kernel is fa_kernel else 0)


def _fields(kernel, q_max, stalls):
    if kernel is fa_kernel:
        return q_max + 4 + (2 + 4 if stalls else 0)
    return q_max + 4 + (4 + 1 if stalls else 0)


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_cluster_layout_matches_the_source(source):
    """The route of every host count (ring up to 256, cluster up to 256 K_max,
    scratch beyond), the blocks a cluster, the hosts a lane and the ring's
    rows of 32 K lanes; the ring with the exchange and the static shared
    memory fits a block at every host count of the route, both builds,
    stalls on and off, and K_max is the largest K that fits."""
    kernel = SOURCES[source]
    src = (CSRC / source).read_text()
    flat = " ".join(src.split())
    assert _const(src, "kClusterBlocks") == kernel.CLUSTER_BLOCKS == G
    assert _const(src, "kClusterLanes") == LANES == 256 // G
    assert _const(src, "kMaxHostsPerLane") == kernel.MAX_HOSTS_PER_LANE
    assert _const(src, "kMaxRecord") == 8
    for line in (
            "uint32_t leaf[kMaxHostsPerLane][kMaxRecord][kClusterLanes];",
            "uint32_t part[2][kMaxRecord][kClusterBlocks];",
            "__align__(8) uint64_t bar[2];",
            "return hosts_per_lane == 1 ? kRing : hosts_per_lane <= kMaxHostsPerLane ? kCluster "
            ": kScratch;",
            "attr[0].val.clusterDim.x = kClusterBlocks;",
            "if (clusters < 1) return cudaErrorLaunchOutOfResources;",
            "32 * g + (t & 31) + 256 * (t >> 5), t,",
            "const int h = CL ? 32 * rank + (j & 31) + 256 * (j >> 5) : j;"):
        assert line in flat, line
    k_max = kernel.MAX_HOSTS_PER_LANE
    static = _static_bytes(src, kernel)
    stages = _const(src, "kStages")
    steps = _const(src, "kStageSteps" if kernel is fa_kernel else "kStageSlots")
    for n_hosts in range(1, 256 * k_max + 300):
        k = -(-n_hosts // 256)
        want = "ring" if k == 1 else "cluster" if k <= k_max else "scratch"
        assert kernel.route(n_hosts) == want, n_hosts
        for q_max in (1, 4):
            for stalls in (False, True):
                got = kernel.ring_bytes(n_hosts, q_max, stalls)
                if want == "scratch":
                    assert got == 0
                    continue
                lanes = host_lanes(n_hosts) if want == "ring" else 32 * k
                fields = _fields(kernel, q_max, stalls)
                per_step = fields * lanes + (0 if kernel is fa_kernel else 1)
                assert got == 4 * stages * steps * per_step, (n_hosts, q_max, stalls)
                if want == "cluster":
                    assert got + static <= SMEM_PER_BLOCK, (n_hosts, q_max, stalls)
    # one more host a lane would not fit the largest build with stalls on
    fields = _fields(kernel, 4, True)
    over = 4 * stages * steps * (fields * 32 * (k_max + 1) + (0 if kernel is fa_kernel else 1))
    assert over + static > SMEM_PER_BLOCK
    # the scale row's 1000 hosts: four hosts a lane, 128 consumer threads a block
    assert kernel.route(1000) == "cluster" and kernel.route(256 * k_max + 1) == "scratch"


# -- on the card ----------------------------------------------------------------------

def _grid(n_hosts, one_queue):
    """Eight points: m x n_queues (one queue throughout with ``one_queue``),
    least-loaded refreshing every 2 us, topology with the link on half the
    hosts, hedge deadlines 0, 20 and 80, a step schedule on every other
    point."""
    from repro_torch.runtime import FleetConfig, FleetGrid, StepSchedule
    rng = np.random.default_rng(n_hosts)
    pts = []
    for m, q in ((1, 1), (2, 2), (3, 4), (4, 3), (2, 1), (3, 3), (4, 4), (1, 2)):
        p = dict(t_s_us=float(rng.uniform(4.0, 40.0)), t_l_us=float(rng.uniform(100.0, 600.0)),
                 m=m, n_queues=1 if one_queue else q, seed=int(rng.integers(0, 3)),
                 rate_mpps=float(rng.uniform(0.2, 0.8) * 29.76 * q / 2.0 * n_hosts),
                 hedge_deadline_us=(0.0, 20.0, 80.0)[len(pts) % 3])
        if len(pts) % 2:
            p["schedule"] = StepSchedule(times_us=(0.0, 60.0), scales=(0.4, 1.5))
        pts.append(p)
    fleet = FleetConfig(n_hosts=n_hosts, lb="least-loaded", lb_stale_us=2.0, far_fraction=0.5,
                        near_cost_us=1.0, far_cost_us=5.0, link_rate_mpps=10_000.0)
    return FleetGrid.of_points(pts, fleet=fleet)


GPU_HOSTS = (257, 1000, 1500)


@pytest.mark.gpu
def test_cluster_kernels_equal_plain_versions_on_the_card():
    """Both kernels against their plain versions on the card, every output
    bit for bit, at 257, 1000 and 1500 hosts and each kernel's largest H of
    the cluster route (its route reported as "cluster"), and one host past
    it (the scratch route): least-loaded refreshing every 2 us, the link,
    hedging, every noise family, schedules, one queue a point (<4, 1>) and
    up to four (<4, 4>)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fleet sweep kernels have no CPU mode")
    from repro_torch.kernels.fleet_adaptive_sweep import (
        fleet_adaptive_sweep,
        reference_fleet_adaptive_sweep,
    )
    from repro_torch.kernels.fleet_adaptive_sweep.ops import POINT_NAMES
    from repro_torch.kernels.fleet_adaptive_sweep.ops import STAT_NAMES as FA_STATS
    from repro_torch.kernels.fleet_sweep import fleet_sweep, reference_fleet_sweep
    from repro_torch.kernels.fleet_sweep.ops import STAT_NAMES
    from repro_torch.runtime import SimRunConfig, SleepModel
    from repro_torch.runtime.fleet import fleet_adaptive_inputs, fleet_inputs
    cfg = SimRunConfig(duration_us=100.0, queue_capacity=64,
                       sleep_model=SleepModel(base_us=2.8, slope=0.027, sigma_us=0.5,
                                              tail_prob=0.01, tail_mean_us=40.0),
                       interference_prob=0.25, interference_mean_us=20.0,
                       stall_rate_per_us=1.0 / 400.0, stall_mean_us=150.0)
    for kernel, wrapper, plain, inputs, names in (
            (fleet_kernel, fleet_sweep, reference_fleet_sweep, fleet_inputs, STAT_NAMES),
            (fa_kernel, fleet_adaptive_sweep, reference_fleet_adaptive_sweep,
             fleet_adaptive_inputs, (*FA_STATS, *POINT_NAMES))):
        top = 256 * kernel.MAX_HOSTS_PER_LANE
        for n_hosts in (*GPU_HOSTS, top, top + 1):
            for one_queue in (True, False):
                args, params, fparams = inputs(_grid(n_hosts, one_queue), cfg, 0.5, "cuda")
                if wrapper is fleet_adaptive_sweep:
                    params = dataclasses.replace(params, max_steps=min(params.max_steps, 400))
                before = dict(wrapper.launches_by_build)
                out = wrapper(*args, params=params, fleet=fparams)
                (build,) = [b for b, n in wrapper.launches_by_build.items()
                            if n != before.get(b, 0)]
                assert build[2] == kernel.route(n_hosts), (n_hosts, build)
                ref = plain(*args, params, fparams)
                for name in names:
                    assert torch.equal(out[name], ref[name]), (kernel.__name__, n_hosts,
                                                               one_queue, name)
