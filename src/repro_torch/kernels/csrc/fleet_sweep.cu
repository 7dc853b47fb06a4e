// Fixed-slot fleet sweep (S3) for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the body of the reference's fleet engine, src/repro/runtime/fleet.py,
// _build_fleet_sweep.one_fleet (:234): a lax.scan over time slots (:485) of
// fleet_step (:380), which runs the single-host slot body (host_step, :265)
// under a host vmap (:405) with three cross-host stages around it, all under a
// point vmap (:798).  It is not a pallas_call, but it is the reference's own
// accelerator hot path for fleets: benchmarks/fleet.py runs 4-64 hosts a
// point for 120,000 slots, and 1000 hosts x 8 points in one call.
//
// What one point computes, slot by slot (dt = slot_us), all in float32:
//   load balancer  the point's rate splits over its hosts: uniform
//                  float32(1/H) shares, weighted static shares, or
//                  least-loaded, a softmax of -stale * (1/softness) over a
//                  snapshot of the hosts' backlogs taken before the step
//                  whenever t % stale_every == 0 (slot 0 included);
//   host step      every host runs the single-host slot body of S1
//                  (csrc/slot_sweep.cu's state machine) at its share of the
//                  rate;
//   topology       admissions pay the rack cost, a far host's also the
//                  bottleneck link's wait 1 / max(link - far_rate, (1 -
//                  0.98) link), far_rate the far hosts' admissions x (1/dt),
//                  into topo_area;
//   hedging        with the point's deadline D > 0, each host duplicates
//                  adm / (1 + exp(-(backlog (1/mu) - D) / (D/4 + 1e-6))) to
//                  b1, the first least-loaded host after the step (b1's own
//                  go to b2, the first least-loaded other), each queue
//                  getting its 1/nq share up to its room; counted in
//                  hedge_dup, not in offered;
//   past duration  the loop stops (the reference holds the carry).
// Every sum over hosts runs in one stated order (ops.py's docstring,
// host_sum): W = min(256, next pow2 >= H) lanes, lane j holding hosts j, j +
// W, ... summed in turn; a halving tree within each warp's lanes
// (__shfl_down_sync), then over the warps.  The plain version,
// kernels/fleet_sweep/ops.py:reference_fleet_sweep, makes the same float32
// operations in the same order, and this file is built with -fmad=false, so
// on the same draws the two agree bit for bit.
//
// Noise: S1's Philox contract (kernels/slot_sweep/philox.py), host h of a point
// keyed as ((seed_lo + h) mod 2^32, seed_hi): the reference's per-host key
// (fleet.py:243-249), so host h draws the stream of a single-host point seeded
// seed + h.  The generator is counter-based: a value drawn at a slot where no
// thread uses it changes nothing, so the ring route draws every family at
// every slot, and the values it uses are the contract's.
//
// What binds: the fleet grids have 4-8 points and a point's hosts meet every
// slot (the balancer reads all backlogs, the link all admissions, the hedge
// all backlogs), so a point is one block and the time of a call is one
// block's dependent chain of slots; the card's throughput is no limit.  With
// S1's one-thread body (draws inline) on each host thread, a slot took
// 2.03-2.90 us on an H100 (PERF.md §5).  The design takes every draw off the
// chain and keeps the rest of it short:
//  1. Warp specialisation (the ring route, H <= 256).  A block is a point:
//     consumer warps, max(1, W / 32) of them, one host a lane with its whole
//     state in registers, run only the state machine (the plain version's
//     slot loop after the draws) and the cross-host stages; producer warps
//     make every host's state-free values at every slot: the arrival normals,
//     the overshoot (drawn every slot, not lazily), the stall window a slot
//     opens (its end, or -inf), the re-arm jitter, and the schedule's scale.
//     The producer count is a launch-time number (producers()): six warps
//     beside one consumer warp (warps 1-3 and 5-7), four beside two (warps 2,
//     3, 6 and 7), one a consumer warp beside four or eight.  A warp issues
//     on scheduler warp % 4, and a producer on a consumer's scheduler slowed
//     the consumer, so below four consumer warps the warps on the consumers'
//     schedulers idle (PERF.md §6 has the counts measured).  A producer lane
//     takes the stage's (slot, host) items in turn, so any H keeps them all
//     busy.  The block is at most 16 warps, and its launch bounds hold every
//     thread to 128 registers.
//  2. A ring of kStages stages in dynamic shared memory, each kStageSlots
//     slots x the fields of W host lanes, laid out [slot][field][lane] (one
//     conflict-free word a lane), the slot's scale after them; the stall
//     fields only when stalls are on.  Hand-off by mbarriers: full[s] (every
//     producer lane arrives, the consumers wait) and empty[s] (every consumer
//     lane arrives, the producers wait), with phase parities.  The consumer
//     loads slot k + 1's fields before it runs slot k.
//  3. Host reductions on a named barrier (bar.sync 1, consumer threads), which
//     the producers never join: a __syncthreads there would deadlock, as a
//     producer waits on an empty barrier that the consumers release only after
//     the reduction.  Each reduction carries only the fields it reads (the
//     softmax's max; its sum; the far rack's admissions), in the tree of the
//     plain version, as a butterfly that leaves the result in every lane (no
//     broadcast); above 32 lanes the warp results go through shared memory,
//     double-buffered, and every warp runs the tree over them itself: one
//     barrier a reduction.  The hedge stage is one tree, not two in turn: a
//     node carries its two first least-loaded hosts, the first's duplicates,
//     and its duplicates' sum with and without the first's, so the root holds
//     b1, b2, what lands on b1 (the sum with b1's zeroed, in the tree's order)
//     and b1's own.
//  4. Least-loaded's softmax only on refresh slots: the snapshot, its max,
//     its sum and each lane's share are taken when t % stale_every == 0, and
//     lam_q = lam * share / nq stays in a register until the next (uniform and
//     weighted: lam_q once).  The arrival mean mu_a = lam_q * scale * dt and
//     its sqrt are cached until a refresh or a change of the schedule's
//     scale.  The same float32 operations on the same operands: the same bits.
//  5. M_MAX and Q_MAX are template parameters (<4, 1> and <4, 4>, as S1's);
//     lanes past a point's m or n_queues add exact zeros.
//  6. Beyond 256 hosts (the cluster route, up to 256 kMaxHostsPerLane): a
//     point is a thread-block cluster of kClusterBlocks = 8 blocks, the
//     portable maximum.  Block g takes lanes 32 g .. 32 g + 31 of W = 256,
//     and its consumer warp k runs host 32 g + i + 256 k in lane i: K =
//     ceil(H / 256) consumer warps a block, one thread a host with its state
//     in registers, the ring route's state machine unchanged.  Its producer
//     warps (cluster_producers) fill a ring of the ring route's layout with
//     only that block's hosts' values (32 K lanes a row).  A host reduction
//     (cluster_reduce) replays host_sum's order: each lane's hosts in turn
//     (the warps' records through shared memory, folded by warp 0 in k
//     order), warp 0's 32-lane butterfly, then the tree over the 8 groups,
//     which every block computes itself from the 8 partials that every
//     block pushes into every block's shared memory with st.async, whose
//     bytes complete that block's mbarrier: one exchange a reduction, so
//     a hedged slot costs one exchange where the scratch route ran two
//     reductions in turn.  Only the consumers exchange; no cluster barrier
//     runs inside the loop (a producer waiting on `empty` would deadlock
//     it), one before and one after it.  At 1000 hosts the grid is 8 points
//     x 8 blocks on 64 SMs.  K_max = 8: a stage of 32 K lanes at <4, 4>
//     with stalls (13 fields) and the K warps' records fit 227 KB.
//  7. Beyond that (the scratch route): a lane holds hosts j, j + 256, ...
//     whose states live in a global scratch (point, word, host), coalesced
//     across the block, loaded and stored one host at a time, with the
//     one-thread body (draws inline, the overshoot lazily) and the reductions
//     of 3 over all 256 threads (the hedge stage's two in turn).
//  8. The run has the slots with float(t) * slot_us < duration (the
//     reference's own float32 product); the host finds their count by
//     bisection, so no slot past the run is drawn.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLanes = 256;
constexpr int kMaxWarps = kMaxLanes / 32;
constexpr int kStageSlots = 8;   // slots a stage of the ring
constexpr int kStages = 2;
constexpr int kMaxProducers = 8;   // producer warps at most (beside eight consumer warps)
constexpr int kMaxThreads = 32 * (kMaxWarps + kMaxProducers);
constexpr int kRedBarrier = 1;   // the named barrier of the host reductions
constexpr int kMaxStates = 4;
constexpr int kNumFParams = 24;
constexpr int kNumHostStats = 12;
constexpr int kNumStats = 14;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTwoPi = 6.28318548202514648f;   // float32(2 pi)

enum Stream : uint32_t { kInit = 0, kNormal = 1, kTail = 2, kIntf = 3, kStall = 4 };
enum Flag : int { kSigma = 1, kTailOn = 2, kIntfOn = 4, kStallOn = 8, kTopo = 16, kLink = 32 };

struct Params {
  float dt, duration, mu, mu_dt, capacity, wake_cost, base, sigma, one_plus_slope;
  float tail_prob, tail_mean, intf_prob, intf_mean, stall_p, stall_mean, active_power;
  float inv_soft, near_cost, far_cost, link_rate, link_floor, inv_dt, inv_mu, hedge_eps;
  float st_power[kMaxStates], st_trans[kMaxStates], st_thr[kMaxStates];
  int n_states, flags;
  int n_points, n_hosts, n_live, n_seg, lb, stale_every, far_count;
  int lanes, hosts_per_lane, consumers;   // consumers: consumer threads (ring route)
};

struct Inputs {
  const float *t_s, *t_l;
  const int *m, *nq;
  const float* lam;
  const int *seed_lo, *seed_hi;
  const float* hedge_d;
  const float *sched_edges, *sched_scales, *shares;
};

// A ring stage's fields, per slot and host lane: the arrival normals of each
// queue, each thread's overshoot, and with stalls on, each thread's re-arm
// jitter and the stall end the slot opens (-inf where it opens none).
template <int MM, int QQ>
struct Layout {
  static constexpr int kZ = 0, kOver = QQ, kJit = QQ + MM, kOpen = QQ + 2 * MM;
  static __host__ __device__ int fields(int flags) {
    return (flags & kStallOn) ? kOpen + 1 : kJit;
  }
  // floats of one stage: the table, then one scale a slot
  static __host__ __device__ int stage_floats(int lanes, int flags) {
    return kStageSlots * (fields(flags) * lanes + 1);
  }
  static size_t smem_bytes(int lanes, int flags) {
    return sizeof(float) * (size_t)kStages * stage_floats(lanes, flags);
  }
};

int lanes_for(int n_hosts) {
  int w = 1;
  while (w < n_hosts && w < kMaxLanes) w *= 2;
  return w;
}

// consumer warps of a point of `lanes` host lanes, the producer warps
// beside them, and the block's warps (the rule of the design note, 1):
// below four consumer warps the producers take only the schedulers (warp %
// 4) that no consumer warp is on, and the warps on the others idle
__host__ __device__ inline int consumer_warps(int lanes) { return lanes < 32 ? 1 : lanes / 32; }
__host__ __device__ inline int producers(int lanes) {
  const int cw = consumer_warps(lanes);
  return cw == 1 ? 6 : cw == 2 ? 4 : cw;
}
__host__ __device__ inline int block_warps(int lanes) {
  const int cw = consumer_warps(lanes), np = producers(lanes);
  return cw >= 4 ? cw + np : 4 * (np / (4 - cw));
}
// the rank among the producers of warp w >= consumer_warps, or -1 (idle)
__host__ __device__ inline int producer_rank(int w, int lanes) {
  const int cw = consumer_warps(lanes);
  if (cw >= 4) return w - cw;
  const int sched = w % 4;
  return sched < cw ? -1 : (w / 4) * (4 - cw) + sched - cw;
}

struct Words {
  uint32_t w[4];
};

__device__ __forceinline__ Words philox(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                        uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    // one 32 x 32 -> 64-bit product a word (IMAD.WIDE.U32)
    const uint64_t p0 = (uint64_t)0xD2511F53u * c0, p1 = (uint64_t)0xCD9E8D57u * c2;
    c0 = (uint32_t)(p1 >> 32) ^ c1 ^ k0;
    c1 = (uint32_t)p1;
    c2 = (uint32_t)(p0 >> 32) ^ c3 ^ k1;
    c3 = (uint32_t)p0;
  }
  return {{c0, c1, c2, c3}};
}

__device__ __forceinline__ float u01(uint32_t w) {
  return (float)(w >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float expo(float u) { return -logf(1.0f - u); }

// lanes 2p and 2p + 1 from words (2p, 2p + 1), for the first n lanes
__device__ __forceinline__ void box_muller(const Words& x, int n, float z[4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (2 * p < n) {
      const float r = sqrtf(-2.0f * logf(1.0f - u01(x.w[2 * p])));
      const float th = kTwoPi * u01(x.w[2 * p + 1]);
      float sn, cs;
      sincosf(th, &sn, &cs);
      z[2 * p] = r * cs;
      z[2 * p + 1] = r * sn;
    } else {
      z[2 * p] = z[2 * p + 1] = 0.0f;
    }
  }
}

__device__ __forceinline__ float arm_cost(float target, const Params& P) {
  float pw = P.st_power[0], tuj = P.st_trans[0];
#pragma unroll
  for (int s = 1; s < kMaxStates; ++s) {
    if (s < P.n_states && target >= P.st_thr[s]) {
      pw = P.st_power[s];
      tuj = P.st_trans[s];
    }
  }
  return pw * target + tuj;
}

// base + sigma |z| + hit x mean x Exp for the tail and interference, per
// thread; (1 * mean) * e where a draw hits, + 0 where it does not (exact)
template <int MM>
__device__ __forceinline__ void overshoot(int t, int m, uint32_t k0, uint32_t k1,
                                          const Params& P, float over[MM]) {
#pragma unroll
  for (int i = 0; i < MM; ++i) over[i] = P.base;
  if (P.flags & kSigma) {
    float z[4];
    box_muller(philox(t, kNormal, 1, 0, k0, k1), m, z);
#pragma unroll
    for (int i = 0; i < MM; ++i) over[i] = over[i] + P.sigma * fabsf(z[i]);
  }
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const bool on = f == 0 ? (P.flags & kTailOn) : (P.flags & kIntfOn);
    if (!on) continue;
    const uint32_t stream = f == 0 ? kTail : kIntf;
    const float prob = f == 0 ? P.tail_prob : P.intf_prob;
    const float mean = f == 0 ? P.tail_mean : P.intf_mean;
    const Words hit = philox(t, stream, 0, 0, k0, k1);
    bool any = false;
    bool h[MM];
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      h[i] = i < m && u01(hit.w[i]) < prob;
      any |= h[i];
    }
    if (!any) continue;
    const Words len = philox(t, stream, 1, 0, k0, k1);
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      if (h[i]) over[i] = over[i] + mean * expo(u01(len.w[i]));
    }
  }
}

// this slot's duplicates of a host (hedging on)
__device__ __forceinline__ float duplicates(float adm, float btot, float hedge_d,
                                            float hedge_den, const Params& P) {
  const float xg = (btot * P.inv_mu - hedge_d) / hedge_den;
  return adm * (1.0f / (1.0f + expf(-xg)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- host reductions over the W lanes of a point's hosts --------------------
// The order of a sum: within each warp a halving tree over its L = min(W, 32)
// lanes (lane l adds lane l + off, off = L/2 .. 1), then the same tree over
// the W / 32 warps' sums.  Lanes >= W hold the identity.  Argmins keep the
// lowest host index among equal values.  The trees run as butterflies
// (__shfl_xor_sync, off = L/2 .. 1): lanes l and l ^ off combine the same two
// values (a + b == b + a bit for bit, and every combine below is symmetric),
// so each lane of a group of L ends with lane 0's result, the sum of the
// tree above, and no broadcast follows.  A reduction's type carries only the
// fields it reads: the softmax's max (MaxOf) and sum (SumOf), the far rack's
// admissions without hedging (SumOf), the hedge stage (Hedge), and the
// scratch route's sum and argmin (Red).

__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

struct MaxOf {
  float v;
  __device__ static MaxOf of(float v) { return {v}; }
  __device__ void butterfly(int off) { v = fmaxf(v, __shfl_xor_sync(kFull, v, off)); }
  __device__ void fold(const MaxOf& o) { v = fmaxf(v, o.v); }
};

struct SumOf {
  float v;
  __device__ static SumOf of(float v) { return {v}; }
  __device__ void butterfly(int off) { v = v + __shfl_xor_sync(kFull, v, off); }
  __device__ void fold(const SumOf& o) { v = v + o.v; }
};

// A sum (SUM), an argmin over (v, i) (ARG), a max (MX).
template <bool SUM, bool ARG, bool MX>
struct Red {
  float sum, v, mx;
  int i;
  __device__ static Red identity() { return {0.0f, INFINITY, -INFINITY, 0x7fffffff}; }
  __device__ void butterfly(int off) {
    if (SUM) sum = sum + __shfl_xor_sync(kFull, sum, off);
    if (ARG) {
      const float w = __shfl_xor_sync(kFull, v, off);
      const int j = __shfl_xor_sync(kFull, i, off);
      if (before(w, j, v, i)) {
        v = w;
        i = j;
      }
    }
    if (MX) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  }
};

// The hedge stage in one tree: over a subtree, the two first least-loaded
// hosts (v1, i1) and (v2, i2) after the step, the duplicates d1 of the
// first, the sum of the subtree's duplicates (full) and that sum with the
// first's zeroed (excl), and with the link on the far rack's admissions
// (far; HedgeTree<false> leaves it out of the shuffles).  At the root:
// b1 = i1, b2 = i2, what lands on b1 = excl (the plain version's host_sum
// with b1's term zeroed: a node on b1's path adds the zeroed sum of the
// child that holds b1 to the other child's full sum, in the tree's order),
// b1's own = d1.
struct Hedge {
  float full, excl, v1, v2, d1, far;
  int i1, i2;
  // a host lane's leaf: it is its own first least-loaded host
  __device__ static Hedge leaf(bool live, int h, float btot, float dup_q, float far_adm) {
    if (!live) return {0.0f, 0.0f, INFINITY, INFINITY, 0.0f, 0.0f, 0x7fffffff, 0x7fffffff};
    return {dup_q, 0.0f, btot, INFINITY, dup_q, far_adm, h, 0x7fffffff};
  }
  // this subtree and the other one, o, the subtree after it in the tree's
  // order (the cluster route folds a lane's hosts in turn with it)
  template <bool LINK>
  __device__ void merge(const Hedge& o) {
    if (LINK) far = far + o.far;
    if (before(o.v1, o.i1, v1, i1)) {   // the other subtree holds the first
      const bool mine = before(v1, i1, o.v2, o.i2);
      v2 = mine ? v1 : o.v2;
      i2 = mine ? i1 : o.i2;
      v1 = o.v1;
      i1 = o.i1;
      d1 = o.d1;
      excl = full + o.excl;
    } else {
      if (before(o.v1, o.i1, v2, i2)) {
        v2 = o.v1;
        i2 = o.i1;
      }
      excl = excl + o.full;
    }
    full = full + o.full;
  }
  template <bool LINK>
  __device__ void combine(int off) {
    Hedge o;
    o.full = __shfl_xor_sync(kFull, full, off);
    o.excl = __shfl_xor_sync(kFull, excl, off);
    o.v1 = __shfl_xor_sync(kFull, v1, off);
    o.v2 = __shfl_xor_sync(kFull, v2, off);
    o.d1 = __shfl_xor_sync(kFull, d1, off);
    o.i1 = __shfl_xor_sync(kFull, i1, off);
    o.i2 = __shfl_xor_sync(kFull, i2, off);
    if (LINK) o.far = __shfl_xor_sync(kFull, far, off);
    merge<LINK>(o);
  }
};

template <bool LINK>
struct HedgeTree : Hedge {
  __device__ void butterfly(int off) { combine<LINK>(off); }
  __device__ void fold(const HedgeTree& o) { merge<LINK>(o); }
};

// the warps' partial results (any of the types above), two buffers used in
// turn
struct RedShared {
  __align__(16) unsigned char slot[2][kMaxWarps][32];
};

// The reduction of W lanes among `threads` threads (W <= 32: one warp, no
// barrier).  `buf` alternates the shared buffers: a warp writes one only
// after the barrier of the reduction before, which every warp passes only
// once it has read the buffer of the one before that.  Every lane of a
// group of W (the whole block above 32) gets the result.
template <class T>
__device__ __forceinline__ T reduce(T a, int W, int threads, RedShared& sh, int& buf) {
  static_assert(sizeof(T) <= 32, "a reduction's partial result fits its shared slot");
  const int L = W < 32 ? W : 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < L) a.butterfly(off);
  }
  if (W <= 32) return a;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) *reinterpret_cast<T*>(sh.slot[buf][warp]) = a;
  asm volatile("bar.sync %0, %1;" ::"r"(kRedBarrier), "r"(threads) : "memory");
  const int G = W >> 5;
  a = *reinterpret_cast<const T*>(sh.slot[buf][lane & (G - 1)]);
  buf ^= 1;
#pragma unroll
  for (int off = kMaxWarps / 2; off > 0; off >>= 1) {
    if (off < G) a.butterfly(off);
  }
  return a;
}

// ---- the cluster route's exchange (the design note, 6) ----------------------
// A point is a cluster of kClusterBlocks blocks.  Block g holds host lanes
// 32 g .. 32 g + 31 of W = 256, and its consumer warp k host 32 g + i + 256 k
// in lane i, so that host_sum's order falls out of the layout: each lane's
// hosts in turn (the warps' records through the block's shared memory, warp
// 0 folding them in k order), the 32-lane tree (warp 0's butterfly), and the
// tree over the 8 groups, which every block computes itself from the 8
// partials pushed into its shared memory: every block ends with the same
// bits, and no broadcast follows.

// the block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of the cluster, once before the loop (the barriers are
// initialised) and once after (no block leaves while another can still
// write into its shared memory); never inside the loop, where a producer
// waiting on `empty` would deadlock it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

// the address of the same shared variable in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// an asynchronous store into another block's shared memory that completes
// 4 bytes of the transaction count of that block's mbarrier (no release
// fence: the barrier's phase completes when the bytes have landed)
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(addr), "r"(v), "r"(bar) : "memory");
}

// this block's arrival on its own barrier, expecting `bytes` more
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// the wait on this block's barrier, acquiring at the cluster's scope
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

constexpr int kClusterBlocks = 8;     // blocks a point: the portable cluster size
constexpr int kClusterLanes = 32;     // host lanes a block (kMaxLanes / kClusterBlocks)
constexpr int kMaxHostsPerLane = 8;   // K at most: the ring of 32 K lanes fits beside the rest
constexpr int kMaxRecord = 8;         // words of the largest reduction record (Hedge)

// The exchange's shared memory, word-major (one bank a lane): the consumer
// warps' records; the 8 blocks' partials, two buffers used in turn; a
// barrier for each buffer, whose phase completes on this block's one
// arrival (arrive.expect_tx of the 8 partials' bytes) and those bytes'
// landing (st.async from every block).
struct ClusterShared {
  uint32_t leaf[kMaxHostsPerLane][kMaxRecord][kClusterLanes];
  uint32_t part[2][kMaxRecord][kClusterBlocks];
  __align__(8) uint64_t bar[2];
};

// One reduction over the point's hosts, among the block's 32 K consumer
// threads (warp k, lane i holding host 32 g + i + 256 k); every consumer
// thread of the cluster gets the result.  `xc` counts the exchanges (alike
// in every consumer thread): exchange j uses part[j % 2] and bar[j % 2] at
// parity (j / 2) % 2.  A block pushes exchange j + 1 only after each of its
// warps has read exchange j's partials (their next records come after that,
// and warp 0 folds them before it pushes), and it pushes j + 2 only after
// the wait for j + 1, which every block's push of j + 1 passes, each after
// its wait for j: so a buffer is free when it is written, and bytes never
// land in a phase they do not belong to (bytes of j may land before this
// block's expect_tx for j: the transaction count goes below zero, and the
// phase still waits for the arrival).  The records too are free when
// written: warp k writes its next record only after this exchange's wait,
// which passes after warp 0's push, after its fold.  The pushes are
// st.async (measured against st.shared::cluster and a remote release-arrive
// with fleet_cluster_exchange_probe: 0.24 against 0.56 us an exchange).
template <class T>
__device__ __forceinline__ T cluster_reduce(T a, int K, ClusterShared& cs, int& xc) {
  constexpr int N = sizeof(T) / 4;
  static_assert(sizeof(T) % 4 == 0 && N <= kMaxRecord, "a record fits the exchange");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = xc & 1;
  const uint32_t parity = (xc >> 1) & 1;
  ++xc;
  uint32_t w[N];
  if (warp > 0) {
    memcpy(w, &a, sizeof(T));
#pragma unroll
    for (int n = 0; n < N; ++n) cs.leaf[warp][n][lane] = w[n];
    asm volatile("bar.arrive %0, %1;" ::"r"(kRedBarrier), "r"(32 * K) : "memory");
  } else {
    if (lane == 0) mbar_expect_tx(smem_u32(&cs.bar[b]), kClusterBlocks * sizeof(T));
    asm volatile("bar.sync %0, %1;" ::"r"(kRedBarrier), "r"(32 * K) : "memory");
    for (int k = 1; k < K; ++k) {
#pragma unroll
      for (int n = 0; n < N; ++n) w[n] = cs.leaf[k][n][lane];
      T o;
      memcpy(&o, w, sizeof(T));
      a.fold(o);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a.butterfly(off);
    if (lane < kClusterBlocks) {   // lane r pushes the block's partial into block r
      memcpy(w, &a, sizeof(T));
      const uint32_t g = cluster_rank();
      const uint32_t dst = map_rank(smem_u32(&cs.part[b][0][g]), lane);
      const uint32_t rbar = map_rank(smem_u32(&cs.bar[b]), lane);
#pragma unroll
      for (int n = 0; n < N; ++n) st_async(dst + 4 * kClusterBlocks * n, w[n], rbar);
    }
  }
  mbar_wait_cluster(smem_u32(&cs.bar[b]), parity);
#pragma unroll
  for (int n = 0; n < N; ++n) w[n] = cs.part[b][n][lane & (kClusterBlocks - 1)];
  memcpy(&a, w, sizeof(T));
#pragma unroll
  for (int off = kClusterBlocks / 2; off > 0; off >>= 1) a.butterfly(off);
  return a;
}

__device__ __forceinline__ void cluster_init(ClusterShared& cs) {
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&cs.bar[0]), 1);
    mbar_init(smem_u32(&cs.bar[1]), 1);
  }
}

// producer warps a block on the cluster route, beside K consumer warps: the
// ring route's count (K, four below four), but the block at most 12 warps.
// An SM splits its registers over its four schedulers, so a 13th warp puts
// four warps on one scheduler and caps a thread at 128 registers, under
// which the <4, 4> build at K = 8 spilled; at 12 a thread keeps up to 168
__host__ __device__ constexpr int cluster_producers(int K) {
  return K < 4 ? 4 : K + K <= 12 ? K : 12 - K;
}

// ---- the two routes' host reductions ----------------------------------------

// The ring route's: W lanes in one block (reduce).
struct BlockRoute {
  int lanes, threads;
  RedShared& sh;
  int buf;
  __device__ int row_stride() const { return lanes; }
  template <class T>
  __device__ T over(T a) { return reduce(a, lanes, threads, sh, buf); }
};

// The cluster route's: W = 256 lanes over the cluster's blocks, K hosts a
// lane (cluster_reduce); the ring's rows are the block's 32 K lanes.
template <int KK>
struct ClusterRoute {
  static constexpr int K = KK;
  ClusterShared& cs;
  int xc;
  __device__ int row_stride() const { return 32 * K; }
  template <class T>
  __device__ T over(T a) { return cluster_reduce(a, K, cs, xc); }
};

// ---- the producers ------------------------------------------------------------

// Producer lane `ptid` of `npt`: every state-free value of the stage's
// (slot, lane) items ptid, ptid + npt, ... (item = slot * lanes + lane).  On
// the ring route a lane is a host, in rows of W; on the cluster route (CL)
// the block's 32 K lanes, lane 32 k + i holding host 32 rank + i + 256 k (a
// host past H skipped).  Lane 0 also writes the slot's scale.
template <int MM, int QQ, bool CL>
__device__ __forceinline__ void produce(int ptid, int npt, int pt, int rank, const Inputs& in,
                                        float* ring, uint32_t full, uint32_t empty,
                                        const Params& P) {
  using L = Layout<MM, QQ>;
  const int W = CL ? 32 * P.hosts_per_lane : P.lanes, H = P.n_hosts;
  const int lanes = CL ? W : H;
  const int nf = L::fields(P.flags);
  const int stage_floats = L::stage_floats(W, P.flags);
  const bool stall_on = P.flags & kStallOn;
  const int m = in.m[pt];
  const uint32_t lo = (uint32_t)in.seed_lo[pt], hi = (uint32_t)in.seed_hi[pt];
  const float dt = P.dt;
  const float* edges = in.sched_edges + (size_t)pt * P.n_seg;
  const float* scales = in.sched_scales + (size_t)pt * P.n_seg;
  int seg = 0;
  const int n_stages = (P.n_live + kStageSlots - 1) / kStageSlots;
  for (int g = 0; g < n_stages; ++g) {
    const int s = g % kStages;
    mbar_wait(empty + 8 * s, ((g / kStages) & 1) ^ 1);
    float* tab = ring + (size_t)s * stage_floats;
    const int n = min(kStageSlots, P.n_live - g * kStageSlots);
    for (int it = ptid; it < n * lanes; it += npt) {
      const int k = it / lanes, j = it - k * lanes;
      const int h = CL ? 32 * rank + (j & 31) + 256 * (j >> 5) : j;
      if (CL && h >= H) continue;
      const int t = g * kStageSlots + k;
      const float now = (float)t * dt;
      const uint32_t k0 = lo + (uint32_t)h;
      float* row = tab + k * nf * W + j;
      float z[4];
      box_muller(philox(t, kNormal, 0, 0, k0, hi), QQ, z);
#pragma unroll
      for (int q = 0; q < QQ; ++q) row[(L::kZ + q) * W] = z[q];
      float over[MM];
      overshoot<MM>(t, m, k0, hi, P, over);
#pragma unroll
      for (int i = 0; i < MM; ++i) row[(L::kOver + i) * W] = over[i];
      if (stall_on) {
        const Words st = philox(t, kStall, 0, 0, k0, hi);
        const float end = now + P.stall_mean * expo(u01(st.w[1]));
        row[L::kOpen * W] = u01(st.w[0]) < P.stall_p ? end : -INFINITY;
        const Words jit = philox(t, kStall, 1, 0, k0, hi);
#pragma unroll
        for (int i = 0; i < MM; ++i) row[(L::kJit + i) * W] = u01(jit.w[i]);
      }
      if (j == 0) {
        float scale = 1.0f;
        if (P.n_seg > 0) {
          while (seg + 1 < P.n_seg && edges[seg + 1] <= now) ++seg;
          scale = scales[seg];
        }
        tab[kStageSlots * nf * W + k] = scale;
      }
    }
    mbar_arrive(full + 8 * s);
  }
}

// ---- the consumers (host lanes) ---------------------------------------------

// One slot's state-free values of a host, as its lane reads them.
template <int MM, int QQ>
struct Slot {
  float z[QQ], over[MM], jit[MM], open, scale;
};

template <int MM, int QQ>
__device__ __forceinline__ void load_slot(Slot<MM, QQ>& x, const float* row, const float* scale,
                                          int W, bool stall_on) {
  using L = Layout<MM, QQ>;
#pragma unroll
  for (int q = 0; q < QQ; ++q) x.z[q] = row[(L::kZ + q) * W];
#pragma unroll
  for (int i = 0; i < MM; ++i) x.over[i] = row[(L::kOver + i) * W];
  if (stall_on) {
#pragma unroll
    for (int i = 0; i < MM; ++i) x.jit[i] = row[(L::kJit + i) * W];
    x.open = row[L::kOpen * W];
  }
  x.scale = *scale;
}

// Host h (live when h < H; other hosts hold the reductions' identities and
// write nothing), whose slot values sit at lane `row` of the ring's rows
// (route.row_stride() lanes): S1's consumer state machine on the producers'
// values, then the cross-host stages, with the route's host reductions.  A
// thread's owner is -1 while it sleeps, -2 for a lane past the point's m,
// else the queue it drains.  A slot's counts are whole numbers, exact in
// float32, counted in integers.
template <int MM, int QQ, class R>
__device__ __forceinline__ void consume(R& route, int h, int row, int pt, const Inputs& in,
                                        const float* ring, uint32_t full, uint32_t empty,
                                        const Params& P, float* __restrict__ stats) {
  using L = Layout<MM, QQ>;
  const int W = route.row_stride(), H = P.n_hosts;
  const bool live = h < H;
  const int nf = L::fields(P.flags);
  const int stage_floats = L::stage_floats(W, P.flags);
  const bool stall_on = P.flags & kStallOn;
  const bool topo = P.flags & kTopo, link = P.flags & kLink;
  const bool balanced = P.lb == 2;
  const float t_s = in.t_s[pt], t_l = in.t_l[pt], lam = in.lam[pt], hedge_d = in.hedge_d[pt];
  const int m = in.m[pt], nq = in.nq[pt];
  const float dt = P.dt, cap = P.capacity, mu_dt = P.mu_dt, mu = P.mu;
  const float e_arm_s = arm_cost(t_s, P), e_arm_l = arm_cost(t_l, P);
  const float ts_sleep = t_s * P.one_plus_slope, tl_sleep = t_l * P.one_plus_slope;
  const bool hedged = hedge_d > 0.0f;
  const float hedge_den = 0.25f * hedge_d + P.hedge_eps;
  const float q_share = 1.0f / (float)nq;
  const bool far = h < P.far_count;
  // served / mu where a slot serves mu dt: the quotient, taken once
  const float full_us = mu_dt / mu;

  float sleep_rem[MM];
  int attached[MM];
  {
    const Words w0 = philox(0, kInit, 0, 0, (uint32_t)in.seed_lo[pt] + (uint32_t)h,
                            (uint32_t)in.seed_hi[pt]);
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      sleep_rem[i] = i < m ? fmaxf(u01(w0.w[i]) * t_s, dt) : INFINITY;
      attached[i] = i < m ? -1 : -2;
    }
  }
  float backlog[QQ], vac[QQ], res[QQ], mu_a[QQ], sq[QQ];
  int occ[QQ];
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    backlog[q] = vac[q] = res[q] = mu_a[q] = sq[q] = 0.0f;
    occ[q] = 0;
  }
  float stall_end = -1.0f;
  float s_off = 0.f, s_drop = 0.f, s_serv = 0.f, s_wake = 0.f, s_busy = 0.f, s_cyc = 0.f;
  float s_awake = 0.f, s_lat = 0.f, s_vac = 0.f, s_nv = 0.f, s_ts = 0.f, s_en = 0.f;
  float s_topo = 0.f, s_dup = 0.f;
  // the balancer's rate a queue (least-loaded: from the last refresh), and
  // the scale the cached arrival means were taken at (NaN: none yet)
  float lam_q = balanced || !live ? 0.0f : lam * in.shares[h] / (float)nq;
  float c_scale = NAN;
  int next_refresh = 0;

  const int n_stages = (P.n_live + kStageSlots - 1) / kStageSlots;
  for (int g = 0; g < n_stages; ++g) {
    const int s = g % kStages;
    mbar_wait(full + 8 * s, (g / kStages) & 1);
    const float* tab = ring + (size_t)s * stage_floats;
    const int n = min(kStageSlots, P.n_live - g * kStageSlots);
    const float* nrow = tab + row;
    const float* nscale = tab + kStageSlots * nf * W;
    Slot<MM, QQ> nx = {};
    if (live) load_slot(nx, nrow, nscale, W, stall_on);
    for (int k = 0; k < n; ++k) {
      const Slot<MM, QQ> x = nx;
      if (k + 1 < n) {
        nrow += nf * W;
        ++nscale;
      }
      if (live) load_slot(nx, nrow, nscale, W, stall_on);
      const int t = g * kStageSlots + k;
      const float now = (float)t * dt;

      // 0. least-loaded, on refresh slots: the snapshot of the backlogs
      // before the step, the softmax's max and sum, and the lane's rate
      bool fresh = false;
      if (balanced && t == next_refresh) {
        next_refresh += P.stale_every;
        float b = 0.f;
#pragma unroll
        for (int q = 0; q < QQ; ++q) b = q ? b + backlog[q] : backlog[q];
        const float xs = live ? -b * P.inv_soft : -INFINITY;
        const float mx = route.over(MaxOf::of(xs)).v;
        const float e = live ? expf(xs - mx) : 0.0f;
        const float den = route.over(SumOf::of(e)).v;
        lam_q = lam * (e / den) / (float)nq;
        fresh = true;
      }
      // the arrival means and their square roots, at a refresh or a change
      // of the schedule's scale
      if (fresh || !(x.scale == c_scale)) {
        c_scale = x.scale;
#pragma unroll
        for (int q = 0; q < QQ; ++q) {
          const float lq = q < nq ? lam_q : 0.0f;
          mu_a[q] = P.n_seg > 0 ? lq * c_scale * dt : lq * dt;
          sq[q] = sqrtf(mu_a[q]);
        }
      }
      if (stall_on) stall_end = fmaxf(stall_end, x.open);

      // 1. arrivals
      float offered = 0.f, dropped = 0.f, adm_sum = 0.f;
#pragma unroll
      for (int q = 0; q < QQ; ++q) {
        const float raw = res[q] + mu_a[q] + sq[q] * x.z[q];
        const float a = fmaxf(raw, 0.0f);
        res[q] = fminf(raw, 0.0f);
        const float adm = fminf(a, fmaxf(cap - backlog[q], 0.0f));
        backlog[q] = backlog[q] + adm;
        offered = q ? offered + a : a;
        dropped = q ? dropped + (a - adm) : a - adm;
        adm_sum = q ? adm_sum + adm : adm;
      }

      // 2. countdown + wake; stall windows defer expiring timers
      const bool defer = stall_on && now < stall_end;
      bool woken[MM];
      int n_wake = 0;
#pragma unroll
      for (int i = 0; i < MM; ++i) {
        const bool sleeping = attached[i] == -1;
        if (sleeping) sleep_rem[i] = sleep_rem[i] - dt;
        woken[i] = sleeping && sleep_rem[i] <= 0.0f;
        if (woken[i] && defer) {
          woken[i] = false;
          sleep_rem[i] = stall_end - now + x.jit[i];
        }
        n_wake += woken[i];
      }

      // claims, threads in index order
      int busy = 0, cyc = 0, tsa = 0;
      float vacs = 0.f, nvs = 0.f;
#pragma unroll
      for (int i = 0; i < MM; ++i) {
        int qi = -1, eqi = -1;
        float best = 0.f;
#pragma unroll
        for (int q = 0; q < QQ; ++q) {
          const bool free_q = woken[i] && q < nq && !occ[q];
          if (free_q && eqi < 0) eqi = q;
          if (free_q && backlog[q] >= 1.0f && (qi < 0 || backlog[q] > best)) {
            qi = q;
            best = backlog[q];
          }
        }
        const int cq = qi >= 0 ? qi : eqi;   // the queue whose vacation ends
#pragma unroll
        for (int q = 0; q < QQ; ++q) {
          if (q == cq) {
            vacs = vacs + vac[q];
            vac[q] = 0.0f;
          }
          if (q == qi) {
            nvs = nvs + backlog[q];
            occ[q] = 1;
          }
        }
        cyc += cq >= 0;
        tsa += qi < 0 && eqi >= 0;
        busy += woken[i] && cq < 0;
        if (qi >= 0) attached[i] = qi;
        if (woken[i] && qi < 0)
          sleep_rem[i] = sleep_rem[i] + ((eqi >= 0 ? ts_sleep : tl_sleep) + x.over[i]);
      }

      // 3. owned queues drain at mu; 4. emptied queues release their thread
      float served = 0.f;
      bool q_done[QQ];
#pragma unroll
      for (int q = 0; q < QQ; ++q) {
        const float sv = occ[q] ? fminf(backlog[q], mu_dt) : 0.0f;
        backlog[q] = backlog[q] - sv;
        served = q ? served + sv : sv;
        q_done[q] = occ[q] && backlog[q] <= 1e-6f;
      }
#pragma unroll
      for (int i = 0; i < MM; ++i) {
        bool done = false;
#pragma unroll
        for (int q = 0; q < QQ; ++q) done |= attached[i] == q && q_done[q];
        if (done) {
          tsa += 1;
          sleep_rem[i] = ts_sleep + x.over[i];
          attached[i] = -1;
        }
      }

      // 5. vacations tick on free queues; 6. Little integral; energy
      float bsum = 0.f;
#pragma unroll
      for (int q = 0; q < QQ; ++q) {
        if (q_done[q]) occ[q] = 0;
        if (q < nq && !occ[q]) vac[q] = vac[q] + dt;
        bsum = q ? bsum + backlog[q] : backlog[q];
      }
      const float wakes = (float)n_wake, fbusy = (float)busy, fcyc = (float)cyc;
      const float ftsa = (float)tsa;
      const float lat_area = bsum * dt;
      const float serve_us = served == 0.0f ? 0.0f : served == mu_dt ? full_us : served / mu;
      const float awake = wakes * P.wake_cost + serve_us;
      const float energy = P.active_power * awake + ftsa * e_arm_s + fbusy * e_arm_l;
      s_off = s_off + offered;
      s_drop = s_drop + dropped;
      s_serv = s_serv + served;
      s_wake = s_wake + wakes;
      s_busy = s_busy + fbusy;
      s_cyc = s_cyc + fcyc;
      s_awake = s_awake + awake;
      s_lat = s_lat + lat_area;
      s_vac = s_vac + vacs;
      s_nv = s_nv + nvs;
      s_ts = s_ts + ftsa;
      s_en = s_en + energy;

      // hedging: this slot's duplicates
      float dup = 0.0f;
      if (hedged) {
        dup = duplicates(adm_sum, bsum, hedge_d, hedge_den, P);
        s_dup = s_dup + dup;
      }
      // the far rack's admissions (link on), and with hedging one tree
      // for b1 and b2, the first two least-loaded hosts after the step, the
      // duplicates, split over each sender's queues, that land on b1
      // (every host's but b1's) and b1's own (to b2)
      const float far_adm = live && far ? adm_sum : 0.0f;
      float far_sum = 0.0f, to_b1 = 0.0f, to_b2 = 0.0f;
      int b1 = -1, b2 = -1;
      if (hedged) {
        const Hedge leaf = Hedge::leaf(live, h, bsum, dup * q_share, far_adm);
        const Hedge r =
            link ? static_cast<Hedge>(route.over(HedgeTree<true>{leaf}))
                 : static_cast<Hedge>(route.over(HedgeTree<false>{leaf}));
        far_sum = r.far;
        to_b1 = r.excl;
        to_b2 = r.d1;
        b1 = r.i1;
        b2 = r.i2;
        // a lone host's duplicates come back to it
        if (H == 1) {
          to_b1 = to_b2;
          b2 = b1;
        }
      } else if (link) {
        far_sum = route.over(SumOf::of(far_adm)).v;
      }
      if (topo) {
        float delay = far ? P.far_cost : P.near_cost;
        if (link && far)
          delay = delay + 1.0f / fmaxf(P.link_rate - far_sum * P.inv_dt, P.link_floor);
        s_topo = s_topo + adm_sum * delay;
      }
      if (h == b1 || h == b2) {
        const float tot = h == b1 ? to_b1 : to_b2;
#pragma unroll
        for (int q = 0; q < QQ; ++q) {
          if (q < nq) backlog[q] = backlog[q] + fminf(tot, fmaxf(cap - backlog[q], 0.0f));
        }
      }
    }
    mbar_arrive(empty + 8 * s);
  }
  if (!live) return;
  const float out[kNumStats] = {s_off, s_drop, s_serv, s_wake, s_busy, s_cyc, s_awake,
                                s_lat, s_vac, s_nv, s_ts, s_en, s_topo, s_dup};
#pragma unroll
  for (int k = 0; k < kNumStats; ++k) stats[((size_t)k * P.n_points + pt) * H + h] = out[k];
}

template <int MM, int QQ>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fleet_sweep_kernel(const Inputs in, float* __restrict__ stats, const Params P) {
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  __shared__ RedShared sh;
  const int pt = blockIdx.x;
  const int consumers = P.consumers, producer_lanes = 32 * producers(P.lanes);
  // full[s] at full + 8 s, empty[s] at empty + 8 s
  const uint32_t full = smem_u32(bars), empty = smem_u32(bars + kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, producer_lanes);
      mbar_init(empty + 8 * s, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int rank = producer_rank(threadIdx.x / 32, P.lanes);
  if ((int)threadIdx.x < consumers) {
    BlockRoute route{P.lanes, consumers, sh, 0};
    consume<MM, QQ>(route, threadIdx.x, threadIdx.x, pt, in, ring, full, empty, P, stats);
  } else if (rank >= 0) {
    produce<MM, QQ, false>(32 * rank + threadIdx.x % 32, producer_lanes, pt, 0, in, ring, full,
                           empty, P);
  }
}

// The cluster route (257 to 256 kMaxHostsPerLane hosts): a point is a
// cluster of kClusterBlocks blocks; block g's consumer warps 0 .. K - 1 run
// hosts 32 g + i + 256 k (warp k, lane i), its cluster_producers(K) producer
// warps after them fill its ring with those hosts' values.  K is a template
// parameter (one build per K): the fold's trip count, the named barrier's
// count and the ring's row stride are constants (11% less a slot at 1000
// hosts than with K read at run time, PERF.md §6).
template <int MM, int QQ, int KK>
__global__ void __launch_bounds__(32 * (KK + cluster_producers(KK)), 1)
    fleet_cluster_kernel(const Inputs in, float* __restrict__ stats, const Params P) {
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  __shared__ ClusterShared cs;
  const int pt = blockIdx.x / kClusterBlocks;
  const int g = (int)cluster_rank();
  constexpr int K = KK;
  const int consumers = 32 * K;
  const int producer_lanes = 32 * cluster_producers(K);
  const uint32_t full = smem_u32(bars), empty = smem_u32(bars + kStages);
  cluster_init(cs);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, producer_lanes);
      mbar_init(empty + 8 * s, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();
  const int t = threadIdx.x;
  if (t < consumers) {
    ClusterRoute<K> route{cs, 0};
    consume<MM, QQ>(route, 32 * g + (t & 31) + 256 * (t >> 5), t, pt, in, ring, full, empty, P,
                    stats);
  } else {
    produce<MM, QQ, true>(t - consumers, producer_lanes, pt, g, in, ring, full, empty, P);
  }
  cluster_sync();
}

// ---- the scratch route (more than 256 kMaxHostsPerLane hosts) ---------------

// One host's state, and this slot's values the cross-host stages read.
template <int MM, int QQ>
struct Host {
  float sleep[MM];
  int att[MM];
  float back[QQ], vac[QQ], res[QQ];
  float stall_end, stale;
  float s[kNumStats];
  float adm, btot, dup;   // this slot: admissions, backlog after the step, duplicates
};

template <int MM, int QQ>
__host__ __device__ constexpr int host_words() {
  return 2 * MM + 3 * QQ + 2 + kNumStats + 3;
}

// word w of host h in a point's scratch sits at base[w * H + h]
template <int MM, int QQ>
__device__ __forceinline__ void load(Host<MM, QQ>& x, const float* base, int H) {
  int w = 0;
#pragma unroll
  for (int i = 0; i < MM; ++i) x.sleep[i] = base[(w++) * H];
#pragma unroll
  for (int i = 0; i < MM; ++i) x.att[i] = __float_as_int(base[(w++) * H]);
#pragma unroll
  for (int q = 0; q < QQ; ++q) x.back[q] = base[(w++) * H];
#pragma unroll
  for (int q = 0; q < QQ; ++q) x.vac[q] = base[(w++) * H];
#pragma unroll
  for (int q = 0; q < QQ; ++q) x.res[q] = base[(w++) * H];
  x.stall_end = base[(w++) * H];
  x.stale = base[(w++) * H];
#pragma unroll
  for (int k = 0; k < kNumStats; ++k) x.s[k] = base[(w++) * H];
  x.adm = base[(w++) * H];
  x.btot = base[(w++) * H];
  x.dup = base[(w++) * H];
}

template <int MM, int QQ>
__device__ __forceinline__ void store(const Host<MM, QQ>& x, float* base, int H) {
  int w = 0;
#pragma unroll
  for (int i = 0; i < MM; ++i) base[(w++) * H] = x.sleep[i];
#pragma unroll
  for (int i = 0; i < MM; ++i) base[(w++) * H] = __int_as_float(x.att[i]);
#pragma unroll
  for (int q = 0; q < QQ; ++q) base[(w++) * H] = x.back[q];
#pragma unroll
  for (int q = 0; q < QQ; ++q) base[(w++) * H] = x.vac[q];
#pragma unroll
  for (int q = 0; q < QQ; ++q) base[(w++) * H] = x.res[q];
  base[(w++) * H] = x.stall_end;
  base[(w++) * H] = x.stale;
#pragma unroll
  for (int k = 0; k < kNumStats; ++k) base[(w++) * H] = x.s[k];
  base[(w++) * H] = x.adm;
  base[(w++) * H] = x.btot;
  base[(w++) * H] = x.dup;
}

// the single-host slot body, one thread a host, draws inline
template <int MM, int QQ>
__device__ __forceinline__ void host_step(Host<MM, QQ>& x, int t, float now, float scale,
                                          float lam_q, int m, int nq, uint32_t k0, uint32_t k1,
                                          float ts_sleep, float tl_sleep, float e_arm_s,
                                          float e_arm_l, const Params& P) {
  const float dt = P.dt;
  if (P.flags & kStallOn) {
    const Words st = philox(t, kStall, 0, 0, k0, k1);
    if (u01(st.w[0]) < P.stall_p) {
      const float end = now + P.stall_mean * expo(u01(st.w[1]));
      x.stall_end = fmaxf(x.stall_end, end);
    }
  }

  // 1. arrivals
  float z[4];
  box_muller(philox(t, kNormal, 0, 0, k0, k1), QQ, z);
  float offered = 0.f, dropped = 0.f, adm_sum = 0.f;
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    const float lq = q < nq ? lam_q : 0.0f;
    const float mu_a = P.n_seg > 0 ? lq * scale * dt : lq * dt;
    const float raw = x.res[q] + mu_a + sqrtf(mu_a) * z[q];
    const float a = fmaxf(raw, 0.0f);
    x.res[q] = fminf(raw, 0.0f);
    const float adm = fminf(a, fmaxf(P.capacity - x.back[q], 0.0f));
    x.back[q] = x.back[q] + adm;
    offered = q ? offered + a : a;
    dropped = q ? dropped + (a - adm) : a - adm;
    adm_sum = q ? adm_sum + adm : adm;
  }

  // 2. countdown + wake; stall windows defer expiring timers
  bool woken[MM];
  bool any_woken = false;
#pragma unroll
  for (int i = 0; i < MM; ++i) {
    const bool sleeping = i < m && x.att[i] < 0;
    if (sleeping) x.sleep[i] = x.sleep[i] - dt;
    woken[i] = sleeping && x.sleep[i] <= 0.0f;
    any_woken |= woken[i];
  }
  if ((P.flags & kStallOn) && any_woken && now < x.stall_end) {
    const Words jit = philox(t, kStall, 1, 0, k0, k1);
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      if (woken[i]) {
        woken[i] = false;
        x.sleep[i] = x.stall_end - now + u01(jit.w[i]);
      }
    }
  }
  float n_wake = 0.f;
#pragma unroll
  for (int i = 0; i < MM; ++i) n_wake = n_wake + (woken[i] ? 1.0f : 0.0f);

  float over[MM];
  bool have_over = false;

  bool occ[QQ];
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    occ[q] = false;
#pragma unroll
    for (int i = 0; i < MM; ++i) occ[q] |= x.att[i] == q;
  }
  float busy = 0.f, cyc = 0.f, vacs = 0.f, nvs = 0.f, tsa = 0.f;
#pragma unroll
  for (int i = 0; i < MM; ++i) {
    if (!woken[i]) continue;
    int qi = -1, eqi = -1;
    float best = 0.f;
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      const bool free_q = q < nq && !occ[q];
      if (free_q && eqi < 0) eqi = q;
      if (free_q && x.back[q] >= 1.0f && (qi < 0 || x.back[q] > best)) {
        qi = q;
        best = x.back[q];
      }
    }
    if (qi >= 0) {
#pragma unroll
      for (int q = 0; q < QQ; ++q) {
        if (q == qi) {
          vacs = vacs + x.vac[q];
          nvs = nvs + x.back[q];
          x.vac[q] = 0.0f;
          occ[q] = true;
        }
      }
      cyc = cyc + 1.0f;
      x.att[i] = qi;
    } else {
      if (!have_over) {
        overshoot<MM>(t, m, k0, k1, P, over);
        have_over = true;
      }
      if (eqi >= 0) {
#pragma unroll
        for (int q = 0; q < QQ; ++q) {
          if (q == eqi) {
            vacs = vacs + x.vac[q];
            x.vac[q] = 0.0f;
          }
        }
        cyc = cyc + 1.0f;
        tsa = tsa + 1.0f;
        x.sleep[i] = x.sleep[i] + (ts_sleep + over[i]);
      } else {
        busy = busy + 1.0f;
        x.sleep[i] = x.sleep[i] + (tl_sleep + over[i]);
      }
    }
  }

  // 3. owned queues drain at mu; 4. emptied queues release their thread
  float served = 0.f;
  bool q_done[QQ];
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    const float s = occ[q] ? fminf(x.back[q], P.mu_dt) : 0.0f;
    x.back[q] = x.back[q] - s;
    served = q ? served + s : s;
    q_done[q] = occ[q] && x.back[q] <= 1e-6f;
  }
  float n_done = 0.f;
#pragma unroll
  for (int i = 0; i < MM; ++i) {
    bool done = false;
#pragma unroll
    for (int q = 0; q < QQ; ++q) done |= x.att[i] == q && q_done[q];
    if (done) {
      if (!have_over) {
        overshoot<MM>(t, m, k0, k1, P, over);
        have_over = true;
      }
      n_done = n_done + 1.0f;
      x.sleep[i] = ts_sleep + over[i];
      x.att[i] = -1;
    }
  }
  tsa = tsa + n_done;

  // 5. vacations tick on free queues; 6. Little integral; energy
  float bsum = 0.f;
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    if (q_done[q]) occ[q] = false;
    if (q < nq && !occ[q]) x.vac[q] = x.vac[q] + dt;
    bsum = q ? bsum + x.back[q] : x.back[q];
  }
  const float lat_area = bsum * dt;
  const float awake = n_wake * P.wake_cost + served / P.mu;
  const float energy = P.active_power * awake + tsa * e_arm_s + busy * e_arm_l;
  const float vals[kNumHostStats] = {offered, dropped, served, n_wake, busy, cyc,
                                     awake, lat_area, vacs, nvs, tsa, energy};
#pragma unroll
  for (int k = 0; k < kNumHostStats; ++k) x.s[k] = x.s[k] + vals[k];
  x.adm = adm_sum;
  x.btot = bsum;
}

// Every thread a lane of W = 256; a lane holds hosts lane, lane + W, ...
template <int MM, int QQ>
__global__ void __launch_bounds__(kMaxLanes, 1)
    fleet_scratch_kernel(const Inputs in, float* __restrict__ stats, float* __restrict__ scratch,
                         const Params P) {
  __shared__ RedShared sh;
  const int pt = blockIdx.x;
  const int lane = threadIdx.x;
  const int W = P.lanes, H = P.n_hosts, K = P.hosts_per_lane;
  const float t_s = in.t_s[pt], t_l = in.t_l[pt], lam = in.lam[pt], hedge_d = in.hedge_d[pt];
  const int m = in.m[pt], nq = in.nq[pt];
  const uint32_t lo = (uint32_t)in.seed_lo[pt], hi = (uint32_t)in.seed_hi[pt];
  const float dt = P.dt;
  const float e_arm_s = arm_cost(t_s, P), e_arm_l = arm_cost(t_l, P);
  const float ts_sleep = t_s * P.one_plus_slope, tl_sleep = t_l * P.one_plus_slope;
  const bool hedged = hedge_d > 0.0f;
  const float hedge_den = 0.25f * hedge_d + P.hedge_eps;
  const float q_share = 1.0f / (float)nq;
  const bool topo = P.flags & kTopo, link = P.flags & kLink;
  float* my = scratch + (size_t)pt * host_words<MM, QQ>() * H;
  int buf = 0;

  Host<MM, QQ> x;
  for (int k = 0; k < K; ++k) {
    const int h = lane + k * W;
    if (h >= H) break;
    const Words w0 = philox(0, kInit, 0, 0, lo + (uint32_t)h, hi);
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      x.sleep[i] = i < m ? fmaxf(u01(w0.w[i]) * t_s, dt) : INFINITY;
      x.att[i] = -1;
    }
#pragma unroll
    for (int q = 0; q < QQ; ++q) x.back[q] = x.vac[q] = x.res[q] = 0.0f;
    x.stall_end = -1.0f;
    x.stale = 0.0f;
#pragma unroll
    for (int s = 0; s < kNumStats; ++s) x.s[s] = 0.0f;
    x.adm = x.btot = x.dup = 0.0f;
    store(x, my + h, H);
  }

  const float* edges = in.sched_edges + (size_t)pt * P.n_seg;
  const float* scales = in.sched_scales + (size_t)pt * P.n_seg;
  int seg = 0;

  for (int t = 0; t < P.n_live; ++t) {
    const float now = (float)t * dt;
    float scale = 1.0f;
    if (P.n_seg > 0) {
      while (seg + 1 < P.n_seg && edges[seg + 1] <= now) ++seg;
      scale = scales[seg];
    }

    // 0. least-loaded: refresh the snapshot, then the softmax's max and sum
    float mx = 0.0f, den = 1.0f;
    if (P.lb == 2) {
      const bool refresh = t % P.stale_every == 0;
      MaxOf a = MaxOf::of(-INFINITY);
      for (int k = 0; k < K; ++k) {
        const int h = lane + k * W;
        if (h >= H) break;
        load(x, my + h, H);
        if (refresh) {
          float b = 0.f;
#pragma unroll
          for (int q = 0; q < QQ; ++q) b = q ? b + x.back[q] : x.back[q];
          x.stale = b;
          store(x, my + h, H);
        }
        a.v = fmaxf(a.v, -x.stale * P.inv_soft);
      }
      mx = reduce(a, W, W, sh, buf).v;
      SumOf e_sum = SumOf::of(0.0f);
      for (int k = 0; k < K; ++k) {
        const int h = lane + k * W;
        if (h >= H) break;
        load(x, my + h, H);
        const float e = expf(-x.stale * P.inv_soft - mx);
        e_sum.v = k ? e_sum.v + e : e;
      }
      den = reduce(e_sum, W, W, sh, buf).v;
    }

    // 1. the host step, its duplicates (hedging on), and each lane's part
    // of the far rack's admissions and of b1
    Red<true, true, false> a = Red<true, true, false>::identity();
    for (int k = 0; k < K; ++k) {
      const int h = lane + k * W;
      if (h >= H) break;
      load(x, my + h, H);
      const float share = P.lb == 2 ? expf(-x.stale * P.inv_soft - mx) / den : in.shares[h];
      const float lam_q = lam * share / (float)nq;
      host_step<MM, QQ>(x, t, now, scale, lam_q, m, nq, lo + (uint32_t)h, hi, ts_sleep,
                        tl_sleep, e_arm_s, e_arm_l, P);
      if (hedged) {
        x.dup = duplicates(x.adm, x.btot, hedge_d, hedge_den, P);
        x.s[13] = x.s[13] + x.dup;
      }
      const float far_adm = h < P.far_count ? x.adm : 0.0f;
      a.sum = k ? a.sum + far_adm : far_adm;
      if (x.btot < a.v) {
        a.v = x.btot;
        a.i = h;
      }
      store(x, my + h, H);
    }
    if (!(topo || hedged)) continue;
    const Red<true, true, false> r1 = reduce(a, W, W, sh, buf);
    const int b1 = r1.i;
    float gap = 1.0f;
    if (link) gap = fmaxf(P.link_rate - r1.sum * P.inv_dt, P.link_floor);

    // 2. hedging: the duplicates, split over the sender's queues, that land
    // on b1 (every host's but b1's) and b2, the first least-loaded host
    // other than b1
    float to_b1 = 0.0f, to_b2 = 0.0f;
    int b2 = b1;
    if (hedged) {
      Red<true, true, true> c = Red<true, true, true>::identity();
      for (int k = 0; k < K; ++k) {
        const int h = lane + k * W;
        if (h >= H) break;
        load(x, my + h, H);
        const float dup = x.dup * q_share;
        const float give = h == b1 ? 0.0f : dup;
        c.sum = k ? c.sum + give : give;
        if (h == b1) {
          c.mx = dup;   // the lone non-negative value: b1's own duplicates
        } else if (x.btot < c.v) {
          c.v = x.btot;
          c.i = h;
        }
      }
      const Red<true, true, true> r2 = reduce(c, W, W, sh, buf);
      to_b1 = r2.sum;
      to_b2 = r2.mx;
      b2 = r2.i;
    }

    // 3. each host's network delay and injection
    for (int k = 0; k < K; ++k) {
      const int h = lane + k * W;
      if (h >= H) break;
      load(x, my + h, H);
      if (topo) {
        const bool far = h < P.far_count;
        float delay = far ? P.far_cost : P.near_cost;
        if (link && far) delay = delay + 1.0f / gap;
        x.s[12] = x.s[12] + x.adm * delay;
      }
      if (hedged && (h == b1 || h == b2)) {
        const float tot = h == b1 ? to_b1 : to_b2;
#pragma unroll
        for (int q = 0; q < QQ; ++q) {
          if (q < nq) x.back[q] = x.back[q] + fminf(tot, fmaxf(P.capacity - x.back[q], 0.0f));
        }
      }
      store(x, my + h, H);
    }
  }

  for (int k = 0; k < K; ++k) {
    const int h = lane + k * W;
    if (h >= H) break;
    load(x, my + h, H);
#pragma unroll
    for (int s = 0; s < kNumStats; ++s)
      stats[((size_t)s * P.n_points + pt) * H + h] = x.s[s];
  }
}

// ---- a timing probe of the cluster route's exchange -------------------------
// One cluster runs n exchanges in turn, each feeding the next.  Mode 0: one
// warp a block, whose lanes 0-7 push a 16-byte record into every block of
// the cluster (st.async onto its barrier), then the warp waits on its own
// and reads a partial: the exchange alone.  Mode 1: cluster_reduce of a sum (4
// bytes) among 32 K consumer threads a block; mode 2: of the hedge record
// (32 bytes, the link on).  Each thread writes what it got, so that nothing
// is elided.
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kMaxThreads, 1)
    cluster_exchange_probe(int mode, int K, int n, float* __restrict__ out) {
  __shared__ ClusterShared cs;
  cluster_init(cs);
  if (threadIdx.x == 0) asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  cluster_sync();
  const int lane = threadIdx.x & 31;
  const float x = (float)(threadIdx.x + 1);
  float acc = 0.0f;
  int xc = 0;
  for (int it = 0; it < n; ++it) {
    if (mode == 0) {
      const int b = xc & 1;
      const uint32_t parity = (xc >> 1) & 1;
      ++xc;
      __syncwarp();   // every lane has read the buffer this push may reuse
      if (lane == 0) mbar_expect_tx(smem_u32(&cs.bar[b]), kClusterBlocks * 16);
      if (lane < kClusterBlocks) {
        const uint32_t dst = map_rank(smem_u32(&cs.part[b][0][cluster_rank()]), lane);
        const uint32_t rbar = map_rank(smem_u32(&cs.bar[b]), lane);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          st_async(dst + 4 * kClusterBlocks * k, __float_as_uint(x + acc), rbar);
      }
      mbar_wait_cluster(smem_u32(&cs.bar[b]), parity);
      acc = acc + __uint_as_float(cs.part[b][lane & 3][lane & (kClusterBlocks - 1)]) * 1e-30f;
    } else if (mode == 1) {
      acc = acc + cluster_reduce(SumOf::of(x + acc), K, cs, xc).v * 1e-30f;
    } else {
      const HedgeTree<true> leaf{Hedge::leaf(true, threadIdx.x, x + acc, x, x)};
      acc = acc + cluster_reduce(leaf, K, cs, xc).full * 1e-30f;
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  cluster_sync();
}

// The slots the run has: the first t with !(float(t) * dt < duration), or
// n_slots (float(t) * dt does not decrease with t, so bisection finds it)
int live_slots(float dt, float duration, int n_slots) {
  int lo = 0, hi = n_slots;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if ((float)mid * dt < duration) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A point a cluster of kClusterBlocks blocks.  A launch the card cannot
// place (no cluster of this shared memory and these threads fits) returns an
// error: nothing falls back to another route.
template <int MM, int QQ, int KK>
cudaError_t launch_cluster(const Inputs& in, void* stats, const Params& P, cudaStream_t st) {
  const size_t smem = Layout<MM, QQ>::smem_bytes(32 * P.hosts_per_lane, P.flags);
  auto kernel = fleet_cluster_kernel<MM, QQ, KK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.n_points * kClusterBlocks);
  cfg.blockDim = dim3(32 * (P.hosts_per_lane + cluster_producers(P.hosts_per_lane)));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, in, static_cast<float*>(stats), P);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MM, int QQ>
cudaError_t launch(const Inputs& in, void* stats, void* scratch, Params P, cudaStream_t st) {
  if (P.hosts_per_lane > 1 && P.hosts_per_lane <= kMaxHostsPerLane)
    switch (P.hosts_per_lane) {
      case 2: return launch_cluster<MM, QQ, 2>(in, stats, P, st);
      case 3: return launch_cluster<MM, QQ, 3>(in, stats, P, st);
      case 4: return launch_cluster<MM, QQ, 4>(in, stats, P, st);
      case 5: return launch_cluster<MM, QQ, 5>(in, stats, P, st);
      case 6: return launch_cluster<MM, QQ, 6>(in, stats, P, st);
      case 7: return launch_cluster<MM, QQ, 7>(in, stats, P, st);
      case 8: return launch_cluster<MM, QQ, 8>(in, stats, P, st);
      default: return cudaErrorInvalidValue;
    }
  if (P.hosts_per_lane > 1) {
    fleet_scratch_kernel<MM, QQ><<<P.n_points, kMaxLanes, 0, st>>>(
        in, static_cast<float*>(stats), static_cast<float*>(scratch), P);
    return cudaGetLastError();
  }
  const size_t smem = Layout<MM, QQ>::smem_bytes(P.lanes, P.flags);
  cudaError_t err = cudaFuncSetAttribute(fleet_sweep_kernel<MM, QQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  P.consumers = 32 * consumer_warps(P.lanes);
  const int threads = 32 * block_warps(P.lanes);
  fleet_sweep_kernel<MM, QQ><<<P.n_points, threads, smem, st>>>(in, static_cast<float*>(stats),
                                                                 P);
  return cudaGetLastError();
}

// the route of a point whose lanes hold `hosts_per_lane` hosts each
enum Route : int { kRing = 0, kScratch = 1, kCluster = 2 };
int route_for(int hosts_per_lane) {
  return hosts_per_lane == 1 ? kRing : hosts_per_lane <= kMaxHostsPerLane ? kCluster : kScratch;
}

}  // namespace

extern "C" {

// Launch layout of a point of n_hosts hosts with up to q_max queues and the
// noise flags `flags` (host, 10 ints out): out[0] threads a block, out[1]
// lanes of the host reductions, out[2] hosts a lane, out[3] float32 words of
// scratch a host (0 where a thread holds one host in registers), out[4]
// producer warps a block, out[5] stages of the ring, out[6] slots a stage,
// out[7] bytes of a block's ring (dynamic shared memory; 32 K lanes on the
// cluster route), out[8] blocks a point, out[9] the route (0 ring, up to 256
// hosts; 2 cluster, up to 256 kMaxHostsPerLane; 1 scratch, beyond: no ring).
void fleet_sweep_layout(int n_hosts, int q_max, int flags, int* out) {
  const int w = lanes_for(n_hosts);
  const int k = (n_hosts + w - 1) / w;
  const int route = route_for(k);
  const int rows = route == kCluster ? 32 * k : w;   // a ring row's host lanes
  out[0] = route == kRing ? 32 * block_warps(w)
           : route == kCluster ? 32 * (k + cluster_producers(k)) : kMaxLanes;
  out[1] = w;
  out[2] = k;
  out[3] = route != kScratch ? 0 : (q_max == 1 ? host_words<4, 1>() : host_words<4, 4>());
  out[4] = route == kRing ? producers(w) : route == kCluster ? cluster_producers(k) : 0;
  out[5] = route == kScratch ? 0 : kStages;
  out[6] = route == kScratch ? 0 : kStageSlots;
  out[7] = route == kScratch ? 0
                             : (int)(q_max == 1 ? Layout<4, 1>::smem_bytes(rows, flags)
                                                : Layout<4, 4>::smem_bytes(rows, flags));
  out[8] = route == kCluster ? kClusterBlocks : 1;
  out[9] = route;
}

// Inputs, one per point (n_points): t_s, t_l, lam (the point's fleet rate),
// hedge_d f32; m, nq, seed_lo, seed_hi int32 (the seed's two 32-bit words);
// sched_edges and sched_scales f32 (n_points, n_seg), or null with n_seg = 0;
// shares f32 (n_hosts), the static LB shares (lb 0 or 1).  Outputs: stats f32
// (14, n_points, n_hosts) in the order offered, dropped, serviced, wakeups,
// busy_tries, cycles, awake_us, lat_area, vac_sum, nv_sum, ts_arms,
// energy_uj, topo_area, hedge_dup; scratch f32 (n_points, words, n_hosts)
// with words from fleet_sweep_layout (unused when it gives 0).  m_max, q_max
// <= 4; lb 0 uniform, 1 weighted, 2 least-loaded.  flags: 1 sigma, 2 tail, 4
// interference, 8 stalls, 16 topology, 32 the bottleneck link.  fparams
// (host, 24): slot_us, duration_us, mu, mu * slot_us, capacity, wake_cost_us,
// base_us, sigma_us, 1 + slope, tail_prob, tail_mean_us, interference_prob,
// interference_mean_us, stall_p, stall_mean_us, active_power_w, 1 / softness,
// near_cost_us, far_cost_us, link_rate_mpps, (1 - 0.98) link_rate_mpps, 1 /
// slot_us, 1 / mu, 1e-6.  states (host, 3 n_states): (power_w,
// transition_uj, min_residency_us), shallow to deep.  build (host, 3 ints
// out): the (M_MAX, Q_MAX) instantiation launched and its route (0 ring, 1
// scratch, 2 cluster).  Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
int fleet_sweep_fwd(const void* t_s, const void* t_l, const void* m, const void* nq,
                    const void* lam, const void* seed_lo, const void* seed_hi,
                    const void* hedge_d, const void* sched_edges, const void* sched_scales,
                    const void* shares, void* stats, void* scratch, int n_points, int n_hosts,
                    int n_slots, int m_max, int q_max, int n_seg, int lb, int stale_every,
                    int far_count, int flags, const float* fparams, int n_fparams,
                    const float* states, int n_states, int device, int* build,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_points <= 0 || n_hosts <= 0 || n_slots < 0 || m_max < 1 || m_max > 4 || q_max < 1 ||
      q_max > 4 || n_fparams != kNumFParams || n_states < 1 || n_states > kMaxStates ||
      n_seg < 0 || (n_seg > 0 && (sched_edges == nullptr || sched_scales == nullptr)) ||
      lb < 0 || lb > 2 || stale_every < 1 || far_count < 0 || far_count > n_hosts ||
      scratch == nullptr || shares == nullptr)
    return (int)cudaErrorInvalidValue;
  Params P;
  float* dst[kNumFParams] = {&P.dt,         &P.duration,  &P.mu,         &P.mu_dt,
                             &P.capacity,   &P.wake_cost, &P.base,       &P.sigma,
                             &P.one_plus_slope, &P.tail_prob, &P.tail_mean, &P.intf_prob,
                             &P.intf_mean,  &P.stall_p,   &P.stall_mean, &P.active_power,
                             &P.inv_soft,   &P.near_cost, &P.far_cost,   &P.link_rate,
                             &P.link_floor, &P.inv_dt,    &P.inv_mu,     &P.hedge_eps};
  for (int k = 0; k < kNumFParams; ++k) *dst[k] = fparams[k];
  for (int s = 0; s < kMaxStates; ++s) {
    const bool on = s < n_states;
    P.st_power[s] = on ? states[3 * s] : 0.0f;
    P.st_trans[s] = on ? states[3 * s + 1] : 0.0f;
    P.st_thr[s] = on ? states[3 * s + 2] : 0.0f;
  }
  P.n_states = n_states;
  P.flags = flags;
  P.n_points = n_points;
  P.n_hosts = n_hosts;
  P.n_live = live_slots(P.dt, P.duration, n_slots);
  P.n_seg = n_seg;
  P.lb = lb;
  P.stale_every = stale_every;
  P.far_count = far_count;
  P.lanes = lanes_for(n_hosts);
  P.hosts_per_lane = (n_hosts + P.lanes - 1) / P.lanes;
  P.consumers = P.lanes;
  const Inputs in{static_cast<const float*>(t_s),          static_cast<const float*>(t_l),
                  static_cast<const int*>(m),              static_cast<const int*>(nq),
                  static_cast<const float*>(lam),          static_cast<const int*>(seed_lo),
                  static_cast<const int*>(seed_hi),        static_cast<const float*>(hedge_d),
                  static_cast<const float*>(sched_edges),  static_cast<const float*>(sched_scales),
                  static_cast<const float*>(shares)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  build[0] = 4;
  build[1] = q_max == 1 ? 1 : 4;
  build[2] = route_for(P.hosts_per_lane);
  return (int)(q_max == 1 ? launch<4, 1>(in, stats, scratch, P, st)
                          : launch<4, 4>(in, stats, scratch, P, st));
}

// The exchange probe (cluster_exchange_probe): one cluster of kClusterBlocks
// blocks, of 32 threads in mode 0 and of 32 hosts_per_lane threads in modes
// 1 and 2, n exchanges; out f32 (kClusterBlocks x the block's threads).
// Returns a cudaError_t; the launch is asynchronous on `stream`.
int fleet_cluster_exchange_probe(int mode, int hosts_per_lane, int n, void* out, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (mode < 0 || mode > 2 || hosts_per_lane < 1 || hosts_per_lane > kMaxHostsPerLane || n < 0)
    return (int)cudaErrorInvalidValue;
  const int threads = mode == 0 ? 32 : 32 * hosts_per_lane;
  cluster_exchange_probe<<<kClusterBlocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, hosts_per_lane, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* fleet_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
