// Fleet sweep by event jumps (S3b) for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the event-jump body of the reference's fleet engine,
// src/repro/runtime/fleet.py, _build_fleet_sweep.fleet_step_a (:497): a
// lax.scan over the step budget (:794) under jax.jit(jax.vmap(one_fleet))
// (:798-808), the hosts of a point under an inner vmap (:715).  It is not a
// pallas_call, but it is the reference's accelerator hot path for fleets
// swept by event jumps.
//
// What one point computes, step by step, all in float32, every host in
// lock-step (kernels/fleet_adaptive_sweep/ops.py's docstring has the
// formulas):
//   schedule, balancer  the schedule's segment at now = duration - remaining;
//                       under least-loaded, where now + 1e-6 reaches the
//                       refresh lattice's next point, the snapshot of the
//                       hosts' backlogs, its softmax (exp(x - max) / sum) and
//                       the lattice's next point; the hosts' queue rates
//                       (lam * share * scale) * (1 / n_queues);
//   the jump            one dt for the point: the least over its hosts of
//                       every host's wake, drain-out, fill and next stall
//                       start, with the segment's end, the refresh lattice and
//                       the remaining time, floored and paced as the
//                       event-jump sweep's (csrc/adaptive_sweep.cu);
//   host step           every host runs the event-jump sweep's closed-form
//                       macro-slot at that dt (adaptive_sweep.cu's consume);
//   topology, hedging   as the fixed-slot fleet sweep's (csrc/fleet_sweep.cu),
//                       with the far rack's rate far / dt, a division;
//   past the duration   the block stops (the reference holds the carry).
// Every sum over a point's hosts runs in fleet_sweep.cu's one order
// (kernels/fleet_sweep/ops.py:host_sum); minima take no order.  The plain
// version, kernels/fleet_adaptive_sweep/ops.py:reference_fleet_adaptive_sweep,
// makes the same float32 operations in the same order, and this file is
// built with -fmad=false, so on the same draws the two agree bit for bit.
//
// Noise: the event-jump sweep's Philox contract
// (kernels/adaptive_sweep/philox.py, counter (step, stream, lane block, 1)),
// host h of a point keyed as ((seed_lo + h) mod 2^32, seed_hi): the
// reference's per-host key (fleet.py:243-258), so host h draws the stream of
// a single point seeded seed + h.
//
// What binds: a fleet grid has 4-8 points and a point's hosts meet at every
// step (the jump is a minimum over all of them, the balancer reads all
// backlogs, the link all admissions, the hedge all backlogs), so a point is
// one block and a call lasts one block's dependent chain of steps.  The
// design is the two halves the port already has, the fixed-slot fleet
// sweep's block layout around the event-jump sweep's host body:
//  1. Warp specialisation (the ring route, H <= 256).  A block is a point:
//     consumer warps, max(1, W / 32) of them (W = the least power of two >=
//     H), one host a lane with its whole state in registers (below 32 lanes,
//     every host in 32 / W lanes of the warp: the note, 3), run the jumps;
//     producer warps make every host's state-free values of every step, the
//     event-jump sweep's fields (its Layout): the queues' normals, the
//     threads' overshoots and, with stalls on, the stall window's length and
//     gap and the threads' re-arm jitters.  Six producer warps beside one
//     consumer warp, four beside two, four or eight (producers()); below four
//     consumer warps the producers take only the schedulers (warp % 4) no
//     consumer uses.
//  2. A ring of kStages stages of kStageSteps steps in dynamic shared memory,
//     laid out [step][field][lane], handed over by mbarriers: full[s] (every
//     producer lane arrives, the consumers wait) and empty[s] (every consumer
//     lane arrives, the producers wait), with phase parities.  At <4, 4> with
//     stalls on and 256 lanes a step is 14 fields x 256 lanes x 4 B, so two
//     stages of 8 steps take 229,376 B of the 232,448 a block can use.
//  3. Three host reductions a step at most, on a named barrier (bar.sync 1,
//     the consumer threads; never __syncthreads once the roles split, or a
//     producer waiting on `empty` would deadlock it), as butterflies in
//     host_sum's order: on refresh steps, the softmax's max and sum; every
//     step, the jump's two minima (min(wake, drain-out) and min(fill, next
//     stall start): the first also bounds the floor); after the host step, the
//     far rack's admissions (link on) or the hedge stage as one tree.  The
//     jump reads the backlogs after the last step's hedge injection, so it
//     cannot ride in that step's hedge tree (a tree that carried the next
//     step's minima, with the two candidates' bounds recomputed after their
//     injection, was bit-equal but 22-33% slower a step; PERF.md §5).  The
//     point's clock must stay alike in every consumer thread, and below 32
//     lanes a butterfly over W lanes leaves the other lanes of the warp with
//     their own groups' results: so lane l runs host l mod W, every group of
//     W lanes holds the point's hosts, alike bit for bit, and every lane gets
//     each reduction's result with no broadcast from lane 0 (PERF.md §5 has
//     what that broadcast cost; the first copy writes the outputs).  W is a
//     template parameter of the ring route's kernel (one instantiation for
//     each power of two from 1 to 256): a reduction's rounds and the ring's
//     strides are then constants, a warp's reductions carry no cross-warp
//     code, and a step takes 16-19% less than with W read at run time.
//     Within one warp the hedge tree then runs as two passes (Top2, DupSums)
//     so that its argmin rounds overlap the hedge gate: 3-4% less a step at
//     4 and 16 hosts, nothing at 64, where the single tree stays.
//  4. The run ends at a step no one knows in advance.  The remaining time is
//     the same in every lane of the block, so the block stops as one: the
//     first consumer thread stores the step in shared memory (`stop`), every
//     consumer releases the stage it stopped in, and a producer reads `stop`
//     after each wait on `empty` and leaves once the consumers stopped before
//     that stage (the event-jump sweep's protocol, adaptive_sweep.cu's note
//     3: one release, no further arrival).
//  5. Beyond the cluster route (the scratch route): a thread holds hosts j,
//     j + 256, ..., whose states live in a global scratch (point, word,
//     host), coalesced across the block, one host loaded and stored at a
//     time, the draws made inline, the reductions of 3 over all 256 threads
//     (the hedge stage's two in turn, as fleet_sweep.cu's scratch route).
//  6. M_MAX and Q_MAX are template parameters (<4, 1> and <4, 4>), and on
//     the ring route log2 W (0-8); lanes past a point's m or n_queues add
//     exact zeros, and the jump and the arrivals skip the queues past its
//     n_queues.
//  7. Beyond 256 hosts (the cluster route, up to 256 kMaxHostsPerLane):
//     fleet_sweep.cu's cluster route (its note 6) around this file's host
//     body.  A point is a cluster of 8 blocks; block g's consumer warp k runs
//     host 32 g + i + 256 k in lane i, with its state in registers; its four
//     producer warps fill a ring of this file's layout with the block's
//     hosts' values (32 K lanes a row); each host reduction (the jump's two
//     minima every step; the hedge tree, or the far rack's sum, after the
//     host step; the softmax's max and sum on refresh steps) is one exchange
//     of the 8 blocks' partials through distributed shared memory, in
//     host_sum's order.  The remaining time is alike in every block, so
//     every block stops at the same step, each with the early-stop protocol
//     of 4 on its own ring.  K_max = 7: at <4, 4> with stalls a step is 14
//     fields, so two stages of 8 steps take 28,672 K bytes, and with the K
//     warps' records (1 KB a warp) K = 8 would not fit 227 KB.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLanes = 256;
constexpr int kMaxWarps = kMaxLanes / 32;
constexpr int kStageSteps = 8;   // steps a stage of the ring
constexpr int kStages = 2;
constexpr int kMaxThreads = 32 * (kMaxWarps + 4);   // eight consumer warps beside four producers
constexpr int kRedBarrier = 1;   // the named barrier of the host reductions
constexpr int kMaxStates = 4;
constexpr int kNumFParams = 27;
constexpr int kNumStats = 14;
constexpr uint32_t kWord3 = 1;   // the event-jump sweep's counter word
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTwoPi = 6.28318548202514648f;   // float32(2 pi)
constexpr float kRateEps = 1e-9f;                 // batched_adaptive._RATE_EPS
constexpr float kWakeEps = 1e-6f;                 // batched_adaptive._WAKE_EPS_US
constexpr float kRelease = 1e-6f;                 // a drained queue releases at <= 1e-6

enum Stream : uint32_t { kInit = 0, kNormal = 1, kTail = 2, kIntf = 3, kStall = 4 };
enum Flag : int { kSigma = 1, kTailOn = 2, kIntfOn = 4, kStallOn = 8, kTopo = 16, kLink = 32 };

struct Params {
  float floor, duration, mu, inv_mu, cap, cap_fill, wake_cost, base, sigma, slope1;
  float tail_prob, tail_mean, intf_prob, intf_mean, inv_stall, stall_mean;
  float active_power, steps_f, tail_steps;
  float inv_soft, near_cost, far_cost, link_rate, link_floor, hedge_eps, stale, inv_stale;
  float st_power[kMaxStates], st_trans[kMaxStates], st_thr[kMaxStates];
  int n_states, flags;
  int n_points, n_hosts, n_run, n_seg, lb, far_count;
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

// A ring stage's fields, per step and host lane: the event-jump sweep's
// (adaptive_sweep.cu's Layout) with a host lane in place of a point lane.
template <int MM, int QQ>
struct Layout {
  static constexpr int kZ = 0, kOver = QQ, kLen = QQ + MM, kGap = QQ + MM + 1,
                       kJit = QQ + MM + 2;
  static __host__ __device__ int fields(int flags) {
    return (flags & kStallOn) ? kJit + MM : kLen;
  }
  static __host__ __device__ int stage_floats(int lanes, int flags) {
    return kStageSteps * fields(flags) * lanes;
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

// consumer warps of a point of `lanes` host lanes, the producer warps beside
// them, and the block's warps (the design note, 1)
__host__ __device__ inline int consumer_warps(int lanes) { return lanes < 32 ? 1 : lanes / 32; }
__host__ __device__ inline int producers(int lanes) { return consumer_warps(lanes) == 1 ? 6 : 4; }
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

// One step's state-free values of a host (the plain version's _step_inputs
// before the re-sleep sums): the queues' normals, the threads' overshoots
// (base + sigma |z| + the tail's and interference's hits, every family's
// blocks drawn, a miss adding nothing) and, with stalls on, the window's
// length and gap and the re-arm jitters.
template <int MM, int QQ>
struct Step {
  float z[QQ], over[MM], len, gap, jit[MM];
};

template <int MM, int QQ>
__device__ __forceinline__ void draw_step(Step<MM, QQ>& x, int t, int m, uint32_t k0,
                                          uint32_t k1, const Params& P) {
  float z[4];
  box_muller(philox(t, kNormal, 0, kWord3, k0, k1), QQ, z);
#pragma unroll
  for (int q = 0; q < QQ; ++q) x.z[q] = z[q];
#pragma unroll
  for (int i = 0; i < MM; ++i) x.over[i] = P.base;
  if (P.flags & kSigma) {
    box_muller(philox(t, kNormal, 1, kWord3, k0, k1), m, z);
#pragma unroll
    for (int i = 0; i < MM; ++i) x.over[i] = x.over[i] + P.sigma * fabsf(z[i]);
  }
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const bool on = f == 0 ? (P.flags & kTailOn) : (P.flags & kIntfOn);
    if (!on) continue;
    const uint32_t stream = f == 0 ? kTail : kIntf;
    const float prob = f == 0 ? P.tail_prob : P.intf_prob;
    const float mean = f == 0 ? P.tail_mean : P.intf_mean;
    const Words hit = philox(t, stream, 0, kWord3, k0, k1);
    const Words len = philox(t, stream, 1, kWord3, k0, k1);
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      if (i < m && u01(hit.w[i]) < prob) x.over[i] = x.over[i] + mean * expo(u01(len.w[i]));
    }
  }
  if (P.flags & kStallOn) {
    const Words st = philox(t, kStall, 0, kWord3, k0, k1);
    x.len = P.stall_mean * expo(u01(st.w[0]));
    x.gap = expo(u01(st.w[1])) * P.inv_stall;
    const Words jit = philox(t, kStall, 1, kWord3, k0, k1);
#pragma unroll
    for (int i = 0; i < MM; ++i) x.jit[i] = u01(jit.w[i]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// release semantics at the block's scope (the default of mbarrier.arrive)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of the given parity has completed
// (acquire semantics at the block's scope).
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
// fleet_sweep.cu's: within each warp a halving tree over its L = min(W, 32)
// lanes as a butterfly (__shfl_xor_sync), then the same tree over the W / 32
// warps' results (in shared memory, double-buffered, one barrier a
// reduction).  Below 32 lanes each group of W lanes of the warp holds the
// point's hosts and reduces them alone (the design note, 3); a host past the
// point's H holds the identity; argmins keep the lowest host index among
// equal values.

__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

struct MaxOf {
  float v;
  __device__ void butterfly(int off) { v = fmaxf(v, __shfl_xor_sync(kFull, v, off)); }
  __device__ void fold(const MaxOf& o) { v = fmaxf(v, o.v); }
};

struct SumOf {
  float v;
  __device__ void butterfly(int off) { v = v + __shfl_xor_sync(kFull, v, off); }
  __device__ void fold(const SumOf& o) { v = v + o.v; }
};

// the jump's two minima: min(wake, drain-out) and min(fill, next stall)
struct MinOf2 {
  float a, b;
  __device__ void butterfly(int off) {
    a = fminf(a, __shfl_xor_sync(kFull, a, off));
    b = fminf(b, __shfl_xor_sync(kFull, b, off));
  }
  __device__ void fold(const MinOf2& o) {
    a = fminf(a, o.a);
    b = fminf(b, o.b);
  }
};

// A sum (SUM), an argmin over (v, i) (ARG), a max (MX): the scratch route's.
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

// The hedge stage in one tree (fleet_sweep.cu's Hedge): over a subtree, the
// two first least-loaded hosts (v1, i1) and (v2, i2), the duplicates d1 of
// the first, the sum of the subtree's duplicates (full) and that sum with the
// first's zeroed (excl), and with the link on the far rack's admissions.
struct Hedge {
  float full, excl, v1, v2, d1, far;
  int i1, i2;
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

// Within one warp (W <= 32) the hedge tree runs as two passes over the same
// halving tree.  The first (Top2) needs only the backlogs after the host
// step, so its rounds run between the parts of the hedge gate (an expf and
// two divisions): the subtree's two first least-loaded hosts and far-rack
// admissions, and at each round whether the other subtree held the first.
// The second (DupSums) replays those rounds on the duplicates once the gate
// is done: Hedge's full, excl and d1, each add where Hedge::combine makes it.
// (Hedge::combine keeps its own copy of this logic: built from these two
// halves, the one tree took 2-3% more a step at 16 and 64 hosts.)
struct Top2 {
  float v1, v2, far;
  int i1, i2;
  __device__ static Top2 leaf(bool live, int h, float btot, float far_adm) {
    if (!live) return {INFINITY, INFINITY, 0.0f, 0x7fffffff, 0x7fffffff};
    return {btot, INFINITY, far_adm, h, 0x7fffffff};
  }
  __device__ Top2 shfl(int off) const {
    return {__shfl_xor_sync(kFull, v1, off), __shfl_xor_sync(kFull, v2, off),
            __shfl_xor_sync(kFull, far, off), __shfl_xor_sync(kFull, i1, off),
            __shfl_xor_sync(kFull, i2, off)};
  }
  // the other subtree's merged in; whether it held the first
  __device__ bool merge(const Top2& o) {
    far = far + o.far;
    const bool other_first = before(o.v1, o.i1, v1, i1);
    if (other_first) {
      const bool mine = before(v1, i1, o.v2, o.i2);
      v2 = mine ? v1 : o.v2;
      i2 = mine ? i1 : o.i2;
      v1 = o.v1;
      i1 = o.i1;
    } else if (before(o.v1, o.i1, v2, i2)) {
      v2 = o.v1;
      i2 = o.i1;
    }
    return other_first;
  }
};

struct DupSums {
  float full, excl, d1;
  __device__ DupSums shfl(int off) const {
    return {__shfl_xor_sync(kFull, full, off), __shfl_xor_sync(kFull, excl, off),
            __shfl_xor_sync(kFull, d1, off)};
  }
  __device__ void merge(const DupSums& o, bool other_first) {
    if (other_first) {
      excl = full + o.excl;
      d1 = o.d1;
    } else {
      excl = excl + o.full;
    }
    full = full + o.full;
  }
};

struct RedShared {
  __align__(16) unsigned char slot[2][kMaxWarps][32];
};

// The reduction of W lanes among `threads` threads, W read at run time (the
// scratch route's, where W is 256; W <= 32 would be one warp, no barrier);
// every thread gets the result.  `buf` alternates the shared buffers.
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

// The same with W a compile-time constant (the ring route's consumers): no
// branch guards a round, and one warp's reductions keep no cross-warp code.
template <int W, class T>
__device__ __forceinline__ T reduce(T a, int threads, RedShared& sh, int& buf) {
  static_assert(sizeof(T) <= 32, "a reduction's partial result fits its shared slot");
  constexpr int L = W < 32 ? W : 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < L) a.butterfly(off);
  }
  if constexpr (W <= 32) {
    return a;
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) *reinterpret_cast<T*>(sh.slot[buf][warp]) = a;
    asm volatile("bar.sync %0, %1;" ::"r"(kRedBarrier), "r"(threads) : "memory");
    constexpr int G = W >> 5;
    a = *reinterpret_cast<const T*>(sh.slot[buf][lane & (G - 1)]);
    buf ^= 1;
#pragma unroll
    for (int off = kMaxWarps / 2; off > 0; off >>= 1) {
      if (off < G) a.butterfly(off);
    }
    return a;
  }
}

// ---- the cluster route's exchange (the design note, 7) ----------------------
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
constexpr int kMaxHostsPerLane = 7;   // K at most: the ring of 32 K lanes fits beside the rest
constexpr int kMaxRecord = 8;         // words of the largest reduction record (Hedge)
constexpr int kClusterProducers = 4;  // producer warps a block

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

// ---- one host: its state, its bounds, its macro-slot --------------------------

// A host's state, and this step's values the cross-host stages read.  A
// thread's owner is -1 while it sleeps, -2 for a lane past the point's m,
// else the queue it drains.
template <int MM, int QQ>
struct Host {
  float sleep[MM];
  int att[MM];
  float back[QQ], vac[QQ], res[QQ];
  float stall_end, next_stall, share;
  float s[kNumStats];
  float adm, btot, dup;   // this step: admissions, backlog after the step, duplicates
};

// The point's constants a host's step reads.
struct PointConsts {
  float t_s, lam, ts1, tl1, e_arm_s, e_arm_l, q_recip;
  int m, nq;
};

template <int MM, int QQ>
__device__ __forceinline__ void host_init(Host<MM, QQ>& x, const PointConsts& c, uint32_t k0,
                                          uint32_t k1, float share, const Params& P) {
  const Words w0 = philox(0, kInit, 0, kWord3, k0, k1);
#pragma unroll
  for (int i = 0; i < MM; ++i) {
    x.sleep[i] = i < c.m ? fmaxf(u01(w0.w[i]) * c.t_s, P.floor) : INFINITY;
    x.att[i] = i < c.m ? -1 : -2;
  }
#pragma unroll
  for (int q = 0; q < QQ; ++q) x.back[q] = x.vac[q] = x.res[q] = 0.0f;
  x.stall_end = -1.0f;
  x.next_stall = (P.flags & kStallOn)
                     ? expo(u01(philox(0, kInit, 1, kWord3, k0, k1).w[0])) * P.inv_stall
                     : INFINITY;
  x.share = share;
#pragma unroll
  for (int k = 0; k < kNumStats; ++k) x.s[k] = 0.0f;
  x.adm = x.btot = x.dup = 0.0f;
}

// the host's queue rate at this step's scale: (lam * share * scale) * (1 /
// n_queues); with the uniform balancer the reference folds the share (a
// broadcast constant) into the scale first
__device__ __forceinline__ float queue_rate(float lam, float share, float scale,
                                            float q_recip, const Params& P) {
  float lh;
  if (P.n_seg == 0) {
    lh = lam * share;
  } else if (P.lb == 0) {
    lh = lam * (scale * share);
  } else {
    lh = (lam * share) * scale;
  }
  return lh * q_recip;
}

// A host's boundaries: min(wake, drain-out) and min(fill, next stall start),
// and each queue's drain-out time (infinite where it does not drain).
template <int MM, int QQ>
__device__ __forceinline__ void host_bounds(const Host<MM, QQ>& x, const int occ[QQ], float lq,
                                            int nq, float now, const Params& P, float& wd,
                                            float& fs, float drain_q[QQ]) {
  float wake = INFINITY;
#pragma unroll
  for (int i = 0; i < MM; ++i) {
    if (x.att[i] == -1) wake = fminf(wake, fmaxf(x.sleep[i], 0.0f));
  }
  float drain_dt = INFINITY, fill_dt = INFINITY;
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    drain_q[q] = INFINITY;
    if (q > 0 && q >= nq) continue;    // past the point's queues
    // one division a queue, its operands selected (adaptive_sweep.cu's 4)
    const float net_out = P.mu - lq;
    const float net_in = lq - (occ[q] ? P.mu : 0.0f);
    const bool drains = occ[q] && net_out > kRateEps;
    const bool fills = net_in > kRateEps && x.back[q] < P.cap_fill;
    const float quo = (drains ? fmaxf(x.back[q], 0.0f) : P.cap - x.back[q]) /
                      fmaxf(drains ? net_out : net_in, kRateEps);
    if (drains) drain_q[q] = quo;
    drain_dt = fminf(drain_dt, drain_q[q]);
    if (fills) fill_dt = fminf(fill_dt, quo);
  }
  wd = fminf(wake, drain_dt);
  fs = (P.flags & kStallOn) ? fminf(fill_dt, x.next_stall - now) : fill_dt;
}

// The event-jump sweep's macro-slot of one host at the shared dt
// (adaptive_sweep.cu's consume, steps 1-7), then its sums; leaves the step's
// admissions and backlog in x.adm and x.btot.
template <int MM, int QQ>
__device__ __forceinline__ void host_step(Host<MM, QQ>& x, int occ[QQ], const float drain_q[QQ],
                                          const Step<MM, QQ>& d, float lq, float dt,
                                          float t_new, const PointConsts& c, const Params& P) {
  const bool stall_on = P.flags & kStallOn;
  const int nq = c.nq;
  // 1. arrivals; 2. drain; 3. Little integral and vacations
  const float mu_dt = P.mu * dt;
  const float drain_by = dt + kWakeEps;
  float offered = 0.f, dropped = 0.f, served = 0.f, b_old = 0.f, b_new_sum = 0.f, adm_sum = 0.f;
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    if (q > 0 && q >= nq) continue;
    const bool drain_now = occ[q] && drain_q[q] <= drain_by;
    const float mu_a = lq * dt;
    const float zq = drain_now ? 0.0f : d.z[q];
    const float raw = x.res[q] + mu_a + sqrtf(mu_a) * zq;
    const float a = fmaxf(raw, 0.0f);
    x.res[q] = fminf(raw, 0.0f);
    const float room = fmaxf(P.cap - x.back[q], 0.0f) + (occ[q] ? mu_dt : 0.0f);
    const float adm = fminf(a, room);
    const float serve = occ[q] ? fminf(x.back[q] + adm, mu_dt) : 0.0f;
    const float b_new = fminf(fmaxf(x.back[q] + adm - serve, 0.0f), P.cap);
    offered = q ? offered + a : a;
    dropped = q ? dropped + (a - adm) : a - adm;
    adm_sum = q ? adm_sum + adm : adm;
    served = q ? served + serve : serve;
    b_old = q ? b_old + x.back[q] : x.back[q];
    b_new_sum = q ? b_new_sum + b_new : b_new;
    if (!occ[q]) x.vac[q] = x.vac[q] + dt;
    x.back[q] = b_new;
  }
  const float lat_area = 0.5f * (b_old + b_new_sum) * dt;

  // 4. the stall process at the boundary
  if (stall_on && x.next_stall <= t_new) {
    x.stall_end = fmaxf(x.stall_end, x.next_stall + d.len);
    x.next_stall = x.next_stall + d.gap;
  }

  // 5. wakes at the boundary; an open stall window defers them
  const bool defer = stall_on && t_new < x.stall_end;
  bool woken[MM];
  int n_wake = 0;
#pragma unroll
  for (int i = 0; i < MM; ++i) {
    const bool sleeping = x.att[i] == -1;
    if (sleeping) x.sleep[i] = x.sleep[i] - dt;
    woken[i] = sleeping && x.sleep[i] <= kWakeEps;
    if (woken[i] && defer) {
      woken[i] = false;
      x.sleep[i] = (x.stall_end - t_new) + d.jit[i];
    }
    n_wake += woken[i];
  }

  // 6. queues drained out release their thread (fresh T_S sleep)
  int tsa = 0;
  bool q_done[QQ];
#pragma unroll
  for (int q = 0; q < QQ; ++q) q_done[q] = occ[q] && x.back[q] <= kRelease;
#pragma unroll
  for (int i = 0; i < MM; ++i) {
    bool done = false;
#pragma unroll
    for (int q = 0; q < QQ; ++q) done |= x.att[i] == q && q_done[q];
    if (done) {
      tsa += 1;
      x.sleep[i] = c.ts1 + d.over[i];
      x.att[i] = -1;
    }
  }
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    if (q_done[q]) occ[q] = 0;
  }

  // 7. claims, threads in index order: the longest free backlog >= 1 (ties
  // to the lowest index), else an empty win, else a busy try
  int busy = 0, cyc = 0;
  float vacs = 0.f, nvs = 0.f;
#pragma unroll
  for (int i = 0; i < MM; ++i) {
    if (QQ > 1 && !woken[i]) continue;
    int qi = -1, eqi = -1;
    float best = 0.f;
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      const bool free_q = woken[i] && q < nq && !occ[q];
      if (free_q && eqi < 0) eqi = q;
      if (free_q && x.back[q] >= 1.0f && (qi < 0 || x.back[q] > best)) {
        qi = q;
        best = x.back[q];
      }
    }
    const int cq = qi >= 0 ? qi : eqi;   // the queue whose vacation ends
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      if (q == cq) {
        vacs = vacs + x.vac[q];
        x.vac[q] = 0.0f;
      }
      if (q == qi) {
        nvs = nvs + x.back[q];
        occ[q] = 1;
      }
    }
    cyc += cq >= 0;
    tsa += qi < 0 && eqi >= 0;
    busy += woken[i] && cq < 0;
    if (qi >= 0) x.att[i] = qi;
    if (woken[i] && qi < 0) x.sleep[i] = x.sleep[i] + ((eqi >= 0 ? c.ts1 : c.tl1) + d.over[i]);
  }

  const float fwake = (float)n_wake, fbusy = (float)busy, ftsa = (float)tsa;
  const float awake = fwake * P.wake_cost + served * P.inv_mu;
  const float energy = P.active_power * awake + ftsa * c.e_arm_s + fbusy * c.e_arm_l;
  const float step[12] = {offered, dropped, served, fwake, fbusy, (float)cyc, awake, lat_area,
                          vacs,    nvs,     ftsa,   energy};
#pragma unroll
  for (int k = 0; k < 12; ++k) x.s[k] = x.s[k] + step[k];
  x.adm = adm_sum;
  x.btot = b_new_sum;
}

// this step's duplicates of a host (hedging on)
__device__ __forceinline__ float duplicates(float adm, float btot, float hedge_d,
                                            float hedge_den, const Params& P) {
  const float xg = (btot * P.inv_mu - hedge_d) / hedge_den;
  return adm * (1.0f / (1.0f + expf(-xg)));
}

template <int MM, int QQ>
__device__ __forceinline__ void occupancy(const Host<MM, QQ>& x, int occ[QQ]) {
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    occ[q] = 0;
#pragma unroll
    for (int i = 0; i < MM; ++i) occ[q] |= x.att[i] == q;
  }
}

__device__ __forceinline__ PointConsts point_consts(const Inputs& in, int pt, const Params& P) {
  PointConsts c;
  c.t_s = in.t_s[pt];
  c.lam = in.lam[pt];
  const float t_l = in.t_l[pt];
  c.ts1 = c.t_s * P.slope1;
  c.tl1 = t_l * P.slope1;
  c.e_arm_s = arm_cost(c.t_s, P);
  c.e_arm_l = arm_cost(t_l, P);
  c.m = in.m[pt];
  c.nq = in.nq[pt];
  c.q_recip = 1.0f / (float)c.nq;
  return c;
}

// The point's step-level values every thread of the block keeps alike: the
// remaining time, the schedule's segment, the refresh lattice, the counts.
struct Clock {
  float rem, next_edge, scale, next_ref, n_steps, forced;
  int seg;
};

__device__ __forceinline__ void clock_init(Clock& k, const float* edges, const float* scales,
                                           const Params& P) {
  k.rem = P.duration;
  k.seg = 0;
  k.scale = 1.0f;
  k.next_edge = INFINITY;
  if (P.n_seg > 0) {
    k.scale = scales[0];
    if (P.n_seg > 1) k.next_edge = edges[1];
  }
  k.next_ref = 0.0f;
  k.n_steps = k.forced = 0.0f;
}

// the schedule's segment at now (the pointer only moves forward); returns
// the distance to the segment's end
__device__ __forceinline__ float clock_segment(Clock& k, float now, const float* edges,
                                               const float* scales, const Params& P) {
  if (P.n_seg == 0) return INFINITY;
  while (k.next_edge <= now) {
    ++k.seg;
    k.scale = scales[k.seg];
    k.next_edge = k.seg + 1 < P.n_seg ? edges[k.seg + 1] : INFINITY;
  }
  return k.next_edge - now;
}

// the jump from the point's two minima: dt, and whether it was forced
__device__ __forceinline__ float clock_jump(Clock& k, int t, float wd, float fs, float seg_dt,
                                            float ref_dt, const Params& P, bool& forced) {
  const float dt_b = fminf(fminf(wd, fs), fminf(fminf(seg_dt, ref_dt), k.rem));
  // the floor never steps past a wake or a drain-out; the tail's pace takes
  // the remaining time evenly over the steps left
  float floor_eff = fminf(fmaxf(wd, kWakeEps), P.floor);
  const float steps_left = P.steps_f - (float)t;
  if (steps_left <= P.tail_steps) floor_eff = fmaxf(floor_eff, k.rem / steps_left);
  const float dt = fminf(fmaxf(dt_b, floor_eff), k.rem);
  forced = dt > fmaxf(dt_b, P.floor) + kWakeEps;
  return dt;
}

__device__ __forceinline__ void write_point(const Clock& k, int pt, const Params& P,
                                            float* __restrict__ ends) {
  ends[pt] = k.n_steps;
  ends[P.n_points + pt] = k.forced;
  ends[2 * P.n_points + pt] = P.duration - k.rem;
}

// ---- the two routes' host reductions -----------------------------------------

// The ring route's: W = 2^LW lanes in one block (reduce<W>).
template <int LW>
struct BlockRoute {
  static constexpr int kLanes = 1 << LW;
  static constexpr bool kTwoPass = kLanes <= 32;   // the hedge tree's two passes (note 3)
  int threads;
  RedShared& sh;
  int buf;
  __device__ int row_stride() const { return kLanes; }
  template <class T>
  __device__ T over(T a) { return reduce<kLanes>(a, threads, sh, buf); }
};

// The cluster route's: W = 256 lanes over the cluster's blocks, K hosts a
// lane (cluster_reduce); the ring's rows are the block's 32 K lanes.
template <int KK>
struct ClusterRoute {
  static constexpr int kLanes = kMaxLanes;
  static constexpr bool kTwoPass = false;
  static constexpr int K = KK;
  ClusterShared& cs;
  int xc;
  __device__ int row_stride() const { return 32 * K; }
  template <class T>
  __device__ T over(T a) { return cluster_reduce(a, K, cs, xc); }
};

// ---- the producers ------------------------------------------------------------

// Producer lane `ptid` of `npt`: every state-free value of the stage's (step,
// lane) items ptid, ptid + npt, ... (item = step * lanes + lane), until the
// consumers stop (`stop`: the step they stopped at, INT_MAX while they run).
// On the ring route a lane is a host, in rows of W; on the cluster route (CL)
// the block's 32 K lanes, lane 32 k + i holding host 32 rank + i + 256 k (a
// host past H skipped).
template <int MM, int QQ, bool CL>
__device__ __forceinline__ void produce(int ptid, int npt, int pt, int rank, const Inputs& in,
                                        float* ring, uint32_t full, uint32_t empty,
                                        const volatile int* stop, const Params& P) {
  using L = Layout<MM, QQ>;
  const int W = CL ? 32 * P.hosts_per_lane : P.lanes, H = P.n_hosts;
  const int lanes = CL ? W : H;
  const int nf = L::fields(P.flags);
  const int stage_floats = L::stage_floats(W, P.flags);
  const bool stall_on = P.flags & kStallOn;
  const int m = in.m[pt];
  const uint32_t lo = (uint32_t)in.seed_lo[pt], hi = (uint32_t)in.seed_hi[pt];
  const int n_stages = (P.n_run + kStageSteps - 1) / kStageSteps;
  for (int g = 0; g < n_stages; ++g) {
    const int s = g % kStages;
    mbar_wait(empty + 8 * s, ((g / kStages) & 1) ^ 1);
    if (g * kStageSteps >= *stop) return;    // the consumers stopped before this stage
    float* tab = ring + (size_t)s * stage_floats;
    const int n = min(kStageSteps, P.n_run - g * kStageSteps);
    for (int it = ptid; it < n * lanes; it += npt) {
      const int k = it / lanes, j = it - k * lanes;
      const int h = CL ? 32 * rank + (j & 31) + 256 * (j >> 5) : j;
      if (CL && h >= H) continue;
      Step<MM, QQ> x;
      draw_step<MM, QQ>(x, g * kStageSteps + k, m, lo + (uint32_t)h, hi, P);
      float* row = tab + k * nf * W + j;
#pragma unroll
      for (int q = 0; q < QQ; ++q) row[(L::kZ + q) * W] = x.z[q];
#pragma unroll
      for (int i = 0; i < MM; ++i) row[(L::kOver + i) * W] = x.over[i];
      if (stall_on) {
        row[L::kLen * W] = x.len;
        row[L::kGap * W] = x.gap;
#pragma unroll
        for (int i = 0; i < MM; ++i) row[(L::kJit + i) * W] = x.jit[i];
      }
    }
    mbar_arrive(full + 8 * s);
  }
}

template <int MM, int QQ>
__device__ __forceinline__ void load_step(Step<MM, QQ>& x, const float* row, int W,
                                          bool stall_on) {
  using L = Layout<MM, QQ>;
#pragma unroll
  for (int q = 0; q < QQ; ++q) x.z[q] = row[(L::kZ + q) * W];
#pragma unroll
  for (int i = 0; i < MM; ++i) x.over[i] = row[(L::kOver + i) * W];
  if (stall_on) {
    x.len = row[L::kLen * W];
    x.gap = row[L::kGap * W];
#pragma unroll
    for (int i = 0; i < MM; ++i) x.jit[i] = row[(L::kJit + i) * W];
  }
}

// ---- the consumers (host lanes) ---------------------------------------------

// A consumer thread runs host h, whose step values sit at lane `row` of the
// ring's rows (route.row_stride() lanes); `first` marks the copy that writes
// the outputs (on the ring route below 32 lanes every host runs in 32 / W
// lanes of the warp, alike bit for bit).  A host past H holds the
// reductions' identities and writes nothing: the jumps, on the producers'
// values, with the route's host reductions.
template <int MM, int QQ, class R>
__device__ __forceinline__ void consume(R& route, int h, int row, bool first, int pt,
                                        const Inputs& in, const float* ring, uint32_t full,
                                        uint32_t empty, volatile int* stop, const Params& P,
                                        float* __restrict__ stats, float* __restrict__ ends) {
  using L = Layout<MM, QQ>;
  const int W = route.row_stride();
  const int H = P.n_hosts;
  const bool live = h < H;
  const int nf = L::fields(P.flags);
  const int stage_floats = L::stage_floats(W, P.flags);
  const bool stall_on = P.flags & kStallOn;
  const bool topo = P.flags & kTopo, link = P.flags & kLink;
  const bool balanced = P.lb == 2;
  const PointConsts c = point_consts(in, pt, P);
  const float hedge_d = in.hedge_d[pt];
  const bool hedged = hedge_d > 0.0f;
  const float hedge_den = 0.25f * hedge_d + P.hedge_eps;
  const bool far = h < P.far_count;
  const float* edges = in.sched_edges + (size_t)pt * P.n_seg;
  const float* scales = in.sched_scales + (size_t)pt * P.n_seg;

  Host<MM, QQ> x;
  host_init(x, c, (uint32_t)in.seed_lo[pt] + (uint32_t)h, (uint32_t)in.seed_hi[pt],
            balanced || !live ? 0.0f : in.shares[h], P);
  int occ[QQ];
#pragma unroll
  for (int q = 0; q < QQ; ++q) occ[q] = 0;
  Clock k;
  clock_init(k, edges, scales, P);

  const int n_stages = (P.n_run + kStageSteps - 1) / kStageSteps;
  bool stopped = false;
  for (int g = 0; g < n_stages && !stopped; ++g) {
    const int s = g % kStages;
    mbar_wait(full + 8 * s, (g / kStages) & 1);
    const float* tab = ring + (size_t)s * stage_floats;
    const int n = min(kStageSteps, P.n_run - g * kStageSteps);
    for (int j = 0; j < n; ++j) {
      const int t = g * kStageSteps + j;
      if (!(k.rem > 0.0f)) {   // alike in every lane: the block stops as one
        if (threadIdx.x == 0) {
          *stop = t;
          __threadfence_block();
        }
        stopped = true;
        break;
      }
      const float now = P.duration - k.rem;
      const float seg_dt = clock_segment(k, now, edges, scales, P);

      // the balancer: least-loaded refreshes its snapshot and shares
      float ref_dt = INFINITY;
      if (balanced) {
        if (now + kWakeEps >= k.next_ref) {
          float b = 0.f;
#pragma unroll
          for (int q = 0; q < QQ; ++q) b = q ? b + x.back[q] : x.back[q];
          k.next_ref = (floorf(now * P.inv_stale + kWakeEps) + 1.0f) * P.stale;
          const float xs = live ? -b * P.inv_soft : -INFINITY;
          const float mx = route.over(MaxOf{xs}).v;
          const float e = live ? expf(xs - mx) : 0.0f;
          const float den = route.over(SumOf{e}).v;
          x.share = e / den;
        }
        ref_dt = k.next_ref - now;
      }
      const float lq = live ? queue_rate(c.lam, x.share, k.scale, c.q_recip, P) : 0.0f;

      // the jump: the point's nearest boundary
      float drain_q[QQ];
      float wd = INFINITY, fs = INFINITY;
      if (live) host_bounds(x, occ, lq, c.nq, now, P, wd, fs, drain_q);
      const MinOf2 mins = route.over(MinOf2{wd, fs});
      bool forced;
      const float dt = clock_jump(k, t, mins.a, mins.b, seg_dt, ref_dt, P, forced);
      const float t_new = now + dt;

      // every host's macro-slot at dt
      if (live) {
        Step<MM, QQ> d;
        load_step(d, tab + j * nf * W + row, W, stall_on);
        host_step(x, occ, drain_q, d, lq, dt, t_new, c, P);
      }

      // the cross-host stages: the far rack's admissions (link on), and with
      // hedging one tree for b1 and b2, the duplicates that land on b1
      // (every host's but b1's) and b1's own (to b2)
      const float far_adm = live && far ? x.adm : 0.0f;
      float far_sum = 0.0f, to_b1 = 0.0f, to_b2 = 0.0f;
      int b1 = -1, b2 = -1;
      if (hedged) {
        Hedge r;
        if constexpr (R::kTwoPass) {
          // the first pass's rounds (offsets W / 2, ..., 1) with the gate's
          // three parts between them, then the second pass
          Top2 a = Top2::leaf(live, h, x.btot, far_adm);
          unsigned firsts = 0;
          float xg = 0.0f, den = 0.0f, gate = 0.0f;
#pragma unroll
          for (int k = 0; k < 5; ++k) {
            const int off = R::kLanes >> (k + 1);
            Top2 o;
            if (off) o = a.shfl(off);
            if (k == 0) xg = (x.btot * P.inv_mu - hedge_d) / hedge_den;
            if (k == 1) den = 1.0f + expf(-xg);
            if (k == 2) gate = 1.0f / den;
            if (off && a.merge(o)) firsts |= 1u << k;
          }
          x.dup = live ? x.adm * gate : 0.0f;   // duplicates(), in its three parts
          if (live) x.s[13] = x.s[13] + x.dup;
          const float dup_q = x.dup * c.q_recip;
          DupSums d = {dup_q, 0.0f, dup_q};
#pragma unroll
          for (int k = 0; k < 5; ++k) {
            const int off = R::kLanes >> (k + 1);
            if (off) d.merge(d.shfl(off), (firsts >> k) & 1u);
          }
          r = {d.full, d.excl, a.v1, a.v2, d.d1, a.far, a.i1, a.i2};
        } else {
          x.dup = live ? duplicates(x.adm, x.btot, hedge_d, hedge_den, P) : 0.0f;
          if (live) x.s[13] = x.s[13] + x.dup;
          const Hedge leaf = Hedge::leaf(live, h, x.btot, x.dup * c.q_recip, far_adm);
          r = link ? static_cast<Hedge>(route.over(HedgeTree<true>{leaf}))
                   : static_cast<Hedge>(route.over(HedgeTree<false>{leaf}));
        }
        far_sum = r.far;
        to_b1 = r.excl;
        to_b2 = r.d1;
        b1 = r.i1;
        b2 = r.i2;
        if (H == 1) {   // a lone host's duplicates come back to it
          to_b1 = to_b2;
          b2 = b1;
        }
      } else if (link) {
        far_sum = route.over(SumOf{far_adm}).v;
      }
      if (live && topo) {
        float delay = far ? P.far_cost : P.near_cost;
        if (link && far) delay = delay + 1.0f / fmaxf(P.link_rate - far_sum / dt, P.link_floor);
        x.s[12] = x.s[12] + x.adm * delay;
      }
      if (h == b1 || h == b2) {
        const float tot = h == b1 ? to_b1 : to_b2;
#pragma unroll
        for (int q = 0; q < QQ; ++q) {
          if (q < c.nq) x.back[q] = x.back[q] + fminf(tot, fmaxf(P.cap - x.back[q], 0.0f));
        }
      }
      k.rem = k.rem - dt;
      k.n_steps = k.n_steps + 1.0f;
      if (forced) k.forced = k.forced + 1.0f;
    }
    // the stage is released after its last step, and after the store of
    // `stop` where the block stopped inside it
    mbar_arrive(empty + 8 * s);
  }
  if (!live || !first) return;
#pragma unroll
  for (int j = 0; j < kNumStats; ++j) stats[((size_t)j * P.n_points + pt) * H + h] = x.s[j];
  if (h == 0) write_point(k, pt, P, ends);
}

// One instantiation for each (M_MAX, Q_MAX) and each lane count W = 2^LW of
// the ring route (the design note, 3).
template <int MM, int QQ, int LW>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fleet_adaptive_kernel(const Inputs in, float* __restrict__ stats, float* __restrict__ ends,
                          const Params P) {
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  __shared__ RedShared sh;
  __shared__ int stop;
  const int pt = blockIdx.x;
  const int consumers = P.consumers, producer_lanes = 32 * producers(P.lanes);
  // full[s] at full + 8 s, empty[s] at empty + 8 s
  const uint32_t full = smem_u32(bars), empty = smem_u32(bars + kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, producer_lanes);
      mbar_init(empty + 8 * s, consumers);
    }
    stop = INT_MAX;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int rank = producer_rank(threadIdx.x / 32, P.lanes);
  if ((int)threadIdx.x < consumers) {
    BlockRoute<LW> route{consumers, sh, 0};
    const int h = threadIdx.x & (BlockRoute<LW>::kLanes - 1);
    consume<MM, QQ>(route, h, h, (int)threadIdx.x < BlockRoute<LW>::kLanes, pt, in, ring, full,
                    empty, &stop, P, stats, ends);
  } else if (rank >= 0) {
    produce<MM, QQ, false>(32 * rank + threadIdx.x % 32, producer_lanes, pt, 0, in, ring, full,
                           empty, &stop, P);
  }
}

// The cluster route (257 to 256 kMaxHostsPerLane hosts): a point is a
// cluster of kClusterBlocks blocks; block g's consumer warps 0 .. K - 1 run
// hosts 32 g + i + 256 k (warp k, lane i), its kClusterProducers producer
// warps after them fill its ring with those hosts' values.  K is a template
// parameter (one build per K, as W is on the ring route: 8% less a step at
// 1000 hosts than with K read at run time, PERF.md §6).
template <int MM, int QQ, int KK>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fleet_adaptive_cluster_kernel(const Inputs in, float* __restrict__ stats,
                                  float* __restrict__ ends, const Params P) {
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  __shared__ ClusterShared cs;
  __shared__ int stop;
  const int pt = blockIdx.x / kClusterBlocks;
  const int g = (int)cluster_rank();
  constexpr int K = KK;
  const int consumers = 32 * K;
  const int producer_lanes = 32 * kClusterProducers;
  const uint32_t full = smem_u32(bars), empty = smem_u32(bars + kStages);
  cluster_init(cs);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, producer_lanes);
      mbar_init(empty + 8 * s, consumers);
    }
    stop = INT_MAX;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();
  const int t = threadIdx.x;
  if (t < consumers) {
    ClusterRoute<K> route{cs, 0};
    consume<MM, QQ>(route, 32 * g + (t & 31) + 256 * (t >> 5), t, true, pt, in, ring, full,
                    empty, &stop, P, stats, ends);
  } else {
    produce<MM, QQ, true>(t - consumers, producer_lanes, pt, g, in, ring, full, empty, &stop, P);
  }
  cluster_sync();
}

// ---- the scratch route (more than 256 kMaxHostsPerLane hosts) ---------------

template <int MM, int QQ>
__host__ __device__ constexpr int host_words() {
  return 2 * MM + 3 * QQ + 3 + kNumStats + 3;
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
  x.next_stall = base[(w++) * H];
  x.share = base[(w++) * H];
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
  base[(w++) * H] = x.next_stall;
  base[(w++) * H] = x.share;
#pragma unroll
  for (int k = 0; k < kNumStats; ++k) base[(w++) * H] = x.s[k];
  base[(w++) * H] = x.adm;
  base[(w++) * H] = x.btot;
  base[(w++) * H] = x.dup;
}

// Every thread a lane of W = 256; a lane holds hosts lane, lane + W, ...
template <int MM, int QQ>
__global__ void __launch_bounds__(kMaxLanes, 1)
    fleet_adaptive_scratch_kernel(const Inputs in, float* __restrict__ stats,
                                  float* __restrict__ ends, float* __restrict__ scratch,
                                  const Params P) {
  __shared__ RedShared sh;
  const int pt = blockIdx.x;
  const int lane = threadIdx.x;
  const int W = P.lanes, H = P.n_hosts, K = P.hosts_per_lane;
  const PointConsts c = point_consts(in, pt, P);
  const uint32_t lo = (uint32_t)in.seed_lo[pt], hi = (uint32_t)in.seed_hi[pt];
  const float hedge_d = in.hedge_d[pt];
  const bool hedged = hedge_d > 0.0f;
  const float hedge_den = 0.25f * hedge_d + P.hedge_eps;
  const bool topo = P.flags & kTopo, link = P.flags & kLink;
  const bool balanced = P.lb == 2;
  const float* edges = in.sched_edges + (size_t)pt * P.n_seg;
  const float* scales = in.sched_scales + (size_t)pt * P.n_seg;
  float* my = scratch + (size_t)pt * host_words<MM, QQ>() * H;
  int buf = 0;

  Host<MM, QQ> x;
  int occ[QQ];
  float drain_q[QQ];
  for (int j = 0; j < K; ++j) {
    const int h = lane + j * W;
    if (h >= H) break;
    host_init(x, c, lo + (uint32_t)h, hi, balanced ? 0.0f : in.shares[h], P);
    store(x, my + h, H);
  }
  Clock k;
  clock_init(k, edges, scales, P);

  for (int t = 0; t < P.n_run; ++t) {
    if (!(k.rem > 0.0f)) break;   // alike in every thread
    const float now = P.duration - k.rem;
    const float seg_dt = clock_segment(k, now, edges, scales, P);

    // 0. least-loaded, on refresh steps: the snapshot, the softmax's max and
    // sum, and each host's share
    float ref_dt = INFINITY;
    if (balanced) {
      if (now + kWakeEps >= k.next_ref) {
        k.next_ref = (floorf(now * P.inv_stale + kWakeEps) + 1.0f) * P.stale;
        MaxOf a{-INFINITY};
        for (int j = 0; j < K; ++j) {
          const int h = lane + j * W;
          if (h >= H) break;
          load(x, my + h, H);
          float b = 0.f;
#pragma unroll
          for (int q = 0; q < QQ; ++q) b = q ? b + x.back[q] : x.back[q];
          x.share = -b * P.inv_soft;   // the snapshot's exponent, until the share
          store(x, my + h, H);
          a.v = fmaxf(a.v, x.share);
        }
        const float mx = reduce(a, W, W, sh, buf).v;
        SumOf e_sum{0.0f};
        for (int j = 0; j < K; ++j) {
          const int h = lane + j * W;
          if (h >= H) break;
          load(x, my + h, H);
          x.share = expf(x.share - mx);
          e_sum.v = j ? e_sum.v + x.share : x.share;
          store(x, my + h, H);
        }
        const float den = reduce(e_sum, W, W, sh, buf).v;
        for (int j = 0; j < K; ++j) {
          const int h = lane + j * W;
          if (h >= H) break;
          load(x, my + h, H);
          x.share = x.share / den;
          store(x, my + h, H);
        }
      }
      ref_dt = k.next_ref - now;
    }

    // 1. the jump: every host's bounds, the point's minima
    MinOf2 mins{INFINITY, INFINITY};
    for (int j = 0; j < K; ++j) {
      const int h = lane + j * W;
      if (h >= H) break;
      load(x, my + h, H);
      occupancy(x, occ);
      float wd, fs;
      host_bounds(x, occ, queue_rate(c.lam, x.share, k.scale, c.q_recip, P), c.nq, now, P, wd,
                  fs, drain_q);
      mins.a = fminf(mins.a, wd);
      mins.b = fminf(mins.b, fs);
    }
    mins = reduce(mins, W, W, sh, buf);
    bool forced;
    const float dt = clock_jump(k, t, mins.a, mins.b, seg_dt, ref_dt, P, forced);
    const float t_new = now + dt;

    // 2. every host's macro-slot, its duplicates (hedging on), and each
    // lane's part of the far rack's admissions and of b1
    Red<true, true, false> a = Red<true, true, false>::identity();
    for (int j = 0; j < K; ++j) {
      const int h = lane + j * W;
      if (h >= H) break;
      load(x, my + h, H);
      occupancy(x, occ);
      const float lq = queue_rate(c.lam, x.share, k.scale, c.q_recip, P);
      float wd, fs;
      host_bounds(x, occ, lq, c.nq, now, P, wd, fs, drain_q);
      Step<MM, QQ> d;
      draw_step<MM, QQ>(d, t, c.m, lo + (uint32_t)h, hi, P);
      host_step(x, occ, drain_q, d, lq, dt, t_new, c, P);
      if (hedged) {
        x.dup = duplicates(x.adm, x.btot, hedge_d, hedge_den, P);
        x.s[13] = x.s[13] + x.dup;
      }
      const float far_adm = h < P.far_count ? x.adm : 0.0f;
      a.sum = j ? a.sum + far_adm : far_adm;
      if (x.btot < a.v) {
        a.v = x.btot;
        a.i = h;
      }
      store(x, my + h, H);
    }
    if (topo || hedged) {
      const Red<true, true, false> r1 = reduce(a, W, W, sh, buf);
      const int b1 = r1.i;
      float gap = 1.0f;
      if (link) gap = fmaxf(P.link_rate - r1.sum / dt, P.link_floor);

      // 3. hedging: the duplicates, split over the sender's queues, that land
      // on b1 (every host's but b1's) and b2, the first least-loaded host
      // other than b1
      float to_b1 = 0.0f, to_b2 = 0.0f;
      int b2 = b1;
      if (hedged) {
        Red<true, true, true> e = Red<true, true, true>::identity();
        for (int j = 0; j < K; ++j) {
          const int h = lane + j * W;
          if (h >= H) break;
          load(x, my + h, H);
          const float dup = x.dup * c.q_recip;
          const float give = h == b1 ? 0.0f : dup;
          e.sum = j ? e.sum + give : give;
          if (h == b1) {
            e.mx = dup;   // the lone non-negative value: b1's own duplicates
          } else if (x.btot < e.v) {
            e.v = x.btot;
            e.i = h;
          }
        }
        const Red<true, true, true> r2 = reduce(e, W, W, sh, buf);
        to_b1 = r2.sum;
        to_b2 = r2.mx;
        b2 = r2.i;
      }

      // 4. each host's network delay and injection
      for (int j = 0; j < K; ++j) {
        const int h = lane + j * W;
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
            if (q < c.nq) x.back[q] = x.back[q] + fminf(tot, fmaxf(P.cap - x.back[q], 0.0f));
          }
        }
        store(x, my + h, H);
      }
    }
    k.rem = k.rem - dt;
    k.n_steps = k.n_steps + 1.0f;
    if (forced) k.forced = k.forced + 1.0f;
  }

  for (int j = 0; j < K; ++j) {
    const int h = lane + j * W;
    if (h >= H) break;
    load(x, my + h, H);
#pragma unroll
    for (int s = 0; s < kNumStats; ++s) stats[((size_t)s * P.n_points + pt) * H + h] = x.s[s];
  }
  if (lane == 0) write_point(k, pt, P, ends);
}

template <int MM, int QQ, int LW>
cudaError_t launch_ring(const Inputs& in, void* stats, void* ends, const Params& P,
                        cudaStream_t st) {
  const size_t smem = Layout<MM, QQ>::smem_bytes(P.lanes, P.flags);
  cudaError_t err = cudaFuncSetAttribute(fleet_adaptive_kernel<MM, QQ, LW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = 32 * block_warps(P.lanes);
  fleet_adaptive_kernel<MM, QQ, LW><<<P.n_points, threads, smem, st>>>(
      in, static_cast<float*>(stats), static_cast<float*>(ends), P);
  return cudaGetLastError();
}

// A point a cluster of kClusterBlocks blocks.  A launch the card cannot
// place (no cluster of this shared memory and these threads fits) returns an
// error: nothing falls back to another route.
template <int MM, int QQ, int KK>
cudaError_t launch_cluster(const Inputs& in, void* stats, void* ends, const Params& P,
                           cudaStream_t st) {
  const size_t smem = Layout<MM, QQ>::smem_bytes(32 * P.hosts_per_lane, P.flags);
  auto kernel = fleet_adaptive_cluster_kernel<MM, QQ, KK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.n_points * kClusterBlocks);
  cfg.blockDim = dim3(32 * (P.hosts_per_lane + kClusterProducers));
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
  err = cudaLaunchKernelEx(&cfg, kernel, in, static_cast<float*>(stats),
                           static_cast<float*>(ends), P);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MM, int QQ>
cudaError_t launch(const Inputs& in, void* stats, void* ends, void* scratch, Params P,
                   cudaStream_t st) {
  if (P.hosts_per_lane > 1 && P.hosts_per_lane <= kMaxHostsPerLane)
    switch (P.hosts_per_lane) {
      case 2: return launch_cluster<MM, QQ, 2>(in, stats, ends, P, st);
      case 3: return launch_cluster<MM, QQ, 3>(in, stats, ends, P, st);
      case 4: return launch_cluster<MM, QQ, 4>(in, stats, ends, P, st);
      case 5: return launch_cluster<MM, QQ, 5>(in, stats, ends, P, st);
      case 6: return launch_cluster<MM, QQ, 6>(in, stats, ends, P, st);
      case 7: return launch_cluster<MM, QQ, 7>(in, stats, ends, P, st);
      default: return cudaErrorInvalidValue;
    }
  if (P.hosts_per_lane > 1) {
    fleet_adaptive_scratch_kernel<MM, QQ><<<P.n_points, kMaxLanes, 0, st>>>(
        in, static_cast<float*>(stats), static_cast<float*>(ends), static_cast<float*>(scratch),
        P);
    return cudaGetLastError();
  }
  P.consumers = 32 * consumer_warps(P.lanes);
  int lw = 0;
  while ((1 << lw) < P.lanes) ++lw;
  switch (lw) {
    case 0: return launch_ring<MM, QQ, 0>(in, stats, ends, P, st);
    case 1: return launch_ring<MM, QQ, 1>(in, stats, ends, P, st);
    case 2: return launch_ring<MM, QQ, 2>(in, stats, ends, P, st);
    case 3: return launch_ring<MM, QQ, 3>(in, stats, ends, P, st);
    case 4: return launch_ring<MM, QQ, 4>(in, stats, ends, P, st);
    case 5: return launch_ring<MM, QQ, 5>(in, stats, ends, P, st);
    case 6: return launch_ring<MM, QQ, 6>(in, stats, ends, P, st);
    case 7: return launch_ring<MM, QQ, 7>(in, stats, ends, P, st);
    default: return launch_ring<MM, QQ, 8>(in, stats, ends, P, st);
  }
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
// producer warps a block, out[5] stages of the ring, out[6] steps a stage,
// out[7] bytes of a block's ring (dynamic shared memory; 32 K lanes on the
// cluster route), out[8] blocks a point, out[9] the route (0 ring, up to 256
// hosts; 2 cluster, up to 256 kMaxHostsPerLane; 1 scratch, beyond: no ring).
void fleet_adaptive_sweep_layout(int n_hosts, int q_max, int flags, int* out) {
  const int w = lanes_for(n_hosts);
  const int k = (n_hosts + w - 1) / w;
  const int route = route_for(k);
  const int rows = route == kCluster ? 32 * k : w;   // a ring row's host lanes
  out[0] = route == kRing ? 32 * block_warps(w)
           : route == kCluster ? 32 * (k + kClusterProducers) : kMaxLanes;
  out[1] = w;
  out[2] = k;
  out[3] = route != kScratch ? 0 : (q_max == 1 ? host_words<4, 1>() : host_words<4, 4>());
  out[4] = route == kRing ? producers(w) : route == kCluster ? kClusterProducers : 0;
  out[5] = route == kScratch ? 0 : kStages;
  out[6] = route == kScratch ? 0 : kStageSteps;
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
// energy_uj, topo_area, hedge_dup; ends f32 (3, n_points): live steps,
// forced steps, the simulated time; scratch f32 (n_points, words, n_hosts)
// with words from fleet_adaptive_sweep_layout (unused when it gives 0).
// n_run: the steps to run (the budget, or a prefix).  m_max, q_max <= 4; lb 0
// uniform, 1 weighted, 2 least-loaded.  flags: 1 sigma, 2 tail, 4
// interference, 8 stalls, 16 topology, 32 the bottleneck link.  fparams
// (host, 27): slot_us, duration_us, mu, 1/mu, capacity, capacity - 1,
// wake_cost_us, base_us, sigma_us, 1 + slope, tail_prob, tail_mean_us,
// interference_prob, interference_mean_us, 1/stall_rate, stall_mean_us,
// active_power_w, the budget, the tail's steps, 1/softness, near_cost_us,
// far_cost_us, link_rate_mpps, (1 - 0.98) link_rate_mpps, 1e-6, the refresh
// lattice's period stale_us and 1/stale_us (each reciprocal float32(1) /
// float32(x)).  states (host, 3 n_states): (power_w, transition_uj,
// min_residency_us), shallow to deep.  build (host, 3 ints out): the (M_MAX,
// Q_MAX) instantiation launched and its route (0 ring, 1 scratch, 2
// cluster).  Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream`.
int fleet_adaptive_sweep_fwd(const void* t_s, const void* t_l, const void* m, const void* nq,
                             const void* lam, const void* seed_lo, const void* seed_hi,
                             const void* hedge_d, const void* sched_edges,
                             const void* sched_scales, const void* shares, void* stats,
                             void* ends, void* scratch, int n_points, int n_hosts, int n_run,
                             int m_max, int q_max, int n_seg, int lb, int far_count, int flags,
                             const float* fparams, int n_fparams, const float* states,
                             int n_states, int device, int* build, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_points <= 0 || n_hosts <= 0 || n_run < 0 || m_max < 1 || m_max > 4 || q_max < 1 ||
      q_max > 4 || n_fparams != kNumFParams || n_states < 1 || n_states > kMaxStates ||
      n_seg < 0 || (n_seg > 0 && (sched_edges == nullptr || sched_scales == nullptr)) || lb < 0 ||
      lb > 2 || far_count < 0 || far_count > n_hosts || scratch == nullptr || shares == nullptr)
    return (int)cudaErrorInvalidValue;
  Params P;
  float* dst[kNumFParams] = {
      &P.floor,     &P.duration,  &P.mu,         &P.inv_mu,    &P.cap,        &P.cap_fill,
      &P.wake_cost, &P.base,      &P.sigma,      &P.slope1,    &P.tail_prob,  &P.tail_mean,
      &P.intf_prob, &P.intf_mean, &P.inv_stall,  &P.stall_mean, &P.active_power, &P.steps_f,
      &P.tail_steps, &P.inv_soft, &P.near_cost,  &P.far_cost,  &P.link_rate,  &P.link_floor,
      &P.hedge_eps, &P.stale,     &P.inv_stale};
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
  P.n_run = n_run;
  P.n_seg = n_seg;
  P.lb = lb;
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
  return (int)(q_max == 1 ? launch<4, 1>(in, stats, ends, scratch, P, st)
                          : launch<4, 4>(in, stats, ends, scratch, P, st));
}

const char* fleet_adaptive_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
