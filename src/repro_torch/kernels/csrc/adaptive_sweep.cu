// Event-jump Metronome sweep (S2) for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the body of the reference's adaptive batched engine,
// src/repro/runtime/batched_adaptive.py, _build_adaptive_sweep.one_point
// (:197): a lax.scan over a step budget (:496) under jax.jit(jax.vmap(...))
// (:503), one scan a grid point.  It is not a pallas_call, but it is the
// reference's accelerator hot path for calibration lattices.
//
// What one point computes, step by step, all in float32: each step advances
// dt, the distance to the nearest boundary (the earliest wake of a sleeping
// thread, the drain-out of an owned queue backlog / (mu - lam_q), the fill of
// a queue to capacity, the end of the load schedule's segment, the next
// window edge, the next stall start, the end of the run), floored at
// slot_us unless a wake or a drain-out comes first, and in the last eighth
// of the budget paced at remaining / steps_left, so that the run ends at
// its duration exactly.  Over dt: residual-carried Gaussian arrivals of
// variance lam_q dt (deterministic on a queue that drains out in the step),
// admission up to the room (which grows by mu dt on an owned queue), drain
// min(backlog + admitted, mu dt), the trapezoid latency area, vacations on
// free queues; then at the boundary: the stall start fires (the window
// extends, the next gap is drawn), expiring timers wake (deferred to an
// open window's end + U(0,1)), drained queues release their thread (fresh
// T_S sleep), and woken threads claim in index order as in the fixed-slot
// sweep (re-sleeps add onto the expired timer's residual).  Sums: the
// twelve of the fixed-slot sweep, live steps and forced steps (dt past the
// boundary by more than the wake epsilon), and the per-window five.
//
// The plain version, kernels/adaptive_sweep/ops.py:reference_adaptive_sweep,
// makes the same float32 operations in the same order, and this file is
// built with -fmad=false so that no product and sum fuse into one rounding:
// on the same draws the two agree bit for bit, up to the math library's
// log/sin/cos.  The reference's divisions by a compile-time constant (by
// window_us, stall_rate, mu) are products with the float32 reciprocal, as
// XLA compiles them; every other division is a division.
//
// Noise: the Philox contract of kernels/adaptive_sweep/philox.py, the
// fixed-slot sweep's generator with the counter (step, stream, lane block,
// 1).  Streams: 0 initial sleeps (block 0) and the first stall start
// (block 1, word 0); 1 normals (block 0 queues, block 1 threads); 2 tail
// (block 0 hit, block 1 length); 3 interference (same); 4 stalls (block 0:
// word 0 window length, word 1 gap; block 1 re-arm jitter).  The draws are
// keyed by the step and depend on no state, and the generator is
// counter-based: the kernel draws every family at every step, and the
// values a point uses are the contract's.
//
// What binds: a point's steps form one dependent chain, and a sweep has a
// few thousand points at most, so a few dozen warps carry the whole sweep,
// each alone on its SM, and a warp lasts as long as its longest point's
// chain (PERF.md §5: a kernel of one thread a point took ~2.8 us a step at
// sweep_frontier's grid).  The design takes the draws off that chain and
// keeps the rest of it short, as the fixed-slot sweep's (csrc/slot_sweep.cu):
//  1. Warp specialisation.  A block is 32 points: one consumer warp (lane =
//     point) runs the jumps, with the whole state (sleep timers, owners,
//     backlogs, vacation timers, residuals, stall window and next start,
//     the remaining time, the fourteen sums and the open window's five) in
//     registers.  Producer warps make what does not depend on the state, at
//     every step: the queues' normals, each thread's overshoot (base +
//     sigma |z| + tail and interference hits), and with stalls on the stall
//     window's length and gap and each thread's re-arm jitter: the plain
//     version's _step_inputs.  What depends on the jump's length (the
//     arrivals' variance, the schedule's segment, the window) stays on the
//     consumer, which forms ts1 + over and tl1 + over where a thread
//     re-arms, the plain version's single adds.  Six producers: warps 1-3
//     and 5-7, two on each scheduler the consumer does not use (warp 4, on
//     the consumer's scheduler, idles); six were faster than three at each
//     of the repo's sweeps (PERF.md §6).
//  2. A ring of kStages stages in shared memory, each kStageSteps steps x
//     the fields of 32 points (Layout), laid out [step][field][lane]: every
//     access is one conflict-free word a lane.  Hand-off by mbarriers:
//     full[s] (every producer lane arrives, the consumer waits) and empty[s]
//     (the consumer's 32 lanes arrive, the producers wait), with phase
//     parities.  Producer p fills steps p, p + kProducers, ... of each stage.
//     The consumer loads step k + 1's fields before it runs step k.
//  3. The run ends at a step no one knows in advance: a warp stops once its
//     last point reaches the duration, often far inside the budget (at
//     sweep_frontier's grid the longest point runs 23,293 of 102,782
//     steps).  Before each step the consumer votes; when no lane is left it
//     publishes the step in shared memory (`stop`) and releases the stage it
//     stopped in, as it releases every stage it has run.  A producer reads
//     `stop` after each wait on `empty` and leaves once the consumer has
//     stopped before the stage.  Every producer has filled the consumer's
//     last stage, so it is at most kStages stages past it; the waits of
//     those stages complete on releases already made, and that of the
//     stage kStages past it only on the last release, after the store.  So
//     no producer waits forever, and none runs out the budget.  (A further
//     arrival on another stage's `empty` would put that barrier two phases
//     past a producer yet to wait on it, and the parity wait would never
//     complete.)  Lanes past n_points draw nothing and write nothing; no
//     block barrier after the roles split.
//  4. The consumer's step is the plain version's after _step_inputs, with
//     no work it can skip: queue ownership is a mask kept beside the owners
//     (a queue is owned iff a thread is attached to it), not rebuilt every
//     step; a woken thread's claim is selects (in the <4, 4> build a
//     thread that did not wake skips its scan of the queues); a step's
//     counts are integers (exact in float32, converted once); the point's
//     next schedule edge and its rate stay in registers, and the segment
//     pointer only moves forward (searchsorted(side="right") - 1, clipped);
//     a queue's drain and fill bounds are one division with its operands
//     selected, not two behind branches (at most one of them can bind).
//  5. M_MAX and Q_MAX are template parameters and every array index is a
//     compile-time constant after unrolling: <4, 1> and <4, 4>.  Lanes past
//     a point's m are masked at run time and add exact zeros; the jump and
//     the arrivals skip the queues past its n_queues, whose every value is
//     an exact zero that the plain version adds into sums begun at +0.
//  6. A window's sums stay in registers and are written when the window
//     index changes: the step's window is monotone in time.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPoints = 32;        // points a block: the consumer warp's lanes
// producer warps a block, two on each of three schedulers; warp 4, which
// would share the consumer's, idles
constexpr int kProducers = 6;
constexpr int kThreads = 256;      // the consumer, the idle warp and the producers
constexpr int kStageSteps = 32;    // steps a stage of the ring
constexpr int kStages = 3;
constexpr int kMaxStates = 4;
constexpr int kNumFParams = 21;
constexpr int kNumSums = 14;
constexpr uint32_t kWord3 = 1;                    // the fixed-slot sweep draws with 0
constexpr float kTwoPi = 6.28318548202514648f;   // float32(2 pi)
constexpr float kRateEps = 1e-9f;                 // batched_adaptive._RATE_EPS
constexpr float kWakeEps = 1e-6f;                 // batched_adaptive._WAKE_EPS_US
constexpr float kRelease = 1e-6f;                 // a drained queue releases at <= 1e-6

enum Stream : uint32_t { kInit = 0, kNormal = 1, kTail = 2, kIntf = 3, kStall = 4 };
enum Flag : int { kSigma = 1, kTailOn = 2, kIntfOn = 4, kStallOn = 8 };

struct Params {
  float floor, duration, mu, inv_mu, cap, cap_fill, wake_cost, base, sigma, slope1;
  float tail_prob, tail_mean, intf_prob, intf_mean, inv_stall, stall_mean;
  float active_power, window, inv_window, steps_f, tail_steps;
  float st_power[kMaxStates], st_trans[kMaxStates], st_thr[kMaxStates];
  int n_states, flags;
  int n_points, n_run, n_seg, n_windows;
};

// A stage's fields, per step and lane: the normal of each queue, each
// thread's overshoot, and with stalls on, the stall window's length and
// gap and each thread's re-arm jitter.
template <int MM, int QQ>
struct Layout {
  static constexpr int kZ = 0, kOver = QQ, kLen = QQ + MM, kGap = QQ + MM + 1,
                       kJit = QQ + MM + 2;
  static __host__ __device__ int fields(int flags) {
    return (flags & kStallOn) ? kJit + MM : kLen;
  }
  static __host__ __device__ int stage_floats(int flags) {
    return kStageSteps * fields(flags) * kPoints;
  }
  static size_t smem_bytes(int flags) {
    return sizeof(float) * (size_t)kStages * stage_floats(flags);
  }
};

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
// thread, from step t's draws; every family's blocks are drawn, and a draw
// that misses adds nothing (the plain version's + 0, exact)
template <int MM>
__device__ __forceinline__ void overshoot(int t, int m, uint32_t k0, uint32_t k1,
                                          const Params& P, float over[MM]) {
#pragma unroll
  for (int i = 0; i < MM; ++i) over[i] = P.base;
  if (P.flags & kSigma) {
    float z[4];
    box_muller(philox(t, kNormal, 1, kWord3, k0, k1), m, z);
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
    const Words hit = philox(t, stream, 0, kWord3, k0, k1);
    const Words len = philox(t, stream, 1, kWord3, k0, k1);
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      if (i < m && u01(hit.w[i]) < prob) over[i] = over[i] + mean * expo(u01(len.w[i]));
    }
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

struct Inputs {
  const float *t_s, *t_l;
  const int *m, *nq;
  const float* lam;
  const int *seed_lo, *seed_hi;
  const float *sched_edges, *sched_scales;
};

// Producer warp p: every state-free value of steps p, p + kProducers, ... of
// each stage, for the block's 32 points (lane = point), until the consumer
// stops (`stop`: the step it stopped at, INT_MAX while it runs).
template <int MM, int QQ>
__device__ __forceinline__ void produce(int p, int lane, int pt, bool live,
                                        const Inputs& in, float* ring, uint32_t full,
                                        uint32_t empty, const volatile int* stop,
                                        const Params& P) {
  using L = Layout<MM, QQ>;
  const int nf = L::fields(P.flags);
  const int stage_floats = L::stage_floats(P.flags);
  const bool stall_on = P.flags & kStallOn;
  const int m = in.m[pt];
  const uint32_t k0 = (uint32_t)in.seed_lo[pt], k1 = (uint32_t)in.seed_hi[pt];
  const int n_stages = (P.n_run + kStageSteps - 1) / kStageSteps;
  for (int g = 0; g < n_stages; ++g) {
    const int s = g % kStages;
    mbar_wait(empty + 8 * s, ((g / kStages) & 1) ^ 1);
    if (g * kStageSteps >= *stop) return;    // the consumer stopped before this stage
    float* tab = ring + (size_t)s * stage_floats;
    const int n = min(kStageSteps, P.n_run - g * kStageSteps);
    for (int k = p; live && k < n; k += kProducers) {
      const int t = g * kStageSteps + k;
      float* row = tab + k * nf * kPoints + lane;
      float z[4];
      box_muller(philox(t, kNormal, 0, kWord3, k0, k1), QQ, z);
#pragma unroll
      for (int q = 0; q < QQ; ++q) row[(L::kZ + q) * kPoints] = z[q];
      float over[MM];
      overshoot<MM>(t, m, k0, k1, P, over);
#pragma unroll
      for (int i = 0; i < MM; ++i) row[(L::kOver + i) * kPoints] = over[i];
      if (stall_on) {
        const Words st = philox(t, kStall, 0, kWord3, k0, k1);
        row[L::kLen * kPoints] = P.stall_mean * expo(u01(st.w[0]));
        row[L::kGap * kPoints] = expo(u01(st.w[1])) * P.inv_stall;
        const Words jit = philox(t, kStall, 1, kWord3, k0, k1);
#pragma unroll
        for (int i = 0; i < MM; ++i) row[(L::kJit + i) * kPoints] = u01(jit.w[i]);
      }
    }
    mbar_arrive(full + 8 * s);
  }
}

// One step's state-free values, as the consumer reads them from the ring.
template <int MM, int QQ>
struct Step {
  float z[QQ], over[MM], len, gap, jit[MM];
};

// `row` is the step's row at the consumer's lane
template <int MM, int QQ>
__device__ __forceinline__ void load_step(Step<MM, QQ>& x, const float* row, bool stall_on) {
  using L = Layout<MM, QQ>;
#pragma unroll
  for (int q = 0; q < QQ; ++q) x.z[q] = row[(L::kZ + q) * kPoints];
#pragma unroll
  for (int i = 0; i < MM; ++i) x.over[i] = row[(L::kOver + i) * kPoints];
  if (stall_on) {
    x.len = row[L::kLen * kPoints];
    x.gap = row[L::kGap * kPoints];
#pragma unroll
    for (int i = 0; i < MM; ++i) x.jit[i] = row[(L::kJit + i) * kPoints];
  }
}

// The consumer warp: the jumps of the block's 32 points (lane = point),
// step after step, on the values the producers made.  A thread's owner is
// -1 while it sleeps, -2 for a lane past the point's m, else the queue it
// drains.
template <int MM, int QQ>
__device__ __forceinline__ void consume(int lane, int pt, bool live, const Inputs& in,
                                        const float* ring, uint32_t full, uint32_t empty,
                                        volatile int* stop, const Params& P,
                                        float* __restrict__ sums, float* __restrict__ win,
                                        float* __restrict__ ends) {
  using L = Layout<MM, QQ>;
  const int nf = L::fields(P.flags);
  const int stage_floats = L::stage_floats(P.flags);
  const bool stall_on = P.flags & kStallOn;
  const bool windows = P.n_windows > 0;
  const float t_s = in.t_s[pt], t_l = in.t_l[pt], lam = in.lam[pt];
  const int m = in.m[pt], nq = in.nq[pt];
  const float nq_f = (float)nq;
  const uint32_t k0 = (uint32_t)in.seed_lo[pt], k1 = (uint32_t)in.seed_hi[pt];
  const float e_arm_s = arm_cost(t_s, P), e_arm_l = arm_cost(t_l, P);
  const float ts1 = t_s * P.slope1, tl1 = t_l * P.slope1;

  float sleep_rem[MM];
  int attached[MM];
  {
    const Words w0 = philox(0, kInit, 0, kWord3, k0, k1);
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      sleep_rem[i] = i < m ? fmaxf(u01(w0.w[i]) * t_s, P.floor) : INFINITY;
      attached[i] = i < m ? -1 : -2;
    }
  }
  float next_stall = INFINITY;
  if (stall_on) next_stall = expo(u01(philox(0, kInit, 1, kWord3, k0, k1).w[0])) * P.inv_stall;
  float backlog[QQ], vac[QQ], res[QQ];
  int occ[QQ];
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    backlog[q] = vac[q] = res[q] = 0.0f;
    occ[q] = 0;
  }
  float stall_end = -1.0f;
  float rem = P.duration;
  float s[kNumSums];
#pragma unroll
  for (int k = 0; k < kNumSums; ++k) s[k] = 0.0f;

  // the schedule: the segment's rate and the next edge in registers, the
  // pointer only moving forward (the simulated time only grows)
  const float* edges = in.sched_edges + (size_t)pt * P.n_seg;
  const float* scales = in.sched_scales + (size_t)pt * P.n_seg;
  const float lam_fixed = lam / nq_f;
  int seg = 0;
  float lq_seg = lam_fixed, next_edge = INFINITY;
  if (P.n_seg > 0) {
    lq_seg = lam * scales[0] / nq_f;
    if (P.n_seg > 1) next_edge = edges[1];
  }
  float* wout = win + (size_t)pt * P.n_windows * 5;
  int cur_w = 0;
  float wacc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};

  const int n_stages = (P.n_run + kStageSteps - 1) / kStageSteps;
  bool stopped = false;
  for (int g = 0; g < n_stages && !stopped; ++g) {
    const int st = g % kStages;
    mbar_wait(full + 8 * st, (g / kStages) & 1);
    const float* row = ring + (size_t)st * stage_floats + lane;
    const int n = min(kStageSteps, P.n_run - g * kStageSteps);
    Step<MM, QQ> nx = {};
    load_step(nx, row, stall_on);
    for (int k = 0; k < n; ++k) {
      const int t = g * kStageSteps + k;
      const bool active = live && rem > 0.0f;
      if (!__any_sync(0xffffffffu, active)) {
        // every point of the warp has reached its duration
        if (lane == 0) {
          *stop = t;
          __threadfence_block();
        }
        stopped = true;
        break;
      }
      const Step<MM, QQ> x = nx;
      if (k + 1 < n) row += nf * kPoints;
      load_step(nx, row, stall_on);
      if (!active) continue;
      const float now = P.duration - rem;

      // ---- the jump: distance to the next boundary
      float wake_dt = INFINITY;
#pragma unroll
      for (int i = 0; i < MM; ++i) {
        if (attached[i] == -1) wake_dt = fminf(wake_dt, fmaxf(sleep_rem[i], 0.0f));
      }
      float lq = lam_fixed, seg_dt = INFINITY;
      if (P.n_seg > 0) {
        while (next_edge <= now) {
          ++seg;
          lq_seg = lam * scales[seg] / nq_f;
          next_edge = seg + 1 < P.n_seg ? edges[seg + 1] : INFINITY;
        }
        lq = lq_seg;
        seg_dt = next_edge - now;
      }
      float drain_q[QQ];
      float drain_dt = INFINITY, fill_dt = INFINITY;
#pragma unroll
      for (int q = 0; q < QQ; ++q) {
        drain_q[q] = INFINITY;
        if (q > 0 && q >= nq) continue;    // past the point's queues
        // an owned queue drains where mu - lam > eps and fills where lam -
        // mu > eps (exact negatives of each other), a free queue fills where
        // lam > eps: one division a queue, its operands selected, takes
        // either bound with the plain version's operands
        const float net_out = P.mu - lq;
        const float net_in = lq - (occ[q] ? P.mu : 0.0f);
        const bool drains = occ[q] && net_out > kRateEps;
        const bool fills = net_in > kRateEps && backlog[q] < P.cap_fill;
        const float quo = (drains ? fmaxf(backlog[q], 0.0f) : P.cap - backlog[q]) /
                          fmaxf(drains ? net_out : net_in, kRateEps);
        if (drains) drain_q[q] = quo;
        drain_dt = fminf(drain_dt, drain_q[q]);
        if (fills) fill_dt = fminf(fill_dt, quo);
      }
      float dt_b = fminf(fminf(wake_dt, drain_dt), fminf(fill_dt, seg_dt));
      float dt_b3 = stall_on ? next_stall - now : rem;
      if (windows)
        dt_b3 = fminf((floorf(now * P.inv_window) + 1.0f) * P.window - now, dt_b3);
      dt_b = fminf(dt_b, fminf(dt_b3, rem));
      // the floor never steps past a wake or a drain-out; the tail's pace
      // takes the remaining time evenly over the steps left
      float floor_eff = fminf(fmaxf(fminf(wake_dt, drain_dt), kWakeEps), P.floor);
      const float steps_left = P.steps_f - (float)t;
      if (steps_left <= P.tail_steps) floor_eff = fmaxf(floor_eff, rem / steps_left);
      const float dt = fminf(fmaxf(dt_b, floor_eff), rem);
      const bool forced = dt > fmaxf(dt_b, P.floor) + kWakeEps;
      const float t_new = now + dt;

      // 1. arrivals; 2. drain; 3. Little integral and vacations
      const float mu_dt = P.mu * dt;
      const float drain_by = dt + kWakeEps;
      float offered = 0.f, dropped = 0.f, served = 0.f, b_old = 0.f, b_new_sum = 0.f;
#pragma unroll
      for (int q = 0; q < QQ; ++q) {
        if (q > 0 && q >= nq) continue;
        const bool drain_now = occ[q] && drain_q[q] <= drain_by;
        const float mu_a = lq * dt;
        const float zq = drain_now ? 0.0f : x.z[q];
        const float raw = res[q] + mu_a + sqrtf(mu_a) * zq;
        const float a = fmaxf(raw, 0.0f);
        res[q] = fminf(raw, 0.0f);
        const float room = fmaxf(P.cap - backlog[q], 0.0f) + (occ[q] ? mu_dt : 0.0f);
        const float adm = fminf(a, room);
        const float serve = occ[q] ? fminf(backlog[q] + adm, mu_dt) : 0.0f;
        const float b_new = fminf(fmaxf(backlog[q] + adm - serve, 0.0f), P.cap);
        offered = q ? offered + a : a;
        dropped = q ? dropped + (a - adm) : a - adm;
        served = q ? served + serve : serve;
        b_old = q ? b_old + backlog[q] : backlog[q];
        b_new_sum = q ? b_new_sum + b_new : b_new;
        if (!occ[q]) vac[q] = vac[q] + dt;
        backlog[q] = b_new;
      }
      const float lat_area = 0.5f * (b_old + b_new_sum) * dt;

      // 4. the stall process at the boundary
      if (stall_on && next_stall <= t_new) {
        stall_end = fmaxf(stall_end, next_stall + x.len);
        next_stall = next_stall + x.gap;
      }

      // 5. wakes at the boundary; an open stall window defers them
      const bool defer = stall_on && t_new < stall_end;
      bool woken[MM];
      int n_wake = 0;
#pragma unroll
      for (int i = 0; i < MM; ++i) {
        const bool sleeping = attached[i] == -1;
        if (sleeping) sleep_rem[i] = sleep_rem[i] - dt;
        woken[i] = sleeping && sleep_rem[i] <= kWakeEps;
        if (woken[i] && defer) {
          woken[i] = false;
          sleep_rem[i] = (stall_end - t_new) + x.jit[i];
        }
        n_wake += woken[i];
      }

      // 6. queues drained out release their thread (fresh T_S sleep)
      int tsa = 0;
      bool q_done[QQ];
#pragma unroll
      for (int q = 0; q < QQ; ++q) q_done[q] = occ[q] && backlog[q] <= kRelease;
#pragma unroll
      for (int i = 0; i < MM; ++i) {
        bool done = false;
#pragma unroll
        for (int q = 0; q < QQ; ++q) done |= attached[i] == q && q_done[q];
        if (done) {
          tsa += 1;
          sleep_rem[i] = ts1 + x.over[i];
          attached[i] = -1;
        }
      }
#pragma unroll
      for (int q = 0; q < QQ; ++q) {
        if (q_done[q]) occ[q] = 0;
      }

      // 7. claims, threads in index order: the longest free backlog >= 1
      // (ties to the lowest index), else an empty win (re-sleep T_S onto
      // the expired timer's residual), else a busy try (T_L)
      int busy = 0, cyc = 0;
      float vacs = 0.f, nvs = 0.f;
#pragma unroll
      for (int i = 0; i < MM; ++i) {
        // with one queue a thread's claim is a few selects; with four, a
        // thread that did not wake skips its scan of the queues
        if (QQ > 1 && !woken[i]) continue;
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
          sleep_rem[i] = sleep_rem[i] + ((eqi >= 0 ? ts1 : tl1) + x.over[i]);
      }

      rem = rem - dt;
      const float fwake = (float)n_wake, fbusy = (float)busy, ftsa = (float)tsa;
      const float awake = fwake * P.wake_cost + served * P.inv_mu;
      const float energy = P.active_power * awake + ftsa * e_arm_s + fbusy * e_arm_l;
      const float step[kNumSums] = {offered, dropped, served, fwake, fbusy, (float)cyc, awake,
                                    lat_area, vacs, nvs, ftsa, energy, 1.0f,
                                    forced ? 1.0f : 0.0f};
#pragma unroll
      for (int k = 0; k < kNumSums; ++k) s[k] = s[k] + step[k];

      if (windows) {
        const int w = max(0, min((int)(now * P.inv_window), P.n_windows - 1));
        if (w != cur_w) {
          for (int j = cur_w; j < w; ++j) {
#pragma unroll
            for (int c = 0; c < 5; ++c) wout[j * 5 + c] = j == cur_w ? wacc[c] : 0.0f;
          }
#pragma unroll
          for (int c = 0; c < 5; ++c) wacc[c] = 0.0f;
          cur_w = w;
        }
        wacc[0] = wacc[0] + offered;
        wacc[1] = wacc[1] + served;
        wacc[2] = wacc[2] + lat_area;
        wacc[3] = wacc[3] + awake;
        wacc[4] = wacc[4] + energy;
      }
    }
    // the stage is released after its last step, and after the store of
    // `stop` where the warp stopped inside it
    __syncwarp();
    mbar_arrive(empty + 8 * st);
  }
  if (!live) return;

  // the open window, then zeros for every window no step reached
  for (int j = cur_w; j < P.n_windows; ++j) {
#pragma unroll
    for (int c = 0; c < 5; ++c) wout[j * 5 + c] = j == cur_w ? wacc[c] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kNumSums; ++k) sums[(size_t)k * P.n_points + pt] = s[k];
  float bsum = 0.f;
#pragma unroll
  for (int q = 0; q < QQ; ++q) bsum = q ? bsum + backlog[q] : backlog[q];
  ends[pt] = bsum;
  ends[P.n_points + pt] = P.duration - rem;
}

template <int MM, int QQ>
__global__ void __launch_bounds__(kThreads, 1)
    adaptive_sweep_kernel(const Inputs in, float* __restrict__ sums, float* __restrict__ win,
                          float* __restrict__ ends, const Params P) {
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  __shared__ int stop;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pt = blockIdx.x * kPoints + lane;
  const bool live = pt < P.n_points;
  // full[s] at full + 8 s, empty[s] at empty + 8 s
  const uint32_t full = smem_u32(bars), empty = smem_u32(bars + kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32 * kProducers);
      mbar_init(empty + 8 * s, 32);
    }
    stop = INT_MAX;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // lanes past n_points read the last point's inputs, draw nothing and
  // write nothing; they still take part in every barrier and vote
  const int src = live ? pt : P.n_points - 1;
  if (warp == 0) {
    consume<MM, QQ>(lane, src, live, in, ring, full, empty, &stop, P, sums, win, ends);
  } else if (warp != 4) {
    produce<MM, QQ>(warp - 1 - (warp > 4), lane, src, live, in, ring, full, empty, &stop, P);
  }
}

template <int MM, int QQ>
cudaError_t launch(const Inputs& in, void* sums, void* win, void* ends, const Params& P,
                   cudaStream_t st) {
  const size_t smem = Layout<MM, QQ>::smem_bytes(P.flags);
  cudaError_t err = cudaFuncSetAttribute(adaptive_sweep_kernel<MM, QQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (P.n_points + kPoints - 1) / kPoints;
  adaptive_sweep_kernel<MM, QQ><<<blocks, kThreads, smem, st>>>(
      in, static_cast<float*>(sums), static_cast<float*>(win), static_cast<float*>(ends), P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Inputs, one per point (n_points): t_s, t_l, lam f32; m, nq, seed_lo, seed_hi
// int32 (the seed's two 32-bit words); sched_edges and sched_scales f32
// (n_points, n_seg), or null with n_seg = 0.  Outputs: sums f32 (14,
// n_points) in the order offered, dropped, serviced, wakeups, busy_tries,
// cycles, awake_us, lat_area, vac_sum, nv_sum, ts_arms, energy_uj, n_steps,
// forced_steps; win f32 (n_points, n_windows, 5) (null with n_windows = 0);
// ends f32 (2, n_points): the final backlog, then the simulated time.
// m_max, q_max <= 4.  n_run: the steps to run (the budget, or a prefix).
// flags: 1 sigma, 2 tail, 4 interference, 8 stalls.  fparams (host, 21):
// slot_us, duration_us, mu, 1/mu, capacity, capacity - 1, wake_cost_us,
// base_us, sigma_us, 1 + slope, tail_prob, tail_mean_us, interference_prob,
// interference_mean_us, 1/stall_rate, stall_mean_us, active_power_w,
// window_us, 1/window_us, the budget, the tail's steps (each reciprocal
// float32(1) / float32(x)).  states (host, 3 n_states): (power_w,
// transition_uj, min_residency_us), shallow to deep.  build (host, 2 ints
// out): the (M_MAX, Q_MAX) instantiation launched.  Returns a cudaError_t
// (0 on success); the launch is asynchronous on `stream`.
int adaptive_sweep_fwd(const void* t_s, const void* t_l, const void* m, const void* nq,
                       const void* lam, const void* seed_lo, const void* seed_hi,
                       const void* sched_edges, const void* sched_scales, void* sums, void* win,
                       void* ends, int n_points, int n_run, int m_max, int q_max, int n_seg,
                       int n_windows, int flags, const float* fparams, int n_fparams,
                       const float* states, int n_states, int device, int* build,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_points <= 0 || n_run < 0 || m_max < 1 || m_max > 4 || q_max < 1 || q_max > 4 ||
      n_fparams != kNumFParams || n_states < 1 || n_states > kMaxStates || n_seg < 0 ||
      (n_seg > 0 && (sched_edges == nullptr || sched_scales == nullptr)) || n_windows < 0 ||
      (n_windows > 0 && win == nullptr))
    return (int)cudaErrorInvalidValue;
  Params P;
  const float* f = fparams;
  P.floor = f[0];
  P.duration = f[1];
  P.mu = f[2];
  P.inv_mu = f[3];
  P.cap = f[4];
  P.cap_fill = f[5];
  P.wake_cost = f[6];
  P.base = f[7];
  P.sigma = f[8];
  P.slope1 = f[9];
  P.tail_prob = f[10];
  P.tail_mean = f[11];
  P.intf_prob = f[12];
  P.intf_mean = f[13];
  P.inv_stall = f[14];
  P.stall_mean = f[15];
  P.active_power = f[16];
  P.window = f[17];
  P.inv_window = f[18];
  P.steps_f = f[19];
  P.tail_steps = f[20];
  for (int s = 0; s < kMaxStates; ++s) {
    const bool on = s < n_states;
    P.st_power[s] = on ? states[3 * s] : 0.0f;
    P.st_trans[s] = on ? states[3 * s + 1] : 0.0f;
    P.st_thr[s] = on ? states[3 * s + 2] : 0.0f;
  }
  P.n_states = n_states;
  P.flags = flags;
  P.n_points = n_points;
  P.n_run = n_run;
  P.n_seg = n_seg;
  P.n_windows = n_windows;
  const Inputs in{static_cast<const float*>(t_s),          static_cast<const float*>(t_l),
                  static_cast<const int*>(m),              static_cast<const int*>(nq),
                  static_cast<const float*>(lam),          static_cast<const int*>(seed_lo),
                  static_cast<const int*>(seed_hi),        static_cast<const float*>(sched_edges),
                  static_cast<const float*>(sched_scales)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  build[0] = 4;
  build[1] = q_max == 1 ? 1 : 4;
  return (int)(q_max == 1 ? launch<4, 1>(in, sums, win, ends, P, st)
                          : launch<4, 4>(in, sums, win, ends, P, st));
}

const char* adaptive_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
