// Fixed-slot Metronome sweep (S1) for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the body of the reference's batched engine,
// src/repro/runtime/batched.py, _build_sweep.one_point (:543): a lax.scan over
// time slots (:741) under jax.jit(jax.vmap(...)) (:745), one scan a grid point.
// It is not a pallas_call, but it is the reference's own accelerator hot path
// outside the model: a sweep runs thousands of points for 10^5 slots each.
//
// What one point computes, slot by slot (dt = slot_us), all in float32:
//   stall windows  Bernoulli(stall_p) opens an Exp(stall_mean) window;
//                  overlapping windows extend (max);
//   arrivals       per queue, raw = res + mu_a + sqrt(mu_a) z with mu_a =
//                  lam / nq * scale(now) * dt (scale from the point's
//                  piecewise-constant schedule), a = max(raw, 0), res =
//                  min(raw, 0), admitted up to the queue's room;
//   overshoot      base + sigma |z| + tail and interference Bernoulli x Exp;
//                  re-sleeps are t_s (1 + slope) + over or t_l (1 + slope) +
//                  over;
//   wakes          sleeping threads count down; an expired timer inside an
//                  open stall window moves to its end (+U(0,1)) uncounted;
//   claims         woken threads in index order: the free queue with the
//                  longest backlog >= 1 (ties to the lowest index, as
//                  jnp.argmax), else an empty win (re-sleep T_S, the first
//                  free queue's vacation ends), else a busy try (re-sleep
//                  T_L);
//   drain          owned queues serve min(backlog, mu dt); a queue at
//                  <= 1e-6 releases its thread (re-sleep T_S);
//   sums           vacations tick on free queues; the Little's-law area,
//                  awake time, energy (active power x awake + per-arm C-state
//                  charges, energy_arm_cost of batched.py:336), and the
//                  per-window [offered, served, lat_area, awake, energy].
// The plain version, kernels/slot_sweep/ops.py:reference_slot_sweep, makes
// the same float32 operations in the same order, and this file is built with
// -fmad=false so that no product and sum fuse into one rounding: on the same
// draws the two agree bit for bit, up to the math library's log/sin/cos.
//
// Noise: the Philox contract of kernels/slot_sweep/philox.py.  Philox4x32-10
// keyed by the point's 64-bit seed (lo, hi), counter (slot, stream, lane
// block, 0); uniforms u = (w >> 8) 2^-24, exponentials -log(1 - u), normals
// Box-Muller on word pairs (r = sqrt(-2 log(1 - u_a)), th = 2pi u_b, r cos th
// and r sin th).  Streams: 0 initial sleeps, 1 normals (block 0 queues,
// block 1 threads), 2 tail (block 0 hit, block 1 length), 3 interference
// (same), 4 stalls (block 0: word 0 start, word 1 length; block 1 re-arm
// jitter).  The generator is counter-based, so a value drawn at a slot where
// no thread uses it changes nothing: the kernel draws every family at every
// slot, and the values it uses are the contract's.
//
// What binds: a point's slots form one dependent chain (its timers, owners
// and backlogs), and a sweep has a few thousand points at most, so a few
// dozen warps carry the whole sweep and the latency of one warp's chain
// sets the time, not a throughput limit of the card (PERF.md §5: on an
// H100, a kernel of one thread a point spent 0.98 of a slot's 1.69 us on
// draws and 0.71 on the state machine).  The design takes every draw off
// that chain and keeps the rest of it short:
//  1. Warp specialisation.  A block is 32 points: one consumer warp (lane =
//     point) runs the state machine, with the whole state (sleep timers,
//     owners, backlogs, vacation timers, residuals, stall end, the twelve
//     sums and the open window's five) in registers.  Producer warps make
//     everything that does not depend on the state, at every slot: the
//     Philox draws and their transforms, the schedule lookup (a segment
//     pointer that only moves forward, searchsorted(side="right") - 1,
//     clipped), the arrival means and noise, the overshoot, the stall
//     window a slot opens, the re-arm jitter and the slot's window index.
//     The consumer's slot is the plain version's loop after _slot_inputs.
//     Three producers (warps 1-3: one warp on each of the SM's four
//     schedulers) keep ahead of the consumer where a slot draws at most
//     three Philox blocks; where it draws more (noisy hosts, tails), six
//     (warps 1-3 and 5-7; warp 4, on the consumer's scheduler, idles).  The
//     producer count is a template parameter, so each block shape gets its
//     own launch bounds (under the bounds of 256 threads the consumer's
//     code ran 8% slower on an H100).
//  2. A ring of kStages stages in shared memory, each kStageSlots slots x
//     the fields of 32 points (Layout), laid out [slot][field][lane] so that
//     every access is one conflict-free word a lane.  Hand-off by mbarriers:
//     full[s] (every producer lane arrives, the consumer waits) and empty[s]
//     (the consumer's 32 lanes arrive, the producers wait), with phase
//     parities.  Producer p of np fills slots p, p + np, ... of each stage.
//     The consumer loads slot k + 1's fields before it runs slot k, so their
//     latency hides behind a slot's work.  The fields of a stall
//     environment are laid out only when stalls are on.
//  3. The consumer's slot is straight-line predicated code where it can be:
//     a woken thread's claim is selects, not a branch around it (11% off
//     sweep_frontier's quiet grid on an H100); queue ownership is a mask
//     kept beside the owners
//     (a queue is owned iff a thread is attached to it), not rebuilt every
//     slot; a slot's counts are integers (exact in float32, converted once);
//     and the one division, served / mu, runs only where its quotient is not
//     known (0, or mu dt from one queue): its latency sat on every slot's
//     chain (17% of that grid's time).
//  4. M_MAX and Q_MAX are template parameters and every array index is a
//     compile-time constant after unrolling.  Two builds: <4, 1> for
//     one-queue grids and <4, 4> for the rest.  Lanes past a point's m or
//     n_queues are masked at run time and add exact zeros, so a point's
//     result does not depend on the build; its time does: on an H100,
//     <4, 4> takes 3.25x as long as <4, 1> on sweep_frontier's one-queue
//     grid (chip_smoke.py's phase 3 repeats that A/B).  Which noise
//     families are on is a run-time branch, uniform over the grid, not a
//     template.
//  5. A window's sums stay in registers and are written when the window
//     index changes: no atomics, the float32 order of win_acc.at[w].add.
//  6. The run has the slots with float(t) * slot_us < duration, the
//     reference's own float32 product; the host finds their count by
//     bisection (the product grows with t), so no slot past the run is
//     padded in.  Lanes past n_points draw nothing and write nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPoints = 32;        // points a block: the consumer warp's lanes
// producer warps a block: three where a slot draws few Philox blocks, six
// (two on each of three schedulers; warp 4, which would share the
// consumer's, idles) where it draws many (producers(), PERF.md §6)
constexpr int kFewProducers = 3, kManyProducers = 6;
constexpr int kStageSlots = 32;    // slots a stage of the ring
constexpr int kStages = 3;
constexpr int kMaxStates = 4;
constexpr int kNumFParams = 17;
constexpr int kNumStats = 12;
constexpr float kTwoPi = 6.28318548202514648f;   // float32(2 pi)

enum Stream : uint32_t { kInit = 0, kNormal = 1, kTail = 2, kIntf = 3, kStall = 4 };
enum Flag : int { kSigma = 1, kTailOn = 2, kIntfOn = 4, kStallOn = 8 };

struct Params {
  float dt, duration, mu, mu_dt, capacity, wake_cost, base, sigma, one_plus_slope;
  float tail_prob, tail_mean, intf_prob, intf_mean, stall_p, stall_mean;
  float active_power, window_us;
  float st_power[kMaxStates], st_trans[kMaxStates], st_thr[kMaxStates];
  int n_states, flags;
  int n_points, n_live, n_seg, n_windows, n_win_pad;
};

// A stage's fields, per slot and lane: the arrival mean and noise of each
// queue, each thread's overshoot, and with stalls on, each thread's re-arm
// jitter and the stall end the slot opens (-inf where it opens none).
template <int MM, int QQ>
struct Layout {
  static constexpr int kMu = 0, kNoise = QQ, kOver = 2 * QQ, kJit = 2 * QQ + MM,
                       kOpen = 2 * QQ + 2 * MM;
  static __host__ __device__ int fields(int flags) {
    return (flags & kStallOn) ? kOpen + 1 : kJit;
  }
  // floats of one stage: the table, then one window index a slot
  static __host__ __device__ int stage_floats(int flags) {
    return kStageSlots * (fields(flags) * kPoints + 1);
  }
  static size_t smem_bytes(int flags) {
    return sizeof(float) * (size_t)kStages * stage_floats(flags);
  }
};

// Producer warps for a sweep's noise: the Philox blocks a slot draws at most
// (the queues' normals, the threads' normals, hit and length of the tail
// and of the interference, the stall start and the re-arm jitter) set
// whether three keep ahead of the consumer
__host__ __device__ inline int producers(int flags) {
  const int blocks = 1 + !!(flags & kSigma) + 2 * !!(flags & kTailOn) +
                     2 * !!(flags & kIntfOn) + 2 * !!(flags & kStallOn);
  return blocks >= 4 ? kManyProducers : kFewProducers;
}

// threads a block: the consumer warp, the producers, and the idle warp 4
// beside six
__host__ __device__ constexpr int threads(int np) { return np == kFewProducers ? 128 : 256; }

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
      // one argument reduction for both (the values of cosf and sinf)
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

struct Inputs {
  const float *t_s, *t_l;
  const int *m, *nq;
  const float* lam;
  const int *seed_lo, *seed_hi;
  const float *sched_edges, *sched_scales;
};

// Producer warp p of np: every state-free value of slots p, p + np, ... of
// each stage, for the block's 32 points (lane = point).
template <int MM, int QQ>
__device__ __forceinline__ void produce(int p, int np, int lane, int pt, bool live,
                                        const Inputs& in, float* ring, uint32_t full,
                                        uint32_t empty, const Params& P) {
  using L = Layout<MM, QQ>;
  const int nf = L::fields(P.flags);
  const int stage_floats = L::stage_floats(P.flags);
  const bool stall_on = P.flags & kStallOn;
  const int m = in.m[pt], nq = in.nq[pt];
  const uint32_t k0 = (uint32_t)in.seed_lo[pt], k1 = (uint32_t)in.seed_hi[pt];
  const float dt = P.dt;
  const float lam_q = in.lam[pt] / (float)nq;
  const float* edges = in.sched_edges + (size_t)pt * P.n_seg;
  const float* scales = in.sched_scales + (size_t)pt * P.n_seg;
  int seg = 0;
  const int n_stages = (P.n_live + kStageSlots - 1) / kStageSlots;
  for (int g = 0; g < n_stages; ++g) {
    const int s = g % kStages;
    mbar_wait(empty + 8 * s, ((g / kStages) & 1) ^ 1);
    float* tab = ring + (size_t)s * stage_floats;
    const int n = min(kStageSlots, P.n_live - g * kStageSlots);
    for (int k = p; live && k < n; k += np) {
      const int t = g * kStageSlots + k;
      const float now = (float)t * dt;
      float* row = tab + k * nf * kPoints + lane;
      float scale = 1.0f;
      if (P.n_seg > 0) {
        while (seg + 1 < P.n_seg && edges[seg + 1] <= now) ++seg;
        scale = scales[seg];
      }
      float z[4];
      box_muller(philox(t, kNormal, 0, 0, k0, k1), QQ, z);
#pragma unroll
      for (int q = 0; q < QQ; ++q) {
        const float lq = q < nq ? lam_q : 0.0f;
        const float mu_a = P.n_seg > 0 ? lq * scale * dt : lq * dt;
        row[(L::kMu + q) * kPoints] = mu_a;
        row[(L::kNoise + q) * kPoints] = sqrtf(mu_a) * z[q];
      }
      float over[MM];
      overshoot<MM>(t, m, k0, k1, P, over);
#pragma unroll
      for (int i = 0; i < MM; ++i) row[(L::kOver + i) * kPoints] = over[i];
      if (stall_on) {
        const Words st = philox(t, kStall, 0, 0, k0, k1);
        const float end = now + P.stall_mean * expo(u01(st.w[1]));
        row[L::kOpen * kPoints] = u01(st.w[0]) < P.stall_p ? end : -INFINITY;
        const Words jit = philox(t, kStall, 1, 0, k0, k1);
#pragma unroll
        for (int i = 0; i < MM; ++i) row[(L::kJit + i) * kPoints] = u01(jit.w[i]);
      }
      if (lane == 0 && P.n_windows > 0) {
        const int w = min((int)(now / P.window_us), P.n_win_pad - 1);
        tab[kStageSlots * nf * kPoints + k] = __int_as_float(w);
      }
    }
    mbar_arrive(full + 8 * s);
  }
}

// One slot's state-free values, as the consumer reads them from the ring.
template <int MM, int QQ>
struct Slot {
  float mu[QQ], noise[QQ], over[MM], jit[MM], open;
  int w;
};

// `row` is the slot's row at the consumer's lane; the window index sits at
// `widx`
template <int MM, int QQ>
__device__ __forceinline__ void load_slot(Slot<MM, QQ>& x, const float* row, const float* widx,
                                          bool stall_on, bool windows) {
  using L = Layout<MM, QQ>;
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    x.mu[q] = row[(L::kMu + q) * kPoints];
    x.noise[q] = row[(L::kNoise + q) * kPoints];
  }
#pragma unroll
  for (int i = 0; i < MM; ++i) x.over[i] = row[(L::kOver + i) * kPoints];
  if (stall_on) {
#pragma unroll
    for (int i = 0; i < MM; ++i) x.jit[i] = row[(L::kJit + i) * kPoints];
    x.open = row[L::kOpen * kPoints];
  }
  if (windows) x.w = __float_as_int(*widx);
}

// The consumer warp: the state machine of the block's 32 points (lane =
// point), slot after slot, on the values the producers made.  A thread's
// owner is -1 while it sleeps, -2 for a lane past the point's m, else the
// queue it drains.  A slot's counts (wakes, busy tries, cycles, T_S arms)
// are whole numbers, exact in float32 whatever the order of their sum, so
// they are counted in integers and converted once.
template <int MM, int QQ>
__device__ __forceinline__ void consume(int lane, int pt, bool live, const Inputs& in,
                                        const float* ring, uint32_t full, uint32_t empty,
                                        const Params& P, float* __restrict__ stats,
                                        float* __restrict__ win, float* __restrict__ backlog_out) {
  using L = Layout<MM, QQ>;
  const int nf = L::fields(P.flags);
  const int stage_floats = L::stage_floats(P.flags);
  const bool stall_on = P.flags & kStallOn;
  const bool windows = P.n_windows > 0;
  const float t_s = in.t_s[pt], t_l = in.t_l[pt];
  const int m = in.m[pt], nq = in.nq[pt];
  const float dt = P.dt, cap = P.capacity, mu_dt = P.mu_dt, mu = P.mu;
  const float e_arm_s = arm_cost(t_s, P), e_arm_l = arm_cost(t_l, P);
  const float ts_sleep = t_s * P.one_plus_slope, tl_sleep = t_l * P.one_plus_slope;
  // served / mu where a slot serves mu dt (one queue drained at its rate):
  // the quotient of most slots that serve, taken once (the same correctly
  // rounded value); a slot that serves nothing adds 0 / mu = +0
  const float full_us = mu_dt / mu;

  float sleep_rem[MM];
  int attached[MM];
  {
    const Words w0 = philox(0, kInit, 0, 0, (uint32_t)in.seed_lo[pt], (uint32_t)in.seed_hi[pt]);
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      sleep_rem[i] = i < m ? fmaxf(u01(w0.w[i]) * t_s, dt) : INFINITY;
      attached[i] = i < m ? -1 : -2;
    }
  }
  float backlog[QQ], vac[QQ], res[QQ];
  int occ[QQ];
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    backlog[q] = vac[q] = res[q] = 0.0f;
    occ[q] = 0;
  }
  float stall_end = -1.0f;
  float s_off = 0.f, s_drop = 0.f, s_serv = 0.f, s_wake = 0.f, s_busy = 0.f, s_cyc = 0.f;
  float s_awake = 0.f, s_lat = 0.f, s_vac = 0.f, s_nv = 0.f, s_ts = 0.f, s_en = 0.f;
  float* wout = win + (size_t)pt * P.n_windows * 5;
  int cur_w = 0;
  float wacc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};

  const int n_stages = (P.n_live + kStageSlots - 1) / kStageSlots;
  for (int g = 0; g < n_stages; ++g) {
    const int s = g % kStages;
    mbar_wait(full + 8 * s, (g / kStages) & 1);
    const float* tab = ring + (size_t)s * stage_floats;
    const float* widx = tab + kStageSlots * nf * kPoints;
    const int n = min(kStageSlots, P.n_live - g * kStageSlots);
    const float* nrow = tab + lane;
    Slot<MM, QQ> nx = {};
    if (live) load_slot(nx, nrow, widx, stall_on, windows);
    for (int k = 0; live && k < n; ++k) {
      const Slot<MM, QQ> x = nx;
      if (k + 1 < n) {
        nrow += nf * kPoints;
        ++widx;
      }
      load_slot(nx, nrow, widx, stall_on, windows);
      const float now = (float)(g * kStageSlots + k) * dt;
      if (stall_on) stall_end = fmaxf(stall_end, x.open);

      // 1. arrivals
      float offered = 0.f, dropped = 0.f;
#pragma unroll
      for (int q = 0; q < QQ; ++q) {
        const float raw = res[q] + x.mu[q] + x.noise[q];
        const float a = fmaxf(raw, 0.0f);
        res[q] = fminf(raw, 0.0f);
        const float adm = fminf(a, fmaxf(cap - backlog[q], 0.0f));
        backlog[q] = backlog[q] + adm;
        offered = q ? offered + a : a;
        dropped = q ? dropped + (a - adm) : a - adm;
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
      // the division only where its quotient is not known: its latency sat
      // on the chain of every slot
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

      if (windows) {
        if (x.w != cur_w) {
          for (int j = cur_w; j < min(x.w, P.n_windows); ++j) {
#pragma unroll
            for (int c = 0; c < 5; ++c) wout[j * 5 + c] = j == cur_w ? wacc[c] : 0.0f;
          }
#pragma unroll
          for (int c = 0; c < 5; ++c) wacc[c] = 0.0f;
          cur_w = x.w;
        }
        wacc[0] = wacc[0] + offered;
        wacc[1] = wacc[1] + served;
        wacc[2] = wacc[2] + lat_area;
        wacc[3] = wacc[3] + awake;
        wacc[4] = wacc[4] + energy;
      }
    }
    mbar_arrive(empty + 8 * s);
  }
  if (!live) return;

  // the open window, then zeros for every window no slot reached
  for (int j = cur_w; j < P.n_windows; ++j) {
#pragma unroll
    for (int c = 0; c < 5; ++c) wout[j * 5 + c] = j == cur_w ? wacc[c] : 0.0f;
  }
  const float out[kNumStats] = {s_off, s_drop, s_serv, s_wake, s_busy, s_cyc,
                                s_awake, s_lat, s_vac, s_nv, s_ts, s_en};
#pragma unroll
  for (int k = 0; k < kNumStats; ++k) stats[(size_t)k * P.n_points + pt] = out[k];
  float bsum = 0.f;
#pragma unroll
  for (int q = 0; q < QQ; ++q) bsum = q ? bsum + backlog[q] : backlog[q];
  backlog_out[pt] = bsum;
}

template <int MM, int QQ, int NP>
__global__ void __launch_bounds__(NP == kFewProducers ? 128 : 256, 1)
    slot_sweep_kernel(const Inputs in, float* __restrict__ stats, float* __restrict__ win,
                      float* __restrict__ backlog_out, const Params P) {
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pt = blockIdx.x * kPoints + lane;
  const bool live = pt < P.n_points;
  // full[s] at full + 8 s, empty[s] at empty + 8 s
  const uint32_t full = smem_u32(bars), empty = smem_u32(bars + kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32 * NP);
      mbar_init(empty + 8 * s, 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // lanes past n_points read the last point's inputs, draw nothing and
  // write nothing; they still take part in every barrier
  const int src = live ? pt : P.n_points - 1;
  if (warp == 0) {
    consume<MM, QQ>(lane, src, live, in, ring, full, empty, P, stats, win, backlog_out);
  } else if (warp != 4) {
    produce<MM, QQ>(warp - 1 - (warp > 4), NP, lane, src, live, in, ring, full, empty, P);
  }
}

template <int MM, int QQ, int NP>
cudaError_t launch(const Inputs& in, void* stats, void* win, void* backlog, const Params& P,
                   cudaStream_t st) {
  const size_t smem = Layout<MM, QQ>::smem_bytes(P.flags);
  cudaError_t err = cudaFuncSetAttribute(slot_sweep_kernel<MM, QQ, NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (P.n_points + kPoints - 1) / kPoints;
  slot_sweep_kernel<MM, QQ, NP><<<blocks, threads(NP), smem, st>>>(
      in, static_cast<float*>(stats), static_cast<float*>(win), static_cast<float*>(backlog), P);
  return cudaGetLastError();
}

template <int MM, int QQ>
cudaError_t launch(const Inputs& in, void* stats, void* win, void* backlog, const Params& P,
                   cudaStream_t st) {
  return producers(P.flags) == kFewProducers
             ? launch<MM, QQ, kFewProducers>(in, stats, win, backlog, P, st)
             : launch<MM, QQ, kManyProducers>(in, stats, win, backlog, P, st);
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

}  // namespace

extern "C" {

// Inputs, one per point (n_points): t_s, t_l, lam f32; m, nq, seed_lo, seed_hi
// int32 (the seed's two 32-bit words); sched_edges and sched_scales f32
// (n_points, n_seg), or null with n_seg = 0.  Outputs: stats f32 (12,
// n_points) in the order offered, dropped, serviced, wakeups, busy_tries,
// cycles, awake_us, lat_area, vac_sum, nv_sum, ts_arms, energy_uj; win f32
// (n_points, n_windows, 5) (null with n_windows = 0); backlog f32 (n_points).
// m_max, q_max <= 4.  flags: 1 sigma, 2 tail, 4 interference, 8 stalls.
// fparams (host, 17): slot_us, duration_us, mu, mu * slot_us, capacity,
// wake_cost_us, base_us, sigma_us, 1 + slope, tail_prob, tail_mean_us,
// interference_prob, interference_mean_us, stall_p, stall_mean_us,
// active_power_w, window_us.  states (host, 3 n_states): (power_w,
// transition_uj, min_residency_us), shallow to deep.  build (host, 2 ints
// out): the (M_MAX, Q_MAX) instantiation launched.  Returns a cudaError_t
// (0 on success); the launch is asynchronous on `stream`.
int slot_sweep_fwd(const void* t_s, const void* t_l, const void* m, const void* nq,
                   const void* lam, const void* seed_lo, const void* seed_hi,
                   const void* sched_edges, const void* sched_scales, void* stats, void* win,
                   void* backlog, int n_points, int n_slots, int m_max, int q_max, int n_seg,
                   int n_windows, int n_win_pad, int flags, const float* fparams,
                   int n_fparams, const float* states, int n_states, int device,
                   int* build, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_points <= 0 || n_slots < 0 || m_max < 1 || m_max > 4 || q_max < 1 || q_max > 4 ||
      n_fparams != kNumFParams || n_states < 1 || n_states > kMaxStates || n_seg < 0 ||
      (n_seg > 0 && (sched_edges == nullptr || sched_scales == nullptr)) || n_windows < 0 ||
      (n_windows > 0 && (win == nullptr || n_win_pad < n_windows)))
    return (int)cudaErrorInvalidValue;
  Params P;
  const float* f = fparams;
  P.dt = f[0];
  P.duration = f[1];
  P.mu = f[2];
  P.mu_dt = f[3];
  P.capacity = f[4];
  P.wake_cost = f[5];
  P.base = f[6];
  P.sigma = f[7];
  P.one_plus_slope = f[8];
  P.tail_prob = f[9];
  P.tail_mean = f[10];
  P.intf_prob = f[11];
  P.intf_mean = f[12];
  P.stall_p = f[13];
  P.stall_mean = f[14];
  P.active_power = f[15];
  P.window_us = f[16];
  for (int s = 0; s < kMaxStates; ++s) {
    const bool on = s < n_states;
    P.st_power[s] = on ? states[3 * s] : 0.0f;
    P.st_trans[s] = on ? states[3 * s + 1] : 0.0f;
    P.st_thr[s] = on ? states[3 * s + 2] : 0.0f;
  }
  P.n_states = n_states;
  P.flags = flags;
  P.n_points = n_points;
  P.n_live = live_slots(P.dt, P.duration, n_slots);
  P.n_seg = n_seg;
  P.n_windows = n_windows;
  P.n_win_pad = n_win_pad;
  const Inputs in{static_cast<const float*>(t_s),          static_cast<const float*>(t_l),
                  static_cast<const int*>(m),              static_cast<const int*>(nq),
                  static_cast<const float*>(lam),          static_cast<const int*>(seed_lo),
                  static_cast<const int*>(seed_hi),        static_cast<const float*>(sched_edges),
                  static_cast<const float*>(sched_scales)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  build[0] = 4;
  build[1] = q_max == 1 ? 1 : 4;
  return (int)(q_max == 1 ? launch<4, 1>(in, stats, win, backlog, P, st)
                          : launch<4, 4>(in, stats, win, backlog, P, st));
}

// The kernel's layout for a q_max and flags (host, 5 ints out): threads and
// points a block, slots a stage, stages, and dynamic shared memory bytes.
void slot_sweep_layout(int q_max, int flags, int* out) {
  out[0] = threads(producers(flags));
  out[1] = kPoints;
  out[2] = kStageSlots;
  out[3] = kStages;
  out[4] = (int)(q_max == 1 ? Layout<4, 1>::smem_bytes(flags) : Layout<4, 4>::smem_bytes(flags));
}

const char* slot_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
