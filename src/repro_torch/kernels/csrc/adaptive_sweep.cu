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
// word 0 window length, word 1 gap; block 1 re-arm jitter).  A draw is made
// only in the step and lane where it is used.
//
// Design (a simple kernel that is right; PERF.md holds its times):
//  1. One thread a grid point, time in series inside the thread, the whole
//     state in registers; M_MAX and Q_MAX are template parameters (<4, 1>
//     and <4, 4>), lanes past a point's m or n_queues are masked at run time
//     and add exact zeros.
//  2. A thread stops at the step where its point reaches the run's duration:
//     the reference scans the whole budget, but a finished point holds its
//     carry (the steps after are inert), so its outputs are the same.  The
//     points of a warp run different numbers of live steps, and the warp
//     runs as long as its longest point (chip_smoke.py logs the spread).
//  3. Blocks of 32 threads, so a sweep of ~2000 points spreads over ~63 SMs:
//     the latency of one thread's dependent chain sets the time.
//  4. The schedule lookup is a segment pointer that only moves forward (the
//     simulated time only grows), as searchsorted(side="right") - 1, clipped.
//  5. A window's sums stay in registers and are written when the window
//     index changes: the step's window is monotone in time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
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
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
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
// thread, from step t's draws
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
    bool any = false;
    bool h[MM];
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      h[i] = i < m && u01(hit.w[i]) < prob;
      any |= h[i];
    }
    if (!any) continue;
    const Words len = philox(t, stream, 1, kWord3, k0, k1);
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      if (h[i]) over[i] = over[i] + mean * expo(u01(len.w[i]));
    }
  }
}

template <int MM, int QQ>
__global__ void __launch_bounds__(kThreads)
    adaptive_sweep_kernel(const float* __restrict__ t_s_, const float* __restrict__ t_l_,
                          const int* __restrict__ m_, const int* __restrict__ nq_,
                          const float* __restrict__ lam_, const int* __restrict__ seed_lo,
                          const int* __restrict__ seed_hi, const float* __restrict__ sched_edges,
                          const float* __restrict__ sched_scales, float* __restrict__ sums,
                          float* __restrict__ win, float* __restrict__ ends, const Params P) {
  const int pt = blockIdx.x * blockDim.x + threadIdx.x;
  if (pt >= P.n_points) return;
  const float t_s = t_s_[pt], t_l = t_l_[pt], lam = lam_[pt];
  const int m = m_[pt], nq = nq_[pt];
  const float nq_f = (float)nq;
  const uint32_t k0 = (uint32_t)seed_lo[pt], k1 = (uint32_t)seed_hi[pt];
  const bool stall_on = P.flags & kStallOn;
  const float e_arm_s = arm_cost(t_s, P), e_arm_l = arm_cost(t_l, P);
  const float ts1 = t_s * P.slope1, tl1 = t_l * P.slope1;

  float sleep_rem[MM];
  int attached[MM];
  {
    const Words w0 = philox(0, kInit, 0, kWord3, k0, k1);
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      sleep_rem[i] = i < m ? fmaxf(u01(w0.w[i]) * t_s, P.floor) : INFINITY;
      attached[i] = -1;
    }
  }
  float next_stall = INFINITY;
  if (stall_on) next_stall = expo(u01(philox(0, kInit, 1, kWord3, k0, k1).w[0])) * P.inv_stall;
  float backlog[QQ], vac[QQ], res[QQ];
#pragma unroll
  for (int q = 0; q < QQ; ++q) backlog[q] = vac[q] = res[q] = 0.0f;
  float stall_end = -1.0f;
  float rem = P.duration;
  float s[kNumSums];
#pragma unroll
  for (int k = 0; k < kNumSums; ++k) s[k] = 0.0f;

  const float* edges = sched_edges + (size_t)pt * P.n_seg;
  const float* scales = sched_scales + (size_t)pt * P.n_seg;
  int seg = 0;
  float* wout = win + (size_t)pt * P.n_windows * 5;
  int cur_w = 0;
  float wacc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  const float lam_fixed = lam / nq_f;

  for (int t = 0; t < P.n_run; ++t) {
    if (!(rem > 0.0f)) break;
    const float now = P.duration - rem;
    bool occ[QQ];
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      occ[q] = false;
#pragma unroll
      for (int i = 0; i < MM; ++i) occ[q] |= attached[i] == q;
    }

    // ---- the jump: distance to the next boundary
    float wake_dt = INFINITY;
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      if (i < m && attached[i] < 0) wake_dt = fminf(wake_dt, fmaxf(sleep_rem[i], 0.0f));
    }
    float lq = lam_fixed, seg_dt = INFINITY;
    if (P.n_seg > 0) {
      while (seg + 1 < P.n_seg && edges[seg + 1] <= now) ++seg;
      lq = lam * scales[seg] / nq_f;
      if (seg + 1 < P.n_seg) seg_dt = edges[seg + 1] - now;
    }
    float drain_q[QQ];
    float drain_dt = INFINITY, fill_dt = INFINITY;
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      const float lq_q = q < nq ? lq : 0.0f;
      const float net_out = occ[q] ? P.mu - lq_q : 0.0f;
      drain_q[q] = occ[q] && net_out > kRateEps
                       ? fmaxf(backlog[q], 0.0f) / fmaxf(net_out, kRateEps)
                       : INFINITY;
      drain_dt = fminf(drain_dt, drain_q[q]);
      const float net_in = lq_q - (occ[q] ? P.mu : 0.0f);
      if (q < nq && net_in > kRateEps && backlog[q] < P.cap_fill)
        fill_dt = fminf(fill_dt, (P.cap - backlog[q]) / fmaxf(net_in, kRateEps));
    }
    float dt_b = fminf(fminf(wake_dt, drain_dt), fminf(fill_dt, seg_dt));
    float dt_b3 = stall_on ? next_stall - now : rem;
    if (P.n_windows > 0)
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
    float z[4];
    box_muller(philox(t, kNormal, 0, kWord3, k0, k1), QQ, z);
    const float mu_dt = P.mu * dt;
    const float drain_by = dt + kWakeEps;
    float offered = 0.f, dropped = 0.f, served = 0.f, b_old = 0.f, b_new_sum = 0.f;
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      const float lq_q = q < nq ? lq : 0.0f;
      const bool drain_now = occ[q] && drain_q[q] <= drain_by;
      const float mu_a = lq_q * dt;
      const float zq = drain_now ? 0.0f : z[q];
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
      if (q < nq && !occ[q]) vac[q] = vac[q] + dt;
      backlog[q] = b_new;
    }
    const float lat_area = 0.5f * (b_old + b_new_sum) * dt;

    // 4. the stall process at the boundary
    if (stall_on && next_stall <= t_new) {
      const Words st = philox(t, kStall, 0, kWord3, k0, k1);
      const float w_end = next_stall + P.stall_mean * expo(u01(st.w[0]));
      stall_end = fmaxf(stall_end, w_end);
      next_stall = next_stall + expo(u01(st.w[1])) * P.inv_stall;
    }

    // 5. wakes at the boundary; an open stall window defers them
    bool woken[MM];
    bool any_woken = false;
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      const bool sleeping = i < m && attached[i] < 0;
      if (sleeping) sleep_rem[i] = sleep_rem[i] - dt;
      woken[i] = sleeping && sleep_rem[i] <= kWakeEps;
      any_woken |= woken[i];
    }
    if (stall_on && any_woken && t_new < stall_end) {
      const Words jit = philox(t, kStall, 1, kWord3, k0, k1);
#pragma unroll
      for (int i = 0; i < MM; ++i) {
        if (woken[i]) {
          woken[i] = false;
          sleep_rem[i] = (stall_end - t_new) + u01(jit.w[i]);
        }
      }
    }
    float n_wake = 0.f;
#pragma unroll
    for (int i = 0; i < MM; ++i) n_wake = n_wake + (woken[i] ? 1.0f : 0.0f);

    // overshoot draws, made on the first re-arm of the step
    float over[MM];
    bool have_over = false;

    // 6. queues drained out release their thread (fresh T_S sleep)
    bool q_done[QQ];
#pragma unroll
    for (int q = 0; q < QQ; ++q) q_done[q] = occ[q] && backlog[q] <= kRelease;
    float tsa = 0.f;
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      bool done = false;
#pragma unroll
      for (int q = 0; q < QQ; ++q) done |= attached[i] == q && q_done[q];
      if (done) {
        if (!have_over) {
          overshoot<MM>(t, m, k0, k1, P, over);
          have_over = true;
        }
        tsa = tsa + 1.0f;
        sleep_rem[i] = ts1 + over[i];
        attached[i] = -1;
      }
    }
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      if (q_done[q]) occ[q] = false;
    }

    // 7. claims, threads in index order
    float busy = 0.f, cyc = 0.f, vacs = 0.f, nvs = 0.f;
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      if (!woken[i]) continue;
      int qi = -1, eqi = -1;
      float best = 0.f;
#pragma unroll
      for (int q = 0; q < QQ; ++q) {
        const bool free_q = q < nq && !occ[q];
        if (free_q && eqi < 0) eqi = q;
        if (free_q && backlog[q] >= 1.0f && (qi < 0 || backlog[q] > best)) {
          qi = q;
          best = backlog[q];
        }
      }
      if (qi >= 0) {
#pragma unroll
        for (int q = 0; q < QQ; ++q) {
          if (q == qi) {
            vacs = vacs + vac[q];
            nvs = nvs + backlog[q];
            vac[q] = 0.0f;
            occ[q] = true;
          }
        }
        cyc = cyc + 1.0f;
        attached[i] = qi;
      } else {
        if (!have_over) {
          overshoot<MM>(t, m, k0, k1, P, over);
          have_over = true;
        }
        if (eqi >= 0) {
#pragma unroll
          for (int q = 0; q < QQ; ++q) {
            if (q == eqi) {
              vacs = vacs + vac[q];
              vac[q] = 0.0f;
            }
          }
          cyc = cyc + 1.0f;
          tsa = tsa + 1.0f;
          sleep_rem[i] = sleep_rem[i] + (ts1 + over[i]);
        } else {
          busy = busy + 1.0f;
          sleep_rem[i] = sleep_rem[i] + (tl1 + over[i]);
        }
      }
    }

    rem = rem - dt;
    const float awake = n_wake * P.wake_cost + served * P.inv_mu;
    const float energy = P.active_power * awake + tsa * e_arm_s + busy * e_arm_l;
    const float step[kNumSums] = {offered, dropped, served, n_wake, busy, cyc, awake,
                                  lat_area, vacs, nvs, tsa, energy, 1.0f,
                                  forced ? 1.0f : 0.0f};
#pragma unroll
    for (int k = 0; k < kNumSums; ++k) s[k] = s[k] + step[k];

    if (P.n_windows > 0) {
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
cudaError_t launch(const void* const* in, void* sums, void* win, void* ends, const Params& P,
                   cudaStream_t st) {
  const int blocks = (P.n_points + kThreads - 1) / kThreads;
  adaptive_sweep_kernel<MM, QQ><<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
      static_cast<const int*>(in[2]), static_cast<const int*>(in[3]),
      static_cast<const float*>(in[4]), static_cast<const int*>(in[5]),
      static_cast<const int*>(in[6]), static_cast<const float*>(in[7]),
      static_cast<const float*>(in[8]), static_cast<float*>(sums), static_cast<float*>(win),
      static_cast<float*>(ends), P);
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
  const void* in[9] = {t_s, t_l, m, nq, lam, seed_lo, seed_hi, sched_edges, sched_scales};
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
