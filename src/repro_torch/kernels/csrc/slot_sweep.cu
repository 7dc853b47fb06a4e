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
// jitter).  The generator is counter-based, so a draw is made only in the
// slot and lane where it is used (a thread's overshoot when it re-arms, a
// tail's length when it hits, a stall's length when one opens): the values
// are those of the contract whether or not the others are drawn.
//
// Design (a simple kernel that is right; PERF.md holds its times):
//  1. One thread a grid point, time in series inside the thread, the whole
//     state (sleep timers, owners, backlogs, vacation timers, residuals,
//     stall end, the twelve sums and the open window's five) in registers:
//     M_MAX and Q_MAX are template parameters and every array index is a
//     compile-time constant after unrolling.  Two builds: <4, 1> for
//     one-queue grids and <4, 4> for the rest.  Lanes past a point's m or
//     n_queues are masked at run time and add exact zeros, so a point's
//     result does not depend on the build; its time does: on an H100,
//     <4, 4> takes 1.54x as long as <4, 1> on sweep_frontier's one-queue
//     grid (chip_smoke.py's phase 3 repeats that A/B).
//  2. Blocks of 32 threads, so a sweep of ~2000 points spreads over ~63 SMs.
//     That fills under 1% of the card's resident threads: the latency of one
//     thread's dependent chain, not a throughput limit, sets the time.
//  3. Which noise families are on is a run-time branch, uniform over the
//     grid, not a template, so the instantiations stay at 2.
//  4. The schedule lookup is a segment pointer that only moves forward
//     (searchsorted(side="right") - 1, clipped, for a time that only grows).
//  5. A window's sums stay in registers and are written when the window
//     index changes: no atomics, the float32 order of win_acc.at[w].add.
//  6. The loop runs while float(t) * slot_us < duration, the reference's
//     own float32 product, so no slot past the run is padded in.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
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
  int n_points, n_slots, n_seg, n_windows, n_win_pad;
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
      // one argument reduction for both (the values of cosf and sinf; two
      // calls keep two copies of the reduction's rarely taken long path,
      // whose registers spilled in the <4, 1> build)
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

template <int MM, int QQ>
__global__ void __launch_bounds__(kThreads)
    slot_sweep_kernel(const float* __restrict__ t_s_, const float* __restrict__ t_l_,
                      const int* __restrict__ m_, const int* __restrict__ nq_,
                      const float* __restrict__ lam_, const int* __restrict__ seed_lo,
                      const int* __restrict__ seed_hi, const float* __restrict__ sched_edges,
                      const float* __restrict__ sched_scales, float* __restrict__ stats,
                      float* __restrict__ win, float* __restrict__ backlog_out, const Params P) {
  const int pt = blockIdx.x * blockDim.x + threadIdx.x;
  if (pt >= P.n_points) return;
  const float t_s = t_s_[pt], t_l = t_l_[pt];
  const int m = m_[pt], nq = nq_[pt];
  const uint32_t k0 = (uint32_t)seed_lo[pt], k1 = (uint32_t)seed_hi[pt];
  const float dt = P.dt;
  const float lam_q = lam_[pt] / (float)nq;
  const float e_arm_s = arm_cost(t_s, P), e_arm_l = arm_cost(t_l, P);
  const float ts_sleep = t_s * P.one_plus_slope, tl_sleep = t_l * P.one_plus_slope;

  float sleep_rem[MM];
  int attached[MM];
  {
    const Words w0 = philox(0, kInit, 0, 0, k0, k1);
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      sleep_rem[i] = i < m ? fmaxf(u01(w0.w[i]) * t_s, dt) : INFINITY;
      attached[i] = -1;
    }
  }
  float backlog[QQ], vac[QQ], res[QQ];
#pragma unroll
  for (int q = 0; q < QQ; ++q) backlog[q] = vac[q] = res[q] = 0.0f;
  float stall_end = -1.0f;
  float s_off = 0.f, s_drop = 0.f, s_serv = 0.f, s_wake = 0.f, s_busy = 0.f, s_cyc = 0.f;
  float s_awake = 0.f, s_lat = 0.f, s_vac = 0.f, s_nv = 0.f, s_ts = 0.f, s_en = 0.f;

  const float* edges = sched_edges + (size_t)pt * P.n_seg;
  const float* scales = sched_scales + (size_t)pt * P.n_seg;
  int seg = 0;
  float* wout = win + (size_t)pt * P.n_windows * 5;
  int cur_w = 0;
  float wacc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};

  for (int t = 0; t < P.n_slots; ++t) {
    const float now = (float)t * dt;
    if (!(now < P.duration)) break;

    if (P.flags & kStallOn) {
      const Words st = philox(t, kStall, 0, 0, k0, k1);
      if (u01(st.w[0]) < P.stall_p) {
        const float end = now + P.stall_mean * expo(u01(st.w[1]));
        stall_end = fmaxf(stall_end, end);
      }
    }

    // 1. arrivals
    float scale = 1.0f;
    if (P.n_seg > 0) {
      while (seg + 1 < P.n_seg && edges[seg + 1] <= now) ++seg;
      scale = scales[seg];
    }
    float z[4];
    box_muller(philox(t, kNormal, 0, 0, k0, k1), QQ, z);
    float offered = 0.f, dropped = 0.f;
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      const float lq = q < nq ? lam_q : 0.0f;
      const float mu_a = P.n_seg > 0 ? lq * scale * dt : lq * dt;
      const float raw = res[q] + mu_a + sqrtf(mu_a) * z[q];
      const float a = fmaxf(raw, 0.0f);
      res[q] = fminf(raw, 0.0f);
      const float adm = fminf(a, fmaxf(P.capacity - backlog[q], 0.0f));
      backlog[q] = backlog[q] + adm;
      offered = q ? offered + a : a;
      dropped = q ? dropped + (a - adm) : a - adm;
    }

    // 2. countdown + wake; stall windows defer expiring timers
    bool woken[MM];
    bool any_woken = false;
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      const bool sleeping = i < m && attached[i] < 0;
      if (sleeping) sleep_rem[i] = sleep_rem[i] - dt;
      woken[i] = sleeping && sleep_rem[i] <= 0.0f;
      any_woken |= woken[i];
    }
    if ((P.flags & kStallOn) && any_woken && now < stall_end) {
      const Words jit = philox(t, kStall, 1, 0, k0, k1);
#pragma unroll
      for (int i = 0; i < MM; ++i) {
        if (woken[i]) {
          woken[i] = false;
          sleep_rem[i] = stall_end - now + u01(jit.w[i]);
        }
      }
    }
    float n_wake = 0.f;
#pragma unroll
    for (int i = 0; i < MM; ++i) n_wake = n_wake + (woken[i] ? 1.0f : 0.0f);

    // overshoot draws, made on the first re-arm of the slot
    float over[MM];
    bool have_over = false;

    bool occ[QQ];
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      occ[q] = false;
#pragma unroll
      for (int i = 0; i < MM; ++i) occ[q] |= attached[i] == q;
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
          sleep_rem[i] = sleep_rem[i] + (ts_sleep + over[i]);
        } else {
          busy = busy + 1.0f;
          sleep_rem[i] = sleep_rem[i] + (tl_sleep + over[i]);
        }
      }
    }

    // 3. owned queues drain at mu; 4. emptied queues release their thread
    float served = 0.f;
    bool q_done[QQ];
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      const float s = occ[q] ? fminf(backlog[q], P.mu_dt) : 0.0f;
      backlog[q] = backlog[q] - s;
      served = q ? served + s : s;
      q_done[q] = occ[q] && backlog[q] <= 1e-6f;
    }
    float n_done = 0.f;
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
        n_done = n_done + 1.0f;
        sleep_rem[i] = ts_sleep + over[i];
        attached[i] = -1;
      }
    }
    tsa = tsa + n_done;

    // 5. vacations tick on free queues; 6. Little integral; energy
    float bsum = 0.f;
#pragma unroll
    for (int q = 0; q < QQ; ++q) {
      if (q_done[q]) occ[q] = false;
      if (q < nq && !occ[q]) vac[q] = vac[q] + dt;
      bsum = q ? bsum + backlog[q] : backlog[q];
    }
    const float lat_area = bsum * dt;
    const float awake = n_wake * P.wake_cost + served / P.mu;
    const float energy = P.active_power * awake + tsa * e_arm_s + busy * e_arm_l;

    s_off = s_off + offered;
    s_drop = s_drop + dropped;
    s_serv = s_serv + served;
    s_wake = s_wake + n_wake;
    s_busy = s_busy + busy;
    s_cyc = s_cyc + cyc;
    s_awake = s_awake + awake;
    s_lat = s_lat + lat_area;
    s_vac = s_vac + vacs;
    s_nv = s_nv + nvs;
    s_ts = s_ts + tsa;
    s_en = s_en + energy;

    if (P.n_windows > 0) {
      const int w = min((int)(now / P.window_us), P.n_win_pad - 1);
      if (w != cur_w) {
        for (int j = cur_w; j < min(w, P.n_windows); ++j) {
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

template <int MM, int QQ>
cudaError_t launch(const void* const* in, void* stats, void* win, void* backlog,
                   const Params& P, cudaStream_t st) {
  const int blocks = (P.n_points + kThreads - 1) / kThreads;
  slot_sweep_kernel<MM, QQ><<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
      static_cast<const int*>(in[2]), static_cast<const int*>(in[3]),
      static_cast<const float*>(in[4]), static_cast<const int*>(in[5]),
      static_cast<const int*>(in[6]), static_cast<const float*>(in[7]),
      static_cast<const float*>(in[8]), static_cast<float*>(stats), static_cast<float*>(win),
      static_cast<float*>(backlog), P);
  return cudaGetLastError();
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
  P.n_slots = n_slots;
  P.n_seg = n_seg;
  P.n_windows = n_windows;
  P.n_win_pad = n_win_pad;
  const void* in[9] = {t_s, t_l, m, nq, lam, seed_lo, seed_hi, sched_edges, sched_scales};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  build[0] = 4;
  build[1] = q_max == 1 ? 1 : 4;
  return (int)(q_max == 1 ? launch<4, 1>(in, stats, win, backlog, P, st)
                          : launch<4, 4>(in, stats, win, backlog, P, st));
}

const char* slot_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
