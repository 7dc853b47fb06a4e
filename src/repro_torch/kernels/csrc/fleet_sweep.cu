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
//                  (csrc/slot_sweep.cu's state machine, in its one-thread
//                  form: one thread a host, draws inline) at its share of
//                  the rate;
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
// seed + h.  A draw is made only where it is used (as in S1).
//
// Design (a simple kernel that is right; PERF.md holds its times):
//  1. One block a point, max(W, 32) threads.  A point's hosts meet every slot
//     (the balancer reads all backlogs, the link all admissions, the hedge all
//     backlogs), so they share a block and meet in shared memory and warp
//     shuffles, not through device memory.  Thread j < W runs hosts j, j + W,
//     ...; with H <= 256 that is one host, whose whole state stays in
//     registers across slots.  Beyond 256 hosts a thread keeps its hosts'
//     states in a global scratch (point, word, host), coalesced across the
//     block, and loads and stores one host at a time.  Any H >= 1 runs.
//  2. Each slot: the balancer's max and sum (least-loaded only), the host
//     step, one reduction for the far rack's admissions and b1 (topology /
//     hedging on), one for the duplicates landing on b1 and b2 (hedging on),
//     then each host's topology and injection.  A reduction is warp shuffles
//     plus, above 32 lanes, one round through shared memory: 2
//     __syncthreads.
//  3. The time is one block's chain of slots: the fleet grids of the repo have
//     4-8 points, so 4-8 of 132 SMs work; the card's throughput is no limit.
//  4. M_MAX and Q_MAX are template parameters (<4, 1> and <4, 4>, as S1's);
//     lanes past a point's m or n_queues add exact zeros.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLanes = 256;
constexpr int kMaxWarps = kMaxLanes / 32;
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
  int n_points, n_hosts, n_slots, n_seg, lb, stale_every, far_count;
  int lanes, hosts_per_lane;
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

// ---- block reductions over the W lanes of a point's hosts -------------------
// The order of a sum: within each warp a halving tree over its min(W, 32)
// lanes (lane l adds lane l + off, off = L/2 .. 1), then the same tree over
// the W / 32 warps' sums.  Lanes >= W hold the identity.  Every thread gets
// the result.  Argmins keep the lowest host index among equal values.

struct Red {
  float sum;
  float v;   // argmin value
  int i;     // argmin index
  float mx;
};

struct RedShared {
  float sum[kMaxWarps], v[kMaxWarps], mx[kMaxWarps];
  int i[kMaxWarps];
  Red out;
};

__device__ __forceinline__ void combine(Red& a, float sum, float v, int i, float mx) {
  a.sum = a.sum + sum;
  if (v < a.v || (v == a.v && i < a.i)) {
    a.v = v;
    a.i = i;
  }
  a.mx = fmaxf(a.mx, mx);
}

__device__ __forceinline__ void warp_tree(Red& a, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    const float s = __shfl_down_sync(kFull, a.sum, off);
    const float v = __shfl_down_sync(kFull, a.v, off);
    const int i = __shfl_down_sync(kFull, a.i, off);
    const float mx = __shfl_down_sync(kFull, a.mx, off);
    combine(a, s, v, i, mx);
  }
}

__device__ Red block_reduce(Red a, int W, RedShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (W <= 32) {
    warp_tree(a, W);
    Red r;
    r.sum = __shfl_sync(kFull, a.sum, 0);
    r.v = __shfl_sync(kFull, a.v, 0);
    r.i = __shfl_sync(kFull, a.i, 0);
    r.mx = __shfl_sync(kFull, a.mx, 0);
    return r;
  }
  warp_tree(a, 32);
  if (lane == 0) {
    sh.sum[warp] = a.sum;
    sh.v[warp] = a.v;
    sh.i[warp] = a.i;
    sh.mx[warp] = a.mx;
  }
  __syncthreads();
  if (warp == 0) {
    const int G = W >> 5;
    Red b;
    b.sum = lane < G ? sh.sum[lane] : 0.0f;
    b.v = lane < G ? sh.v[lane] : INFINITY;
    b.i = lane < G ? sh.i[lane] : 0x7fffffff;
    b.mx = lane < G ? sh.mx[lane] : -INFINITY;
    warp_tree(b, G);
    if (lane == 0) sh.out = b;
  }
  __syncthreads();
  return sh.out;
}

__device__ __forceinline__ Red red_identity() {
  Red r;
  r.sum = 0.0f;
  r.v = INFINITY;
  r.i = 0x7fffffff;
  r.mx = -INFINITY;
  return r;
}

// ---- the single-host slot body (S1's, one thread a host) --------------------
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

// this slot's duplicates of a host (hedging on)
__device__ __forceinline__ float duplicates(float adm, float btot, float hedge_d,
                                            float hedge_den, const Params& P) {
  const float xg = (btot * P.inv_mu - hedge_d) / hedge_den;
  return adm * (1.0f / (1.0f + expf(-xg)));
}

template <int MM, int QQ>
__global__ void __launch_bounds__(kMaxLanes)
    fleet_sweep_kernel(const float* __restrict__ t_s_, const float* __restrict__ t_l_,
                       const int* __restrict__ m_, const int* __restrict__ nq_,
                       const float* __restrict__ lam_, const int* __restrict__ seed_lo,
                       const int* __restrict__ seed_hi, const float* __restrict__ hedge_,
                       const float* __restrict__ sched_edges,
                       const float* __restrict__ sched_scales, const float* __restrict__ shares,
                       float* __restrict__ stats, float* __restrict__ scratch, const Params P) {
  __shared__ RedShared sh;
  const int pt = blockIdx.x;
  const int lane = threadIdx.x;
  const int W = P.lanes, H = P.n_hosts, K = P.hosts_per_lane;
  const bool active = lane < W;
  const float t_s = t_s_[pt], t_l = t_l_[pt], lam = lam_[pt], hedge_d = hedge_[pt];
  const int m = m_[pt], nq = nq_[pt];
  const uint32_t lo = (uint32_t)seed_lo[pt], hi = (uint32_t)seed_hi[pt];
  const float dt = P.dt;
  const float e_arm_s = arm_cost(t_s, P), e_arm_l = arm_cost(t_l, P);
  const float ts_sleep = t_s * P.one_plus_slope, tl_sleep = t_l * P.one_plus_slope;
  const bool hedged = hedge_d > 0.0f;
  const float hedge_den = 0.25f * hedge_d + P.hedge_eps;
  const float q_share = 1.0f / (float)nq;
  const bool topo = P.flags & kTopo, link = P.flags & kLink;
  float* my = scratch + (size_t)pt * host_words<MM, QQ>() * H;

  Host<MM, QQ> x;
  for (int k = 0; k < K; ++k) {
    const int h = lane + k * W;
    if (!active || h >= H) break;
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
    if (K > 1) store(x, my + h, H);
  }

  const float* edges = sched_edges + (size_t)pt * P.n_seg;
  const float* scales = sched_scales + (size_t)pt * P.n_seg;
  int seg = 0;

  for (int t = 0; t < P.n_slots; ++t) {
    const float now = (float)t * dt;
    if (!(now < P.duration)) break;
    float scale = 1.0f;
    if (P.n_seg > 0) {
      while (seg + 1 < P.n_seg && edges[seg + 1] <= now) ++seg;
      scale = scales[seg];
    }

    // 0. least-loaded: refresh the snapshot, then the softmax's max and sum
    float mx = 0.0f, den = 1.0f;
    if (P.lb == 2) {
      const bool refresh = t % P.stale_every == 0;
      Red a = red_identity();
      for (int k = 0; k < K; ++k) {
        const int h = lane + k * W;
        if (!active || h >= H) break;
        if (K > 1) load(x, my + h, H);
        if (refresh) {
          float b = 0.f;
#pragma unroll
          for (int q = 0; q < QQ; ++q) b = q ? b + x.back[q] : x.back[q];
          x.stale = b;
          if (K > 1) store(x, my + h, H);
        }
        a.mx = fmaxf(a.mx, -x.stale * P.inv_soft);
      }
      mx = block_reduce(a, W, sh).mx;
      a = red_identity();
      for (int k = 0; k < K; ++k) {
        const int h = lane + k * W;
        if (!active || h >= H) break;
        if (K > 1) load(x, my + h, H);
        const float e = expf(-x.stale * P.inv_soft - mx);
        a.sum = k ? a.sum + e : e;
      }
      den = block_reduce(a, W, sh).sum;
    }

    // 1. the host step, its duplicates (hedging on), and each lane's part
    // of the far rack's admissions and of b1
    Red a = red_identity();
    for (int k = 0; k < K; ++k) {
      const int h = lane + k * W;
      if (!active || h >= H) break;
      if (K > 1) load(x, my + h, H);
      const float share = P.lb == 2 ? expf(-x.stale * P.inv_soft - mx) / den : shares[h];
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
      if (K > 1) store(x, my + h, H);
    }
    if (!(topo || hedged)) continue;
    const Red r1 = block_reduce(a, W, sh);
    const int b1 = r1.i;
    float gap = 1.0f;
    if (link) gap = fmaxf(P.link_rate - r1.sum * P.inv_dt, P.link_floor);

    // 2. hedging: the duplicates, split over the sender's queues, that land
    // on b1 (every host's but b1's) and b2, the first least-loaded host
    // other than b1
    float to_b1 = 0.0f, to_b2 = 0.0f;
    int b2 = b1;
    if (hedged) {
      Red c = red_identity();
      for (int k = 0; k < K; ++k) {
        const int h = lane + k * W;
        if (!active || h >= H) break;
        if (K > 1) load(x, my + h, H);
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
      const Red r2 = block_reduce(c, W, sh);
      if (H == 1) {
        to_b1 = r2.mx;   // a lone host's duplicates come back to it
      } else {
        to_b1 = r2.sum;
        to_b2 = r2.mx;
        b2 = r2.i;
      }
    }

    // 3. each host's network delay and injection
    for (int k = 0; k < K; ++k) {
      const int h = lane + k * W;
      if (!active || h >= H) break;
      if (K > 1) load(x, my + h, H);
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
      if (K > 1) store(x, my + h, H);
    }
  }

  for (int k = 0; k < K; ++k) {
    const int h = lane + k * W;
    if (!active || h >= H) break;
    if (K > 1) load(x, my + h, H);
#pragma unroll
    for (int s = 0; s < kNumStats; ++s)
      stats[((size_t)s * P.n_points + pt) * H + h] = x.s[s];
  }
}

int lanes_for(int n_hosts) {
  int w = 1;
  while (w < n_hosts && w < kMaxLanes) w *= 2;
  return w;
}

template <int MM, int QQ>
cudaError_t launch(const void* const* in, void* stats, void* scratch, const Params& P,
                   cudaStream_t st) {
  const int threads = P.lanes < 32 ? 32 : P.lanes;
  fleet_sweep_kernel<MM, QQ><<<P.n_points, threads, 0, st>>>(
      static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
      static_cast<const int*>(in[2]), static_cast<const int*>(in[3]),
      static_cast<const float*>(in[4]), static_cast<const int*>(in[5]),
      static_cast<const int*>(in[6]), static_cast<const float*>(in[7]),
      static_cast<const float*>(in[8]), static_cast<const float*>(in[9]),
      static_cast<const float*>(in[10]), static_cast<float*>(stats),
      static_cast<float*>(scratch), P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch layout of a point of n_hosts hosts with up to q_max queues: out[0]
// threads a block, out[1] lanes of the host reductions, out[2] hosts a lane,
// out[3] float32 words of scratch a host (0 when a lane holds one host).
void fleet_sweep_layout(int n_hosts, int q_max, int* out) {
  const int w = lanes_for(n_hosts);
  const int k = (n_hosts + w - 1) / w;
  out[0] = w < 32 ? 32 : w;
  out[1] = w;
  out[2] = k;
  out[3] = k > 1 ? (q_max == 1 ? host_words<4, 1>() : host_words<4, 4>()) : 0;
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
// transition_uj, min_residency_us), shallow to deep.  build (host, 2 ints
// out): the (M_MAX, Q_MAX) instantiation launched.  Returns a cudaError_t (0
// on success); the launch is asynchronous on `stream`.
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
  P.n_slots = n_slots;
  P.n_seg = n_seg;
  P.lb = lb;
  P.stale_every = stale_every;
  P.far_count = far_count;
  P.lanes = lanes_for(n_hosts);
  P.hosts_per_lane = (n_hosts + P.lanes - 1) / P.lanes;
  const void* in[11] = {t_s,    t_l,     m,           nq,           lam,   seed_lo,
                        seed_hi, hedge_d, sched_edges, sched_scales, shares};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  build[0] = 4;
  build[1] = q_max == 1 ? 1 : 4;
  return (int)(q_max == 1 ? launch<4, 1>(in, stats, scratch, P, st)
                          : launch<4, 4>(in, stats, scratch, P, st));
}

const char* fleet_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
