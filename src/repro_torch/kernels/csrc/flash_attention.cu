// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// function flash_attention_pallas (body _flash_kernel): blocked
// online-softmax attention with GQA, causal and local-window masks, a tanh
// logit softcap and f32 accumulation whatever the input type.
//
// Layout: q (B,S,H,hd), k and v (B,T,KV,hd), out (B,S,H,hd), all contiguous
// (the model's layout; no transposes).  q head h reads kv head h / (H/KV).
//
// What bounds it on this card: at the serving shapes (gemma-2b prefill:
// H=8, KV=1, hd=256, S=T up to 1024, causal) the work is 4*S*T/2*hd*H
// FLOPs over ~(2*S*H + 2*T*KV)*hd*2 bytes, about 450 FLOPs per byte, above
// the H100's ~295 bf16 FLOPs/byte ridge: the bound is operations, on the
// tensor cores.  bf16 has two kernels, f32 one:
//
// * bf16, flash_fwd_wgmma_bf16 (the serving path at hd 64 and 256, and at
//   hd 128 below PP_MIN_S rows).  Both products run on
//   the tensor cores with wgmma (bf16 operands, f32 accumulators), fed by
//   TMA.  One block per (64 q rows, head, batch): one consumer warpgroup
//   (128 threads) owns the 64 rows, one producer warp issues the TMA loads.
//   Q's tile is loaded once; K and V tiles of 64 keys sit in a 2-stage ring
//   with full/empty mbarriers, so the next tile's copy overlaps this
//   tile's math.  Shared memory holds bf16 only, in TMA's 128-byte swizzle,
//   which is the layout wgmma reads: S = Q K^T is m64n64k16 with both
//   operands K-major from shared memory; P goes to bf16 in registers (the
//   S accumulator fragment is the A fragment of the next product, no
//   shuffles) and O += P V is m64n64k16 per 64 columns of hd, with V read
//   MN-major through the transpose bit.  Scale, softcap, mask and the
//   online softmax run on the accumulator fragment; a row lives in the 4
//   lanes of a quad.  Only tiles that straddle the causal diagonal, the
//   window edge or T are masked; tiles wholly outside the visible range
//   are never loaded.  Under causal the q tiles run longest-first.  TMA
//   zero-fills rows past S and T (ragged edges need no padding).  The one
//   rounding the Pallas kernel does not make is P -> bf16 before P V.
// * bf16 at hd 128 from PP_MIN_S rows on, flash_fwd_pingpong_bf16
//   (FlashAttention-3's layout).  At hd 128 a 64x64 tile's softmax (ex2
//   at 16 an SM a clock) costs about as much as its two products, and the
//   kernel above runs them one after the other.  Here three warpgroups
//   share a block: a producer (its registers handed to the consumers by
//   setmaxnreg) and two consumers of 64 q rows each, with S = Q K^T and
//   O += P V as m64n128k16 over 128-key tiles.  Each consumer issues tile
//   n's q k^T and tile n - 1's P V together and runs tile n's softmax
//   while P V is on the tensor cores; the two take turns to issue (named
//   barriers), so one's products overlap the other's softmax.  One block
//   an SM, persistent: it walks 128-row work items, the longest causal
//   ones of every head and batch row first, dealt to the blocks in a
//   snake, with Q in two slots and the K/V ring running on across items,
//   so an item's loads overlap the one before (at 197 KB of shared memory
//   a second block cannot share the SM).  The arithmetic is the kernel
//   above's, with the scale folded into the exponent: p = 2^(s sl - m sl).
// * f32, flash_fwd_mma_f32 (route "mma").  One TF32 pass keeps ~3 decimal
//   digits and would miss the reference's 2e-5; the split of
//   csrc/ssd_scan.cu does not: each f32 operand is v = hi + lo (hi rounded
//   to TF32), and each product hi.hi + hi.lo + lo.hi on mma.sync m16n8k8
//   with f32 accumulators.  The tensor cores truncate as they accumulate,
//   so the passes go into short sums from zero that are added in f32: every
//   16-deep step of hd in S = Q K^T, every tile's keys in O += P V.  3 x
//   4.29 GFLOP at gemma-2b S=1024 is 26 us at the 495 TFLOP/s TF32 peak,
//   against 64 us for f32 on the CUDA cores.  One block per 32 q rows
//   (under causal a pair, tiles n - 1 - x and x, so every block has the
//   same work and 128 blocks fill the card at S=1024), 8 warps: each
//   16-row group is 4 warps, warp r computing S for a quarter of each K/V
//   tile's keys and O for a quarter of hd's columns, so O takes 32 (hd 256)
//   registers a thread.  The group's row maxima meet in shared memory (one
//   m a row), and P goes through shared memory once, split into (hi, lo)
//   pairs; Q is split once per q tile.  K and V tiles of 64 keys arrive by
//   cp.async into one buffer each, in turn: the next K while this tile's
//   softmax and P V run, the next V while its S runs (at hd 256 a 2-stage
//   ring of both would need 32-key tiles, and those were 7% slower); rows
//   past S and T are zero-filled.  Rows are padded (HD + 4 words) so that
//   the fragment reads are free of bank conflicts; V's rows are read in the
//   order 2t, 2t + 1, as P's pairs hold them.  Scale, softcap, mask and the
//   online softmax (natural units, as the reference) run on the
//   fragments.  wgmma is not used: TF32 wgmma reads B only K-major from
//   shared memory, so P V would need V transposed and split.
//
// All keep the two guards of the TPU kernel: p = 0 where masked (a fully
// masked tile has m_prev = m_new = NEG_INF, so exp(0) = 1 would leak in)
// and l == 0 -> 1 in the final divide (fully masked rows give 0).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv rows per iteration
constexpr float NEG_INF = -2.3819763e38f;  // bf16-safe large negative, as in the reference

// ---------------------------------------------------------------------------
// f32: split TF32 on mma.sync
// ---------------------------------------------------------------------------

constexpr int MQ = 32;             // q rows a tile: two 16-row groups
constexpr int MMA_W = 4;           // warps a row group
constexpr int MMA_THREADS = 64 * MMA_W;

// Per head dim: keys a K/V tile; keys a warp takes of a tile for S, and
// its n-tiles; O's n-tiles a warp owns (2 to 8); the row stride of the K
// and V tiles in words and of Q's (hi, lo) pairs in pairs (HD + 4 is 4 mod
// 32 and mod 16: the fragment reads [row g][k t] of Q and K and [key
// 2t][col g] of V put the 32 lanes on 32 banks), and of P's pairs (BKT + 8:
// 8 mod 16, so that the 16-byte reads and writes of rows g and g + 1 land
// on distinct banks).
template <int HD>
struct MmaTile {
  static constexpr int BKT = 64;
  static constexpr int KW = BKT / MMA_W;
  static constexpr int NTS = KW / 8;
  static constexpr int NTC = HD / 8 / MMA_W;
  static constexpr int RS = HD + 4;
  static constexpr int PS = BKT + 8;
  // Q's pairs, a K tile and a V tile, P's pairs of both row groups, the row
  // maxima (then sums) of each warp
  static constexpr size_t BYTES = 8 * (size_t)MQ * RS + 4 * (size_t)RS * 2 * BKT +
                                  8 * (size_t)MQ * PS + 4 * (size_t)MQ * MMA_W;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid (src is then
// not read, but stays a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The 32 x MMA_W threads of row group rg (ids 1, 2; 0 is __syncthreads).
__device__ __forceinline__ void row_group_sync(int rg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + rg), "n"(32 * MMA_W) : "memory");
}

// Rows [row0, row0 + ROWS) of a (rows, HD) f32 slice with the given row
// stride (elements) -> shared memory with row stride RS; rows at or past
// n_rows are zero (a row past T must not bring a NaN into P V).
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* sm, const float* g, long row_stride, int row0,
                                          int n_rows) {
  constexpr int CPR = HD / 4, RS = MmaTile<HD>::RS;
  for (int i = threadIdx.x; i < ROWS * CPR; i += MMA_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 4;
    const bool ok = row0 + r < n_rows;
    cp_async16(sm + r * RS + c, g + (long)(ok ? row0 + r : 0) * row_stride + c, ok);
  }
}

// v = hi + lo.  hi is v rounded to nearest (ties away) onto TF32's 10
// mantissa bits, as cvt.rna.tf32 gives it, in two integer operations (v is
// finite); lo = v - hi is exact in f32 and goes to the tensor cores as it
// is: they read its top 10 mantissa bits, and the bits they drop are below
// 2^-21 of v.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// Rows [row0, row0 + MQ) of q (row stride in elements) -> shared memory as
// (hi, lo) pairs with row stride RS pairs; rows at or past n_rows are zero.
template <int HD>
__device__ __forceinline__ void load_q_split(uint2* sm, const float* g, long row_stride,
                                             int row0, int n_rows) {
  constexpr int CPR = HD / 4, RS = MmaTile<HD>::RS;
  for (int i = threadIdx.x; i < MQ * CPR; i += MMA_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      x = *reinterpret_cast<const float4*>(g + (long)(row0 + r) * row_stride + c);
    uint4 a, b;
    split(x.x, a.x, a.y);
    split(x.y, a.z, a.w);
    split(x.z, b.x, b.y);
    split(x.w, b.z, b.w);
    *reinterpret_cast<uint4*>(sm + r * RS + c) = a;
    *reinterpret_cast<uint4*>(sm + r * RS + c + 2) = b;
  }
}

// d (16x8 f32) += a (16x8 tf32, row) b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[e] += a b[e] for NT n-tiles of one 8-deep step, as split TF32: the
// three passes (hi.lo, lo.hi, then hi.hi; lo.lo, below 2^-22 of the
// product, is dropped) run pass by pass over the n-tiles, so that
// consecutive mma.sync are independent.  The tensor cores truncate as they
// accumulate, so d holds a short sum that starts from zero (16 deep in S,
// one tile's keys in P V) and the caller adds it to its running sum in f32.
template <int NT>
__device__ __forceinline__ void mma_passes(float (&d)[NT][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[NT][2],
                                           const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int e = 0; e < NT; ++e) mma_tf32(d[e], ah, bl[e][0], bl[e][1]);
#pragma unroll
  for (int e = 0; e < NT; ++e) mma_tf32(d[e], al, bh[e][0], bh[e][1]);
#pragma unroll
  for (int e = 0; e < NT; ++e) mma_tf32(d[e], ah, bh[e][0], bh[e][1]);
}

// One block: one q tile of MQ rows of one (head, batch), or under causal a
// pair of them, tiles n_qt - 1 - x and x, whose visible key ranges add up to
// the same length in every block.  Row group rg (16 rows) is MMA_W warps;
// its warp r computes S for the keys [r KW, (r + 1) KW) of each K/V tile and
// O for the columns [r HD / MMA_W, (r + 1) HD / MMA_W).  The group's row
// maxima meet in shared memory, so every warp of it holds the same m; its P
// goes to shared memory as (hi, lo) pairs, and each warp's l (the sum over
// its own keys, under the shared m) is added up at the end.
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S, int T_len, int H,
                  int KV, int causal, int window, float softcap, float scale, int paired) {
  using L = MmaTile<HD>;
  constexpr int BKT = L::BKT, KW = L::KW, NTS = L::NTS, NTC = L::NTC, RS = L::RS, PS = L::PS;

  extern __shared__ __align__(16) float smem[];
  uint2* qs = reinterpret_cast<uint2*>(smem);                     // [MQ][RS] (hi, lo)
  float* kt = smem + 2 * MQ * RS;                                 // [BKT][RS]
  float* vt = kt + BKT * RS;                                      // [BKT][RS]
  uint2* ps = reinterpret_cast<uint2*>(vt + BKT * RS);            // [MQ][PS] (hi, lo)
  float* red = reinterpret_cast<float*>(ps + MQ * PS);            // [2][MMA_W][16]

  const int n_qt = (S + MQ - 1) / MQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int rg = warp / MMA_W, r = warp % MMA_W;
  const long q_stride = (long)H * HD, kv_stride = (long)KV * HD;
  const float* qb = q + ((long)b * S * H + h) * HD;
  const float* kb = k + ((long)b * T_len * KV + kvh) * HD;
  const float* vb = v + ((long)b * T_len * KV + kvh) * HD;
  float* ob = o + ((long)b * S * H + h) * HD;
  const uint2* qa = qs + (16 * rg + g) * RS + t4;   // this lane's A rows g and g + 8
  uint2* pw = ps + (16 * rg + g) * PS + r * KW + 2 * t4;   // P of its S keys
  const uint2* pa = ps + (16 * rg + g) * PS + 2 * t4;      // P as P V's A operand
  float* red_g = red + rg * MMA_W * 16;
  const int c0 = r * NTC * 8;                              // first column of its O

  const int x = blockIdx.x;
  const int n_tiles = paired && 2 * x + 1 != n_qt ? 2 : 1;
  for (int tp = 0; tp < n_tiles; ++tp) {
    // the longer tile first
    const int q0 = (paired && tp == 0 ? n_qt - 1 - x : x) * MQ;
    // kv range this q tile can see; tiles outside it are wholly masked and
    // would change neither m, l nor acc, so they are not loaded
    int k_lo = 0, k_hi = T_len;
    if (causal) k_hi = min(T_len, q0 + MQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
    const int k_first = (k_lo / BKT) * BKT;
    const int n_kt = k_hi > k_first ? (k_hi - k_first + BKT - 1) / BKT : 0;
    // one K and one V buffer, loaded in turn: K of tile n + 1 while the
    // softmax and P V of tile n run, V of tile n + 1 while its S runs; each
    // load is one commit group, K0 V0 K1 V1 ...
    auto load_k = [&](int n) {
      if (n < n_kt) load_rows<HD, BKT>(kt, kb, kv_stride, k_first + n * BKT, T_len);
      cp_async_commit();
    };
    auto load_v = [&](int n) {
      if (n < n_kt) load_rows<HD, BKT>(vt, vb, kv_stride, k_first + n * BKT, T_len);
      cp_async_commit();
    };

    if (tp > 0) __syncthreads();  // every warp done with the previous tile's buffers and sums
    load_k(0);
    load_v(0);
    // Q once per q tile, split, while the first K/V tile is in flight
    load_q_split<HD>(qs, qb, q_stride, q0, S);

    float acc[NTC][4];
#pragma unroll
    for (int e = 0; e < NTC; ++e) acc[e][0] = acc[e][1] = acc[e][2] = acc[e][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};

    for (int n = 0; n < n_kt; ++n) {
      cp_async_wait<1>();  // K of tile n (V of tile n may be in flight)
      __syncthreads();     // ... landed for all, and Q
      const int kt0 = k_first + n * BKT;

      // S = Q K^T over this warp's KW keys; the passes of each 16-deep step
      // of hd start from zero and are added to s in f32
      float s[NTS][4];
#pragma unroll
      for (int e = 0; e < NTS; ++e) s[e][0] = s[e][1] = s[e][2] = s[e][3] = 0.f;
      const float* ks = kt + (r * KW + g) * RS + t4;
#pragma unroll 4
      for (int d0 = 0; d0 < HD; d0 += 16) {
        float d[NTS][4];
#pragma unroll
        for (int e = 0; e < NTS; ++e) d[e][0] = d[e][1] = d[e][2] = d[e][3] = 0.f;
#pragma unroll
        for (int k8 = 0; k8 < 2; ++k8) {
          const int kk = d0 + 8 * k8;
          const uint2 qa0 = qa[kk], qa1 = qa[8 * RS + kk], qa2 = qa[kk + 4],
                      qa3 = qa[8 * RS + kk + 4];
          const uint32_t ah[4] = {qa0.x, qa1.x, qa2.x, qa3.x};
          const uint32_t al[4] = {qa0.y, qa1.y, qa2.y, qa3.y};
          uint32_t bh[NTS][2], bl[NTS][2];
#pragma unroll
          for (int e = 0; e < NTS; ++e) {
            split(ks[8 * e * RS + kk], bh[e][0], bl[e][0]);
            split(ks[8 * e * RS + kk + 4], bh[e][1], bl[e][1]);
          }
          mma_passes<NTS>(d, ah, al, bh, bl);
        }
#pragma unroll
        for (int e = 0; e < NTS; ++e) {
          s[e][0] += d[e][0];
          s[e][1] += d[e][1];
          s[e][2] += d[e][2];
          s[e][3] += d[e][3];
        }
      }
      __syncthreads();  // everyone done with K of tile n
      load_k(n + 1);

      // scale, softcap and mask on the fragment (element i of n-tile e: row
      // g + 8 (i >> 1), key r KW + 8 e + 2 t + (i & 1)); only tiles that
      // straddle the causal diagonal, the window edge or T are masked
      const bool full = kt0 + BKT <= T_len && (!causal || kt0 + BKT - 1 <= q0) &&
                        (window <= 0 || kt0 > q0 + MQ - 1 - window);
      const int qrow = q0 + 16 * rg + g, kcol = kt0 + r * KW + 2 * t4;
      float mx[2] = {NEG_INF, NEG_INF};
      uint32_t ok_bits = 0xffffffffu;
#pragma unroll
      for (int e = 0; e < NTS; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float xv = s[e][i] * scale;
          if (softcap != 0.f) xv = softcap * tanhf(xv / softcap);
          if (!full) {
            const int qpos = qrow + 8 * (i >> 1), kpos = kcol + 8 * e + (i & 1);
            bool ok = kpos < T_len;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (!ok) {
              xv = NEG_INF;
              ok_bits &= ~(1u << (4 * e + i));
            }
          }
          s[e][i] = xv;
          mx[i >> 1] = fmaxf(mx[i >> 1], xv);
        }
      // the row group's maxima meet: every warp of it takes the same m
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        if (t4 == 0) red_g[r * 16 + g + 8 * hh] = mx[hh];
      }
      row_group_sync(rg);
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float m_tile = red_g[g + 8 * hh];
#pragma unroll
        for (int w = 1; w < MMA_W; ++w) m_tile = fmaxf(m_tile, red_g[w * 16 + g + 8 * hh]);
        const float m_new = fmaxf(m[hh], m_tile);
        corr[hh] = expf(m[hh] - m_new);
        m[hh] = m_new;
        l[hh] *= corr[hh];
      }
      // p, this warp's share of l, and P as (hi, lo) pairs: a 16-byte store
      // holds keys 2t and 2t + 1 of a row, as P V's A fragment reads them
#pragma unroll
      for (int e = 0; e < NTS; ++e) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = expf(s[e][i] - m[i >> 1]);
          if (!full) p[i] = (ok_bits >> (4 * e + i)) & 1u ? p[i] : 0.f;
          l[i >> 1] += p[i];
        }
        uint4 a, c;
        split(p[0], a.x, a.y);
        split(p[1], a.z, a.w);
        split(p[2], c.x, c.y);
        split(p[3], c.z, c.w);
        *reinterpret_cast<uint4*>(pw + 8 * e) = a;
        *reinterpret_cast<uint4*>(pw + 8 * PS + 8 * e) = c;
      }
      cp_async_wait<1>();  // V of tile n (K of tile n + 1 may be in flight)
      __syncthreads();     // ... for all, and the row group's P
      // O = O corr + P V over this warp's NTC column tiles; the passes over
      // the tile's BKT keys start from zero and meet O in one f32 fma.  Slot
      // t of key step j is key 8 j + 2 t, slot t + 4 key 8 j + 2 t + 1, in P
      // and in V alike (the sum over keys takes any order)
      float d[NTC][4];
#pragma unroll
      for (int e = 0; e < NTC; ++e) d[e][0] = d[e][1] = d[e][2] = d[e][3] = 0.f;
#pragma unroll
      for (int j = 0; j < BKT / 8; ++j) {
        const uint4 p0 = *reinterpret_cast<const uint4*>(pa + 8 * j);
        const uint4 p1 = *reinterpret_cast<const uint4*>(pa + 8 * PS + 8 * j);
        const uint32_t ah[4] = {p0.x, p1.x, p0.z, p1.z};
        const uint32_t al[4] = {p0.y, p1.y, p0.w, p1.w};
        const float* vr = vt + (8 * j + 2 * t4) * RS + c0 + g;
        uint32_t bh[NTC][2], bl[NTC][2];
#pragma unroll
        for (int e = 0; e < NTC; ++e) {
          split(vr[8 * e], bh[e][0], bl[e][0]);
          split(vr[RS + 8 * e], bh[e][1], bl[e][1]);
        }
        mma_passes<NTC>(d, ah, al, bh, bl);
      }
#pragma unroll
      for (int e = 0; e < NTC; ++e) {
        acc[e][0] = fmaf(acc[e][0], corr[0], d[e][0]);
        acc[e][1] = fmaf(acc[e][1], corr[0], d[e][1]);
        acc[e][2] = fmaf(acc[e][2], corr[1], d[e][2]);
        acc[e][3] = fmaf(acc[e][3], corr[1], d[e][3]);
      }
      __syncthreads();  // everyone done with V of tile n
      load_v(n + 1);
    }

    // l: the quad's shares, then the row group's warps' (each over its own
    // keys, under the same m) in a fixed order
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp done reading the last tile's maxima
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (t4 == 0) red_g[r * 16 + g + 8 * hh] = l[hh];
    row_group_sync(rg);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l_all = red_g[g + 8 * hh];
#pragma unroll
      for (int w = 1; w < MMA_W; ++w) l_all += red_g[w * 16 + g + 8 * hh];
      const float inv = 1.f / (l_all == 0.f ? 1.f : l_all);
      const int qpos = q0 + 16 * rg + g + 8 * hh;
      if (qpos >= S) continue;
      float* orow = ob + (long)qpos * q_stride + c0 + 2 * t4;
#pragma unroll
      for (int e = 0; e < NTC; ++e)
        *reinterpret_cast<float2*>(orow + 8 * e) =
            make_float2(acc[e][2 * hh] * inv, acc[e][2 * hh + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int S,
                       int T_len, int H, int KV, int causal, int window, float softcap,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = MmaTile<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (S + MQ - 1) / MQ;
  const int paired = causal ? 1 : 0;
  dim3 grid(paired ? (n_qt + 1) / 2 : n_qt, H, B);
  flash_fwd_mma_f32<HD><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, T_len, H, KV, causal, window,
      softcap, scale, paired);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma tensor cores fed by TMA
// ---------------------------------------------------------------------------

constexpr int STAGES = 2;                         // K/V ring depth
constexpr int CONSUMER_WARPS = 4;                 // one warpgroup: 64 q rows
constexpr int WG_THREADS = 32 * CONSUMER_WARPS + 32;  // + one producer warp
constexpr uint32_t BOX_BYTES = 64 * 64 * 2;       // one TMA box: 64 rows x 64 bf16
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
__host__ __device__ constexpr uint32_t tile_bytes() { return 64u * HD * 2u; }  // one 64-row bf16 tile

template <int HD>
constexpr size_t wgmma_smem_bytes() {
  return 1024 + (size_t)tile_bytes<HD>() * (1 + 2 * STAGES);  // + slack to align to 1 KB
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
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

// One 64 x 64 box of a 4-D (hd, heads, seq, batch) tensor map into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

#define ACC8(d, o)                                                                         \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),          \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define ACC32(d) ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
#define ACC32_STR                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64x64 f32) += A (64x16, shared, K-major) * B (16x64, shared, K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_STR
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(1));
}

// d (64x64 f32) += A (64x16, registers) * B (16x64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_STR
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the wgmma that is writing it asynchronously.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// Accumulator fragment of m64nNk16 (f32): element i of a thread sits at row
// w*16 + lane/4 + 8*((i>>1)&1) and column 8*(i>>2) + 2*(lane%4) + (i&1).
// Scale, softcap, mask (when MASK), then the online softmax update of
// (m, l, acc) for this tile; s comes back holding p.  m is in log2 units;
// l holds this thread's share of its two rows' sums.
template <bool MASK, int CB>
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2], float (&l)[2],
                                               float (&acc)[CB][32], int qrow, int kcol,
                                               int T_len, int causal, int window,
                                               float softcap, float scale) {
  float mx[2] = {NEG_INF, NEG_INF};
  uint32_t ok_bits = 0xffffffffu;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = s[i] * scale;
    if (softcap != 0.f) x = softcap * tanhf(x / softcap);
    x *= LOG2E;
    if (MASK) {
      const int qpos = qrow + 8 * ((i >> 1) & 1);
      const int kpos = kcol + 8 * (i >> 2) + (i & 1);
      bool ok = kpos < T_len;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      if (!ok) {
        x = NEG_INF;
        ok_bits &= ~(1u << i);
      }
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float corr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    // the four lanes of a quad hold one row
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    const float m_new = fmaxf(m[hh], mx[hh]);
    corr[hh] = exp2f(m[hh] - m_new);
    m[hh] = m_new;
    l[hh] *= corr[hh];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1;
    float p = exp2f(s[i] - m[hh]);
    if (MASK) p = (ok_bits >> i) & 1u ? p : 0.f;
    s[i] = p;
    l[hh] += p;
  }
#pragma unroll
  for (int cb = 0; cb < CB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] *= corr[(i >> 1) & 1];
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_bf16(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                     int S, int T_len, int H, int KV, int causal, int window, float softcap,
                     float scale) {
  constexpr uint32_t TILE = tile_bytes<HD>();
  constexpr int CB = HD / 64;  // 64-column boxes of a row: TMA boxes and n64 products

  // barriers: Q, then per stage K full, V full, K/V empty
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto full_k = [&](int st) { return smem_u32(&bars[1 + st]); };
  auto full_v = [&](int st) { return smem_u32(&bars[1 + STAGES + st]); };
  auto empty = [&](int st) { return smem_u32(&bars[1 + 2 * STAGES + st]); };
  auto k_tile = [&](int st) { return sq + TILE * (1 + 2 * st); };

  // longest q tiles first under causal: the slowest block starts first
  const int q_tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = q_tile * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  // kv range this q tile can see; tiles outside it are wholly masked and
  // would change neither m, l nor acc, so they are not loaded
  int k_lo = 0, k_hi = T_len;
  if (causal) k_hi = min(T_len, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int k_first = (k_lo / BK) * BK;
  const int n_tiles = k_hi > k_first ? (k_hi - k_first + BK - 1) / BK : 0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // producer: one lane issues every copy
    if (lane == 0) {
      mbar_expect_tx(bar_q, TILE);
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) tma_load(sq + cb * BOX_BYTES, &tm_q, bar_q, 64 * cb, h, q0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % STAGES;
        const int round = n / STAGES;
        if (round > 0) mbar_wait(empty(st), (round - 1) & 1);
        const int k0 = k_first + n * BK;
        const uint32_t sk = k_tile(st), sv = sk + TILE;
        mbar_expect_tx(full_k(st), TILE);
#pragma unroll
        for (int cb = 0; cb < CB; ++cb)
          tma_load(sk + cb * BOX_BYTES, &tm_k, full_k(st), 64 * cb, kvh, k0, b);
        mbar_expect_tx(full_v(st), TILE);
#pragma unroll
        for (int cb = 0; cb < CB; ++cb)
          tma_load(sv + cb * BOX_BYTES, &tm_v, full_v(st), 64 * cb, kvh, k0, b);
      }
    }
    return;
  }

  // consumers: one warpgroup, rows r0 and r0 + 8 of the tile per thread
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  float acc[CB][32];
#pragma unroll
  for (int cb = 0; cb < CB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % STAGES;
    const uint32_t parity = (n / STAGES) & 1;
    const int k0 = k_first + n * BK;
    const uint32_t sk = k_tile(st), sv = sk + TILE;

    // S = Q K^T: hd/16 k-steps; a k-step is 32 bytes into a 128-byte
    // swizzled row, and every 4 steps the next 64-column box
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    mbar_wait(full_k(st), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss(s, sw128_desc(sq + off, 16, 1024), sw128_desc(sk + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    const bool full = k0 + BK <= T_len && (!causal || k0 + BK - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + BQ - 1 - window);
    if (full)
      online_softmax<false, CB>(s, m, l, acc, q0 + r0, k0 + cq, T_len, causal, window,
                                softcap, scale);
    else
      online_softmax<true, CB>(s, m, l, acc, q0 + r0, k0 + cq, T_len, causal, window,
                               softcap, scale);

    // P as the register A operand: k-step kk covers accumulator entries
    // 8 kk .. 8 kk + 7, which are exactly its four A registers
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // O += P V: V is (keys, hd) with hd contiguous, the MN-major B operand;
    // a k-step is 16 key rows (2048 bytes), a 64-column block one box
    mbar_wait(full_v(st), parity);
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) reg_fence(acc[cb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int cb = 0; cb < CB; ++cb)
        wgmma_rs(acc[cb], pa[kk], sw128_desc(sv + cb * BOX_BYTES + kk * 2048, BOX_BYTES, 1024));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) reg_fence(acc[cb]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qpos = q0 + r0 + 8 * hh;
    if (qpos >= S) continue;
    const float inv = 1.f / (l[hh] == 0.f ? 1.f : l[hh]);
    __nv_bfloat16* orow = o + (((long)b * S + qpos) * H + h) * HD + cq;
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * cb + 8 * j) = __floats2bfloat162_rn(
            acc[cb][4 * j + 2 * hh] * inv, acc[cb][4 * j + 2 * hh + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16 at hd 128: a persistent kernel, two consumer warpgroups in ping-pong
// (FlashAttention-3's layout)
// ---------------------------------------------------------------------------

constexpr int PP_ROWS = 128;                      // q rows a work item: 64 a consumer warpgroup
constexpr int PP_KEYS = 128;                      // keys a K/V tile
constexpr int PP_STAGES = 2;                      // K/V ring depth
constexpr int PP_THREADS = 3 * 128;               // producer + two consumer warpgroups
constexpr int PP_CONSUMER_WARPS = 8;
constexpr uint32_t PP_BOX_BYTES = PP_KEYS * 64 * 2;  // one K/V box: 128 keys x 64 bf16
constexpr int PP_TURN_BAR = 1;                    // named barriers 1, 2: consumer c may issue
// The entry point serves bf16 hd 128 with this kernel from this many q
// rows on, and with flash_fwd_wgmma_bf16 below it: phase 3 of
// chip_smoke.py times both at every hd-128 served width at S = 16, 128,
// 256, 384, 512 and 1024.  From 384 rows this kernel was the faster on an
// H100; below, a head's one or two 128-row items leave SMs idle and pay
// this kernel's longer set-up.
constexpr int PP_MIN_S = 384;

template <int HD, int ST>
constexpr size_t pp_smem_bytes() {
  // + slack to align to 1 KB; two Q slots, then K and V a stage
  return 1024 + 2 * (size_t)PP_ROWS * HD * 2 + 2 * (size_t)ST * PP_KEYS * HD * 2;
}

#define ACC64(d) ACC32(d), ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
#define ACC64_STR                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64x128 f32) (+)= A (64x16, shared, K-major) * B (16x128, shared,
// K-major); d is overwritten where !accumulate.
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC64_STR
      ", %64, %65, p, 1, 1, 0, 0;\n\t}"
      : ACC64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64x128 f32) += A (64x16, registers) * B (16x128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC64_STR
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
      : ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void reg_fence64(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// 2^x on the SFU (ex2.approx, subnormal results flushed to 0): one
// instruction where exp2f adds a range check around it.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The softcap on a 64x128 score fragment, into log2 units (the softmax's
// scale is then 1).
__device__ __forceinline__ void pp_softcap(float (&s)[64], float softcap, float scale) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = softcap * tanhf(s[i] * scale / softcap) * LOG2E;
}

// Mask (when MASK) and the online softmax update of (m, l) on a 64x128 score
// fragment; s comes back holding p and corr the factor for O.  s and m are
// in the units of the scores, and p = 2^(s sl - m sl), one fma and one ex2
// an element (sl = scale log2(e), or 1 after the softcap).  A masked score
// is NEG_INF, whose p underflows to 0; while a row has seen no visible key
// (m == NEG_INF) its m sl is taken as 0, so that p stays 0 there too.
// Element i of a thread sits at row qrow + 8 ((i >> 1) & 1) and key
// kcol + 8 (i >> 2) + (i & 1); the maxima and sums run as four partial
// chains a row.
template <bool MASK>
__device__ __forceinline__ void pp_softmax(float (&s)[64], float (&m)[2], float (&l)[2],
                                           float (&corr)[2], int qrow, int kcol, int T_len,
                                           int causal, int window, float sl) {
  float mx[2][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) mx[j / 4][j % 4] = NEG_INF;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (MASK) {
      const int qpos = qrow + 8 * ((i >> 1) & 1);
      const int kpos = kcol + 8 * (i >> 2) + (i & 1);
      bool ok = kpos < T_len;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      if (!ok) s[i] = NEG_INF;
    }
    float& x = mx[(i >> 1) & 1][(i >> 2) & 3];
    x = fmaxf(x, s[i]);
  }
  float ms[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float r = fmaxf(fmaxf(mx[hh][0], mx[hh][1]), fmaxf(mx[hh][2], mx[hh][3]));
    // the four lanes of a quad hold one row
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
    const float m_new = fmaxf(m[hh], r);
    corr[hh] = ex2((m[hh] - m_new) * sl);
    m[hh] = m_new;
    ms[hh] = m_new == NEG_INF ? 0.f : m_new * sl;
  }
  float ps[2][4] = {};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int hh = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], sl, -ms[hh]));
    ps[hh][(i >> 2) & 3] += s[i];
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    l[hh] = l[hh] * corr[hh] + ((ps[hh][0] + ps[hh][1]) + (ps[hh][2] + ps[hh][3]));
}

// The tile of 128 keys from k0 against a consumer's 64 rows from qc0: the
// softcap where one is set, the mask only where the tile straddles the
// causal diagonal, the window's edge or T.
__device__ __forceinline__ void pp_tile_softmax(float (&s)[64], float (&m)[2], float (&l)[2],
                                                float (&corr)[2], int k0, int qc0, int r0,
                                                int cq, int T_len, int causal, int window,
                                                float softcap, float scale, float sl) {
  if (softcap != 0.f) pp_softcap(s, softcap, scale);
  const bool full = k0 + PP_KEYS <= T_len && (!causal || k0 + PP_KEYS - 1 <= qc0) &&
                    (window <= 0 || k0 > qc0 + 63 - window);
  if (full)
    pp_softmax<false>(s, m, l, corr, qc0 + r0, k0 + cq, T_len, causal, window, sl);
  else
    pp_softmax<true>(s, m, l, corr, qc0 + r0, k0 + cq, T_len, causal, window, sl);
}

// S = Q K^T over hd 128: 8 k-steps of 32 bytes into a 128-byte swizzled
// row, the next 64-column box every 4; the first k-step overwrites s.
__device__ __forceinline__ void pp_issue_qk(float (&s)[64], uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss128(s, sw128_desc(sq + (kk / 4) * BOX_BYTES + (kk % 4) * 32, 16, 1024),
                sw128_desc(sk + (kk / 4) * PP_BOX_BYTES + (kk % 4) * 32, 16, 1024), kk);
  wgmma_commit();
}

// O = O corr + P V: V is (keys, hd), the MN-major B operand; a k-step is
// 16 key rows (2048 bytes), hd's two 64-column boxes one box apart.  O is
// rescaled while the tensor cores run the q k^T issued before it.
__device__ __forceinline__ void pp_issue_pv(float (&acc)[64], const float (&corr)[2],
                                            const uint32_t (&pa)[8][4], uint32_t sv) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] *= corr[(i >> 1) & 1];
  reg_fence64(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < PP_KEYS / 16; ++kk)
    wgmma_rs128(acc, pa[kk], sw128_desc(sv + kk * 2048, PP_BOX_BYTES, 1024));
  wgmma_commit();
}

// P as the register A operand of P V: k-step kk covers accumulator entries
// 8 kk .. 8 kk + 7, which are exactly its four A registers.
__device__ __forceinline__ void pp_pack(uint32_t (&pa)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// A work item: 128 q rows of one (head, batch) and the 128-key tiles they
// can see (tiles outside that range are wholly masked and would change
// neither m, l nor O, so they are not loaded).  Items are numbered head
// fastest, then batch, then the q tile, reversed under causal: the longest
// causal tiles of every head and batch row come first.
struct PpWork {
  int h, b, q0, k_first, n_tiles;
};

__device__ __forceinline__ PpWork pp_work(int w, int B, int S, int T_len, int H, int causal,
                                          int window) {
  const int n_qt = (S + PP_ROWS - 1) / PP_ROWS;
  PpWork t;
  t.h = w % H;
  w /= H;
  t.b = w % B;
  w /= B;
  t.q0 = (causal ? n_qt - 1 - w : w) * PP_ROWS;
  int k_lo = 0, k_hi = T_len;
  if (causal) k_hi = min(T_len, t.q0 + PP_ROWS);
  if (window > 0) k_lo = max(0, t.q0 - window + 1);
  t.k_first = (k_lo / PP_KEYS) * PP_KEYS;
  t.n_tiles = k_hi > t.k_first ? (k_hi - t.k_first + PP_KEYS - 1) / PP_KEYS : 0;
  return t;
}

// The item a block takes in round r: the rounds deal the items out to the
// blocks in a snake (0 .. G-1, then G-1 .. 0), so that in the longest-first
// order every block's total work comes out nearly equal.
__device__ __forceinline__ int pp_item(int r) {
  return r * gridDim.x + (r % 2 == 0 ? blockIdx.x : gridDim.x - 1 - blockIdx.x);
}

// One block an SM (at most), persistent over its items.  Warpgroup 0 is the
// producer: one thread issues every TMA copy, in the order the consumers
// take them: per item Q (two slots, so the next item's Q lands during this
// one), K_0, then K_n and V_{n-1}, through one K/V ring that runs on across
// items.  Warpgroups 1 and 2 each own 64 of an item's rows and walk its
// tiles in sections: section n issues S_n = Q K_n^T and O = O corr_{n-1} +
// P_{n-1} V_{n-1} (FlashAttention-3's overlap: the softmax of tile n runs
// while P V of tile n - 1 is on the tensor cores), then waits for S_n alone
// (wait_group 1), runs its softmax, waits for P V and packs P_n.  The two
// consumers take turns to issue a section (named barriers PP_TURN_BAR + c):
// one issues its two products while the other runs its softmax, so the
// tensor cores and the SFUs work at the same time.
template <int HD, int ST>
__global__ void __launch_bounds__(PP_THREADS, 1)
flash_fwd_pingpong_bf16(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ o, int B, int S, int T_len, int H, int KV,
                        int causal, int window, float softcap, float scale) {
  static_assert(HD == 128, "the ping-pong kernel is laid out for hd 128");
  constexpr uint32_t Q_HALF = 64 * HD * 2;         // one consumer's 64 rows, 2 boxes
  constexpr uint32_t Q_TILE = 2 * Q_HALF;
  constexpr uint32_t KV_TILE = PP_KEYS * HD * 2;   // 2 boxes of 128 keys x 64 columns

  // barriers: per Q slot full and empty, then per stage K full, V full,
  // K empty, V empty
  __shared__ __align__(8) uint64_t bars[4 + 4 * ST];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  auto q_full = [&](int slot) { return smem_u32(&bars[slot]); };
  auto q_empty = [&](int slot) { return smem_u32(&bars[2 + slot]); };
  auto full_k = [&](int st) { return smem_u32(&bars[4 + st]); };
  auto full_v = [&](int st) { return smem_u32(&bars[4 + ST + st]); };
  auto empty_k = [&](int st) { return smem_u32(&bars[4 + 2 * ST + st]); };
  auto empty_v = [&](int st) { return smem_u32(&bars[4 + 3 * ST + st]); };
  auto q_tile = [&](int slot) { return sq + Q_TILE * slot; };
  auto k_tile = [&](int st) { return sq + 2 * Q_TILE + KV_TILE * (2 * st); };
  auto v_tile = [&](int st) { return sq + 2 * Q_TILE + KV_TILE * (2 * st + 1); };
  const int n_items = (S + PP_ROWS - 1) / PP_ROWS * B * H;

  if (threadIdx.x == 0) {
    for (int slot = 0; slot < 2; ++slot) {
      mbar_init(q_full(slot), 1);
      mbar_init(q_empty(slot), PP_CONSUMER_WARPS);
    }
    for (int st = 0; st < ST; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), PP_CONSUMER_WARPS);
      mbar_init(empty_v(st), PP_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: its registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == 0) {
      int kn = 0, vn = 0, qn = 0;   // K tiles, V tiles and Q tiles issued
      for (int r = 0; pp_item(r) < n_items; ++r) {
        const PpWork t = pp_work(pp_item(r), B, S, T_len, H, causal, window);
        if (t.n_tiles == 0) continue;
        const int kvh = t.h / (H / KV);
        const int slot = qn % 2;
        if (qn >= 2) mbar_wait(q_empty(slot), ((qn / 2) - 1) & 1);
        mbar_expect_tx(q_full(slot), Q_TILE);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int cb = 0; cb < HD / 64; ++cb)
            tma_load(q_tile(slot) + c * Q_HALF + cb * BOX_BYTES, &tm_q, q_full(slot), 64 * cb,
                     t.h, t.q0 + 64 * c, t.b);
        ++qn;
        for (int n = 0; n <= t.n_tiles; ++n) {
          if (n < t.n_tiles) {
            const int st = kn % ST;
            if (kn >= ST) mbar_wait(empty_k(st), ((kn / ST) - 1) & 1);
            mbar_expect_tx(full_k(st), KV_TILE);
#pragma unroll
            for (int cb = 0; cb < HD / 64; ++cb)
              tma_load(k_tile(st) + cb * PP_BOX_BYTES, &tm_k, full_k(st), 64 * cb, kvh,
                       t.k_first + n * PP_KEYS, t.b);
            ++kn;
          }
          if (n > 0) {
            const int st = vn % ST;
            if (vn >= ST) mbar_wait(empty_v(st), ((vn / ST) - 1) & 1);
            mbar_expect_tx(full_v(st), KV_TILE);
#pragma unroll
            for (int cb = 0; cb < HD / 64; ++cb)
              tma_load(v_tile(st) + cb * PP_BOX_BYTES, &tm_v, full_v(st), 64 * cb, kvh,
                       t.k_first + (n - 1) * PP_KEYS, t.b);
            ++vn;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int r0 = warp * 16 + lane / 4;   // rows r0 and r0 + 8 of this consumer's 64
    const int cq = 2 * (lane % 4);
    const float sl = softcap != 0.f ? 1.f : scale * LOG2E;

    float acc[64], s[64];
    uint32_t pa[8][4];
    float m[2], l[2], corr[2];
    int kc = 0, vc = 0, qc = 0;   // K tiles, V tiles and Q tiles taken
    bool issued = false;          // has this consumer issued a section yet?

    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // the turn protocol: consumer 1 hands consumer 0 the first turn; each
    // section takes this consumer's turn and hands the other its own; and
    // consumer 0 takes one more turn at the end, which meets consumer 1's
    // last hand-over
    auto my_turn = [&]() {
      if (!issued && c == 1) named_arrive(PP_TURN_BAR, 256);
      issued = true;
      named_sync(PP_TURN_BAR + c, 256);
    };
    auto your_turn = [&]() { named_arrive(PP_TURN_BAR + 1 - c, 256); };

    for (int r = 0; pp_item(r) < n_items; ++r) {
      const PpWork t = pp_work(pp_item(r), B, S, T_len, H, causal, window);
      const int qc0 = t.q0 + 64 * c;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      m[0] = m[1] = NEG_INF;
      l[0] = l[1] = 0.f;
      if (t.n_tiles > 0) {
        const int slot = qc % 2;
        const uint32_t sqc = q_tile(slot) + c * Q_HALF;
        mbar_wait(q_full(slot), (qc / 2) & 1);

        // section 0: S_0 alone
        mbar_wait(full_k(kc % ST), (kc / ST) & 1);
        my_turn();
        reg_fence64(s);
        wgmma_fence();
        pp_issue_qk(s, sqc, k_tile(kc % ST));
        your_turn();
        wgmma_wait<0>();
        reg_fence64(s);
        release(empty_k(kc % ST));
        ++kc;
        if (t.n_tiles == 1) release(q_empty(slot));
        pp_tile_softmax(s, m, l, corr, t.k_first, qc0, r0, cq, T_len, causal, window, softcap,
                        scale, sl);
        pp_pack(pa, s);

        // sections 1 .. n_tiles - 1: S_n, and P_{n-1} V_{n-1}
        for (int n = 1; n < t.n_tiles; ++n) {
          mbar_wait(full_k(kc % ST), (kc / ST) & 1);
          mbar_wait(full_v(vc % ST), (vc / ST) & 1);
          my_turn();
          reg_fence64(s);
          reg_fence64(acc);
          wgmma_fence();
          pp_issue_qk(s, sqc, k_tile(kc % ST));
          pp_issue_pv(acc, corr, pa, v_tile(vc % ST));
          your_turn();
          wgmma_wait<1>();   // S_n; P V may still run
          reg_fence64(s);
          release(empty_k(kc % ST));
          ++kc;
          if (n == t.n_tiles - 1) release(q_empty(slot));
          pp_tile_softmax(s, m, l, corr, t.k_first + n * PP_KEYS, qc0, r0, cq, T_len, causal,
                          window, softcap, scale, sl);
          wgmma_wait<0>();
          reg_fence64(acc);
          release(empty_v(vc % ST));
          ++vc;
          pp_pack(pa, s);
        }

        // section n_tiles: the last P V
        mbar_wait(full_v(vc % ST), (vc / ST) & 1);
        my_turn();
        reg_fence64(acc);
        pp_issue_pv(acc, corr, pa, v_tile(vc % ST));
        your_turn();
        wgmma_wait<0>();
        reg_fence64(acc);
        release(empty_v(vc % ST));
        ++vc;
        ++qc;
      }

      // rows that see no key (l == 0) come out as 0
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qpos = qc0 + r0 + 8 * hh;
        if (qpos >= S) continue;
        const float inv = 1.f / (l[hh] == 0.f ? 1.f : l[hh]);
        __nv_bfloat16* orow = o + (((long)t.b * S + qpos) * H + t.h) * HD + cq;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
      }
    }
    if (issued && c == 0) named_sync(PP_TURN_BAR, 256);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (batch, rows, heads, hd) bf16 tensor as a 4-D map (hd, heads, rows,
// batch) with 64 x 1 x box_rows x 1 boxes, 128-byte swizzle, zeros out of
// bounds.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int batch, int rows, int heads,
                     int hd, int box_rows = 64) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                  strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S,
                         int T_len, int H, int KV, int causal, int window, float softcap,
                         float scale, cudaStream_t stream) {
  constexpr size_t smem = wgmma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if ((err = make_map(&tq, q, B, S, H, HD)) != cudaSuccess) return err;
  if ((err = make_map(&tk, k, B, T_len, KV, HD)) != cudaSuccess) return err;
  if ((err = make_map(&tv, v, B, T_len, KV, HD)) != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_wgmma_bf16<HD><<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, T_len, H, KV, causal, window, softcap,
      scale);
  return cudaGetLastError();
}

template <int HD, int ST>
cudaError_t launch_pingpong(const void* q, const void* k, const void* v, void* o, int B, int S,
                            int T_len, int H, int KV, int causal, int window, float softcap,
                            float scale, cudaStream_t stream) {
  constexpr size_t smem = pp_smem_bytes<HD, ST>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_pingpong_bf16<HD, ST>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if ((err = make_map(&tq, q, B, S, H, HD)) != cudaSuccess) return err;
  if ((err = make_map(&tk, k, B, T_len, KV, HD, PP_KEYS)) != cudaSuccess) return err;
  if ((err = make_map(&tv, v, B, T_len, KV, HD, PP_KEYS)) != cudaSuccess) return err;
  const long items = (long)((S + PP_ROWS - 1) / PP_ROWS) * B * H;
  if (items > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  // one block an SM, persistent over its items
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const unsigned blocks = (unsigned)(items < sms ? items : sms);
  flash_fwd_pingpong_bf16<HD, ST><<<blocks, PP_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, S, T_len, H, KV, causal, window, softcap,
      scale);
  return cudaGetLastError();
}

int bf16_rows(int B, int S, int H, int hd) {
  (void)B;
  (void)H;
  return hd == 128 && S >= PP_MIN_S ? PP_ROWS : BQ;
}

cudaError_t launch_bf16(int rows, int hd, const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T_len, int H, int KV, int causal, int window,
                        float softcap, float scale, cudaStream_t stream) {
#define FA_ARGS q, k, v, o, B, S, T_len, H, KV, causal, window, softcap, scale, stream
  if (rows == PP_ROWS && hd == 128) return launch_pingpong<128, PP_STAGES>(FA_ARGS);
  if (rows == BQ) {
    switch (hd) {
      case 64: return launch_wgmma<64>(FA_ARGS);
      case 128: return launch_wgmma<128>(FA_ARGS);
      case 256: return launch_wgmma<256>(FA_ARGS);
    }
  }
#undef FA_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q rows a block of the bf16 kernel that flash_attention_fwd launches for
// this shape: 128 (flash_fwd_pingpong_bf16) at hd 128 from PP_MIN_S rows
// on, else 64 (flash_fwd_wgmma_bf16).
int flash_attention_bf16_rows(int B, int S, int H, int hd) { return bf16_rows(B, S, H, hd); }

// The bf16 kernel of `rows` q rows a block (flash_attention_bf16_rows'
// values), whatever the shape's own rule: chip_smoke.py times both kernels
// at every hd-128 width with it.  Returns a cudaError_t.
int flash_attention_bf16_fwd(const void* q, const void* k, const void* v, void* o, int B, int S,
                             int T_len, int H, int KV, int hd, int rows, int causal, int window,
                             float softcap, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0 || T_len <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_bf16(rows, hd, q, k, v, o, B, S, T_len, H, KV, causal, window, softcap,
                          scale, static_cast<cudaStream_t>(stream));
}

// dtype: 0 = float32 (split TF32 on mma.sync), 1 = bfloat16 (wgmma + TMA; the kernel by
// flash_attention_bf16_rows).  Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T_len, int H, int KV, int hd,
                        int dtype, int causal, int window, float softcap,
                        float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0 || T_len <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_ARGS q, k, v, o, B, S, T_len, H, KV, causal, window, softcap, scale, st
  if (dtype == 0) {
    switch (hd) {
      case 64: return (int)launch_mma<64>(FA_ARGS);
      case 128: return (int)launch_mma<128>(FA_ARGS);
      case 256: return (int)launch_mma<256>(FA_ARGS);
    }
  } else if (dtype == 1) {
    return (int)launch_bf16(bf16_rows(B, S, H, hd), hd, FA_ARGS);
  }
#undef FA_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
