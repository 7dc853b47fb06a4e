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
// tensor cores.  Each input type has one kernel:
//
// * bf16, flash_fwd_wgmma_bf16 (the serving path).  Both products run on
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
// * f32, flash_fwd_simt_f32.  TF32 keeps ~3 decimal digits and would miss
//   the reference's 2e-5, so f32 stays on the CUDA cores: a 64x64 tile of
//   logits per iteration with a 4x4 register micro-tile per thread, f32
//   tiles in padded shared memory, synchronous loads.  It runs against the
//   67 TFLOP/s f32 rate.
//
// Both keep the two guards of the TPU kernel: p = mask ? p : 0 (a fully
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
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 logit micro-tile
constexpr int P_STRIDE = BK + 16;

template <int HD>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (HD + 4) + (size_t)BK * (HD + 4) +
                          (size_t)BK * HD + (size_t)BQ * P_STRIDE);
}

// Rows [row0, row0 + ROWS) of a (rows, HD) slice with the given row stride
// (in elements) -> shared memory with stride sm_stride; rows at or past
// n_rows are zero.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* sm, int sm_stride, const float* g,
                                          long row_stride, int row0, int n_rows) {
  constexpr int CPR = HD / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) x = *reinterpret_cast<const float4*>(g + (long)(row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(&sm[r * sm_stride + c]) = x;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_simt_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int S, int T_len,
                   int H, int KV, int causal, int window, float softcap, float scale) {
  constexpr int QKS = HD + 4;    // padded row stride of the Q and K tiles
  constexpr int NC = HD / 16;    // accumulator columns per thread
  constexpr int NV4 = HD / 64;   // float4 column chunks per thread

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QKS;
  float* Vs = Ks + BK * QKS;
  float* Ps = Vs + BK * HD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;   // rows ty + 16 i
  const int tx = tid & 15;   // logit columns tx + 16 j; output columns 64 c + 4 tx

  const long q_stride = (long)H * HD;
  const long kv_stride = (long)KV * HD;
  const float* qb = q + ((long)b * S * H + h) * HD;
  const float* kb = k + ((long)b * T_len * KV + kvh) * HD;
  const float* vb = v + ((long)b * T_len * KV + kvh) * HD;
  float* ob = o + ((long)b * S * H + h) * HD;

  load_tile<HD, BQ>(Qs, QKS, qb, q_stride, q0, S);

  // kv range this q tile can see; tiles outside it are wholly masked and
  // would change neither m, l nor acc.
  int k_lo = 0, k_hi = T_len;
  if (causal) k_hi = min(T_len, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // Q visible; previous readers of Ks, Vs, Ps done
    load_tile<HD, BK>(Ks, QKS, kb, kv_stride, k0, T_len);
    load_tile<HD, BK>(Vs, HD, vb, kv_stride, k0, T_len);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * QKS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * QKS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[4];
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < T_len;
        if (causal) ok[j] = ok[j] && kpos <= qpos;
        if (window > 0) ok[j] = ok[j] && kpos > qpos - window;
        float x = s[i][j] * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        x = ok[j] ? x : NEG_INF;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * P_STRIDE + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * P_STRIDE + j];
#pragma unroll
      for (int c4 = 0; c4 < NV4; ++c4) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j * HD + 64 * c4 + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * c4 + 0] = fmaf(p[i], vv.x, acc[i][4 * c4 + 0]);
          acc[i][4 * c4 + 1] = fmaf(p[i], vv.y, acc[i][4 * c4 + 1]);
          acc[i][4 * c4 + 2] = fmaf(p[i], vv.z, acc[i][4 * c4 + 2]);
          acc[i][4 * c4 + 3] = fmaf(p[i], vv.w, acc[i][4 * c4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c4 = 0; c4 < NV4; ++c4) {
      float4 out;
      out.x = acc[i][4 * c4 + 0] / denom;
      out.y = acc[i][4 * c4 + 1] / denom;
      out.z = acc[i][4 * c4 + 2] / denom;
      out.w = acc[i][4 * c4 + 3] / denom;
      *reinterpret_cast<float4*>(ob + (long)qpos * q_stride + 64 * c4 + 4 * tx) = out;
    }
  }
}

template <int HD>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                        int S, int T_len, int H, int KV, int causal, int window,
                        float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = simt_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_simt_f32<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, T_len, H, KV, causal,
      window, softcap, scale);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// batch) with 64 x 1 x 64 x 1 boxes, 128-byte swizzle, zeros out of bounds.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int batch, int rows, int heads,
                     int hd) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
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

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (wgmma + TMA).  Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream`.
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
      case 64: return (int)launch_simt<64>(FA_ARGS);
      case 128: return (int)launch_simt<128>(FA_ARGS);
      case 256: return (int)launch_simt<256>(FA_ARGS);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 64: return (int)launch_wgmma<64>(FA_ARGS);
      case 128: return (int)launch_wgmma<128>(FA_ARGS);
      case 256: return (int)launch_wgmma<256>(FA_ARGS);
    }
  }
#undef FA_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
