// Mamba2 SSD chunk scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py, function
// ssd_scan_pallas (body _ssd_kernel): the SSD (state-space duality) forward
// over chunks of Q positions with an (hd, N) f32 state carried from chunk to
// chunk.  Within a chunk, with cum the inclusive cumsum of da = dt * a:
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//        + exp(cum_i) C_i . h_prev^T                               (inter)
//   h    = exp(cum_last) h_prev + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// The state starts at 0; h_final is the state after the last chunk.
//
// Layout (the model's, as repro.kernels.ssd_scan takes it): x (B,L,nh,hd)
// f32 or bf16, dt (B,L,nh) f32, a (nh,) f32, B and C (B,L,N) f32 or bf16,
// one B and C row per position shared by all heads.  Out: y (B,L,nh,hd) in
// x's type, h_final (B,nh,hd,N) f32.  All arithmetic is f32.
//
// What bounds it on this card: operations.  Per (head, chunk) the products
// att @ x, C . h_prev^T and the state update are 3 * 2*Q*hd*N-sized (12.6
// MFLOP at mamba2-370m: Q=256, hd=64, N=128) on about 2*Q*hd*4 bytes of x
// and y, some 190 FLOPs per byte, far above the 20 FLOPs per byte of f32 on
// the CUDA cores (67 TFLOP/s over 3.35 TB/s).  What the design does:
//  1. The Pallas grid (B*nh, NC) walked the chunks in order, carrying h in
//     VMEM: 32 blocks at mamba2-370m with B=1.  Here the SSD's own split
//     runs the chunks in parallel, in three launches:
//       ssd_chunk_state  per (b*h, chunk): S_c = sum_j w_j x_j B_j^T and
//                        exp(cum_last);
//       ssd_state_pass   per (b*h, 256 state elements): h_c =
//                        exp(cum_last,c) h_{c-1} + S_c, NC steps, written in
//                        place over S_c as the state in force before chunk
//                        c, and h_final;
//       ssd_chunk_out    per (b*h, chunk, 64-row tile): intra + inter.
//     The result is the same; only the order of the sums differs.
//  2. B and C are read as (B,L,N) by the position's batch row, never
//     broadcast to every head (the reference wrapper materialises them nh
//     times, 32x their bytes at mamba2-370m).
//  3. The Q x Q att matrix (256 KB in f32 at Q=256, above the 227 KB a block
//     can have) is built 64 x 64 at a time in shared memory, and column
//     tiles wholly above the diagonal are skipped.
// Products are f32 FMAs on the CUDA cores from shared memory, each thread
// a 4x4 (or 4x8) register tile.  Known excess: ssd_chunk_out recomputes
// C . B^T for every head though it depends only on the batch row (about
// 1.6x the counted operations at mamba2-370m).  Sharing it across heads and
// moving the products onto mma/wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int TQ = 64;        // positions per tile
constexpr int QMAX = 256;     // largest chunk
constexpr int PS = TQ + 4;    // padded row stride of the att tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// dt of the chunk's Q positions -> dts; inclusive cumsum of dt * a -> cum.
// `first` indexes dt at the chunk's first position; positions are nh apart.
__device__ void chunk_decay(float* cum, float* dts, const float* __restrict__ dt, float a,
                            long first, int nh, int Q) {
  for (int j = threadIdx.x; j < Q; j += THREADS) {
    const float d = dt[first + (long)j * nh];
    dts[j] = d;
    cum[j] = d * a;
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // one warp: 8 consecutive values a lane, then a warp scan
    constexpr int PER = QMAX / 32;
    const int lane = threadIdx.x;
    float loc[PER];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int j = lane * PER + e;
      run += j < Q ? cum[j] : 0.f;
      loc[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += t;
    }
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int j = lane * PER + e;
      if (j < Q) cum[j] = loc[e] + excl;
    }
  }
  __syncthreads();
}

size_t chunk_state_smem(int hd, int n) {
  return sizeof(float) * (3 * QMAX + (size_t)TQ * hd + (size_t)TQ * n);
}

// S_c (hd, N) of one (b*h, chunk) -> states, exp(cum_last) -> decay.
// Thread (ty, tx) owns S[ty + 16 i][tx + 16 j].
template <typename TX, typename TB, int HD>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state(const TX* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const TB* __restrict__ bmat,
                float* __restrict__ states, float* __restrict__ decay, int L, int nh, int N,
                int Q) {
  constexpr int NI = HD / 16;
  extern __shared__ float4 smem4[];
  float* cum = reinterpret_cast<float*>(smem4);
  float* dts = cum + QMAX;
  float* w = dts + QMAX;   // exp(cum_last - cum_j) * dt_j
  float* xw = w + QMAX;    // [TQ][HD]  x rows scaled by w
  float* bs = xw + TQ * HD;  // [TQ][N]

  const int c = blockIdx.x, bh = blockIdx.y, NC = gridDim.x;
  const int b = bh / nh, h = bh % nh;
  const long pos0 = (long)b * L + (long)c * Q;  // first position, in (b*L + l) units
  chunk_decay(cum, dts, dt, a[h], pos0 * nh + h, nh, Q);
  const float cl = cum[Q - 1];
  for (int j = threadIdx.x; j < Q; j += THREADS) w[j] = expf(cl - cum[j]) * dts[j];

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nj = N / 16;
  float acc[NI][8];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += TQ) {
    const int rows = min(TQ, Q - j0);
    __syncthreads();  // w written; previous readers of xw, bs done
    for (int i = tid; i < rows * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      xw[i] = to_f32(x[((pos0 + j0 + r) * nh + h) * HD + d]) * w[j0 + r];
    }
    for (int i = tid; i < rows * N; i += THREADS) bs[i] = to_f32(bmat[(pos0 + j0) * N + i]);
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      float xv[NI], bv[8];
#pragma unroll
      for (int i = 0; i < NI; ++i) xv[i] = xw[r * HD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = j < nj ? bs[r * N + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
    }
  }
  float* out = states + ((long)bh * NC + c) * HD * N;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < nj) out[(ty + 16 * i) * N + tx + 16 * j] = acc[i][j];
  if (tid == 0) decay[(long)bh * NC + c] = expf(cl);
}

// The carried state, chunk by chunk: states[bh, c] <- state before chunk c.
__global__ void __launch_bounds__(THREADS)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ decay,
               float* __restrict__ h_final, int NC, int size) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int bh = blockIdx.y;
  if (e >= size) return;
  float* s = states + (long)bh * NC * size + e;
  float hs = 0.f;
  for (int c = 0; c < NC; ++c) {
    const float sc = s[(long)c * size];
    s[(long)c * size] = hs;
    hs = decay[(long)bh * NC + c] * hs + sc;
  }
  h_final[(long)bh * size + e] = hs;
}

size_t chunk_out_smem(int hd, int n) {
  return sizeof(float) * (2 * QMAX + 2 * (size_t)TQ * (n + 4) + (size_t)TQ * hd + (size_t)TQ * PS);
}

// y rows [i0, i0 + 64) of one (b*h, chunk).  Thread (ty, tx) owns
// y[i0 + ty + 16 a][tx + 16 e].
template <typename TX, typename TB, int HD>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_out(const TX* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a, const TB* __restrict__ bmat,
              const TB* __restrict__ cmat, const float* __restrict__ states,
              TX* __restrict__ y, int L, int nh, int N, int Q) {
  constexpr int NE = HD / 16;
  const int NS = N + 4;  // padded row stride of the C, B and state tiles
  extern __shared__ float4 smem4[];
  float* cum = reinterpret_cast<float*>(smem4);
  float* dts = cum + QMAX;
  float* cs = dts + QMAX;    // [TQ][NS]  C rows of this tile
  float* bs = cs + TQ * NS;  // [TQ][NS]  B rows of a column tile; then the state [HD][NS]
  float* xs = bs + TQ * NS;  // [TQ][HD]  x rows of a column tile
  float* ps = xs + TQ * HD;  // [TQ][PS]  att tile

  const int i0 = blockIdx.x * TQ, c = blockIdx.y, bh = blockIdx.z, NC = gridDim.y;
  const int b = bh / nh, h = bh % nh;
  const long pos0 = (long)b * L + (long)c * Q;
  chunk_decay(cum, dts, dt, a[h], pos0 * nh + h, nh, Q);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int i = tid; i < TQ * N; i += THREADS) {
    const int r = i / N, n = i % N;
    cs[r * NS + n] = i0 + r < Q ? to_f32(cmat[(pos0 + i0 + r) * N + n]) : 0.f;
  }
  float acc[4][NE];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[r][e] = 0.f;

  for (int j0 = 0; j0 <= i0; j0 += TQ) {  // column tiles on or below the diagonal
    __syncthreads();
    for (int i = tid; i < TQ * N; i += THREADS) {
      const int r = i / N, n = i % N;
      bs[r * NS + n] = j0 + r < Q ? to_f32(bmat[(pos0 + j0 + r) * N + n]) : 0.f;
    }
    for (int i = tid; i < TQ * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      xs[i] = j0 + r < Q ? to_f32(x[((pos0 + j0 + r) * nh + h) * HD + d]) : 0.f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[r][q] = 0.f;
    for (int n = 0; n < N; n += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = *reinterpret_cast<const float4*>(&cs[(ty + 16 * r) * NS + n]);
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = *reinterpret_cast<const float4*>(&bs[(tx + 16 * q) * NS + n]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[r][q] = dot4(cv[r], bv[q], s[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * q;
        ps[(ty + 16 * r) * PS + tx + 16 * q] =
            (i < Q && j <= i) ? s[r][q] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
      }
    __syncthreads();
    const int jn = min(TQ, Q - j0);
    for (int j = 0; j < jn; ++j) {
      float pv[4], xv[NE];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = ps[(ty + 16 * r) * PS + j];
#pragma unroll
      for (int e = 0; e < NE; ++e) xv[e] = xs[j * HD + tx + 16 * e];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[r][e] = fmaf(pv[r], xv[e], acc[r][e]);
    }
  }

  // inter-chunk term from the state in force before this chunk
  __syncthreads();
  const float* hp = states + ((long)bh * NC + c) * HD * N;
  for (int i = tid; i < HD * N; i += THREADS) {
    const int d = i / N, n = i % N;
    bs[d * NS + n] = hp[i];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    float t[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) t[e] = 0.f;
    for (int n = 0; n < N; n += 4) {
      const float4 cv = *reinterpret_cast<const float4*>(&cs[(ty + 16 * r) * NS + n]);
#pragma unroll
      for (int e = 0; e < NE; ++e)
        t[e] = dot4(cv, *reinterpret_cast<const float4*>(&bs[(tx + 16 * e) * NS + n]), t[e]);
    }
    if (i < Q) {
      const float ec = expf(cum[i]);
      TX* yrow = y + ((pos0 + i) * nh + h) * HD;
#pragma unroll
      for (int e = 0; e < NE; ++e) store(yrow + tx + 16 * e, acc[r][e] + ec * t[e]);
    }
  }
}

template <typename TX, typename TB, int HD>
cudaError_t launch(const void* x, const float* dt, const float* a, const void* bmat,
                   const void* cmat, void* y, float* h_final, float* states, float* decay,
                   int B, int L, int nh, int N, int Q, cudaStream_t stream) {
  const int NC = L / Q, BH = B * nh;
  const size_t smem1 = chunk_state_smem(HD, N), smem3 = chunk_out_smem(HD, N);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state<TX, TB, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_out<TX, TB, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return err;
  const TX* xt = static_cast<const TX*>(x);
  const TB* bt = static_cast<const TB*>(bmat);
  ssd_chunk_state<TX, TB, HD><<<dim3(NC, BH), THREADS, smem1, stream>>>(
      xt, dt, a, bt, states, decay, L, nh, N, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int size = HD * N;
  ssd_state_pass<<<dim3((size + THREADS - 1) / THREADS, BH), THREADS, 0, stream>>>(
      states, decay, h_final, NC, size);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_out<TX, TB, HD><<<dim3((Q + TQ - 1) / TQ, NC, BH), THREADS, smem3, stream>>>(
      xt, dt, a, bt, static_cast<const TB*>(cmat), states, static_cast<TX*>(y), L, nh, N, Q);
  return cudaGetLastError();
}

template <typename TX, typename TB>
cudaError_t launch_hd(int hd, const void* x, const float* dt, const float* a, const void* bmat,
                      const void* cmat, void* y, float* h_final, float* states, float* decay,
                      int B, int L, int nh, int N, int Q, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<TX, TB, 16>(x, dt, a, bmat, cmat, y, h_final, states, decay, B, L, nh, N, Q, stream);
    case 32:
      return launch<TX, TB, 32>(x, dt, a, bmat, cmat, y, h_final, states, decay, B, L, nh, N, Q, stream);
    case 64:
      return launch<TX, TB, 64>(x, dt, a, bmat, cmat, y, h_final, states, decay, B, L, nh, N, Q, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TX>
cudaError_t launch_bc(int bc_dtype, int hd, const void* x, const float* dt, const float* a,
                      const void* bmat, const void* cmat, void* y, float* h_final,
                      float* states, float* decay, int B, int L, int nh, int N, int Q,
                      cudaStream_t stream) {
  if (bc_dtype == 0)
    return launch_hd<TX, float>(hd, x, dt, a, bmat, cmat, y, h_final, states, decay, B, L, nh, N, Q, stream);
  if (bc_dtype == 1)
    return launch_hd<TX, __nv_bfloat16>(hd, x, dt, a, bmat, cmat, y, h_final, states, decay, B, L, nh, N, Q, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x_dtype, bc_dtype: 0 = float32, 1 = bfloat16.  states: f32 scratch of
// B*nh*(L/Q)*hd*N values; decay: f32 scratch of B*nh*(L/Q).  Returns a
// cudaError_t (0 on success); the three launches are asynchronous on `stream`.
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* bmat,
                 const void* cmat, void* y, void* h_final, void* states, void* decay, int B,
                 int L, int nh, int hd, int N, int Q, int x_dtype, int bc_dtype, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool q_ok = Q == 16 || Q == 32 || Q == 64 || Q == 128 || Q == 256;
  const bool n_ok = N == 16 || N == 32 || N == 64 || N == 128;
  if (B <= 0 || nh <= 0 || L <= 0 || !q_ok || !n_ok || L % Q != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(a);
  float* hf = static_cast<float*>(h_final);
  float* sp = static_cast<float*>(states);
  float* dp = static_cast<float*>(decay);
  if (x_dtype == 0)
    return (int)launch_bc<float>(bc_dtype, hd, x, dtp, ap, bmat, cmat, y, hf, sp, dp, B, L, nh, N, Q, st);
  if (x_dtype == 1)
    return (int)launch_bc<__nv_bfloat16>(bc_dtype, hd, x, dtp, ap, bmat, cmat, y, hf, sp, dp, B, L, nh, N, Q, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
