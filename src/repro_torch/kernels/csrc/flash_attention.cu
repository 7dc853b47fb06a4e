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
// the H100's ~295 bf16 FLOPs/byte ridge: the bound is operations.  This
// first version does the arithmetic in f32 on the CUDA cores (no wgmma, no
// TMA), so it runs against the 67 TFLOP/s f32 rate, not the 989 TFLOP/s
// tensor-core rate.  What the design does about it: a 64x64 tile of logits
// per block iteration with a 4x4 register micro-tile per thread (16-byte
// shared-memory reads, padded rows, no bank conflicts), kv tiles wholly
// above the causal diagonal or outside the window are skipped, and the
// (S,T) score matrix never leaves the SM.  Moving the two products onto
// wgmma with bf16 operands is the next step.
//
// Structure: one block of 256 threads per (q tile of 64 rows, head, batch).
// The TPU's sequential kv grid axis becomes a loop inside the block; the
// running max m, sum l and the (64, hd) accumulator live in registers.
// Q, K and V tiles are converted to f32 in dynamic shared memory (above
// 48 KB, hence cudaFuncSetAttribute).  The two guards of the TPU kernel are
// kept: p = mask ? p : 0 (a fully masked tile has m_prev = m_new = NEG_INF,
// so exp(0) = 1 would leak in) and l == 0 -> 1 in the final divide (fully
// masked rows give 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv rows per iteration
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 logit micro-tile
constexpr int P_STRIDE = BK + 16;
constexpr float NEG_INF = -2.3819763e38f;  // bf16-safe large negative, as in the reference

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (HD + 4) + (size_t)BK * (HD + 4) +
                          (size_t)BK * HD + (size_t)BQ * P_STRIDE);
}

// 16 bytes of global memory -> f32 values.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Four f32 values -> global memory in the output type.
__device__ __forceinline__ void store4(float* dst, const float* x) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned int*>(&lo);
  raw.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

// Rows [row0, row0 + ROWS) of a (rows, HD) slice with the given row stride
// (in elements) -> f32 shared memory with stride sm_stride; rows at or past
// n_rows are zero.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* sm, int sm_stride, const T* g,
                                          long row_stride, int row0, int n_rows) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = HD / EPC;        // chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * EPC;
    float vals[EPC];
    if (row0 + r < n_rows) {
      load16(g + (long)(row0 + r) * row_stride + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPC; e += 4)
      *reinterpret_cast<float4*>(&sm[r * sm_stride + c + e]) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int T_len, int H,
          int KV, int causal, int window, float softcap, float scale) {
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
  const T* qb = q + ((long)b * S * H + h) * HD;
  const T* kb = k + ((long)b * T_len * KV + kvh) * HD;
  const T* vb = v + ((long)b * T_len * KV + kvh) * HD;
  T* ob = o + ((long)b * S * H + h) * HD;

  load_tile<T, HD, BQ>(Qs, QKS, qb, q_stride, q0, S);

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
    load_tile<T, HD, BK>(Ks, QKS, kb, kv_stride, k0, T_len);
    load_tile<T, HD, BK>(Vs, HD, vb, kv_stride, k0, T_len);
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
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = acc[i][4 * c4 + e] / denom;
      store4(ob + (long)qpos * q_stride + 64 * c4 + 4 * tx, out);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int T_len, int H, int KV, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, H, KV, causal,
      window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, int B, int S, int T_len, int H, int KV,
                      int causal, int window, float softcap, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, T_len, H, KV, causal, window, softcap, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, T_len, H, KV, causal, window, softcap, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, T_len, H, KV, causal, window, softcap, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success);
// the launch is asynchronous on `stream`.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T_len, int H, int KV, int hd,
                        int dtype, int causal, int window, float softcap,
                        float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0 || T_len <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_hd<float>(hd, q, k, v, o, B, S, T_len, H, KV, causal,
                                 window, softcap, scale, st);
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, T_len, H, KV,
                                         causal, window, softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
