// Decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py,
// function decode_attention_pallas (body _decode_kernel): one query token
// per sequence against a sequence-major KV cache, GQA, the mask
// kpos <= pos[b] (and kpos > pos[b] - window where window > 0), an optional
// tanh logit softcap, online softmax in f32, output in q's type.
//
// Layout: q (B,H,hd), k and v (B,T,KV,hd), pos (B,) int32, out (B,H,hd), all
// contiguous.  q head h reads kv head h / (H/KV).
//
// What bounds it on this card: bytes.  Each visible cache row is hd values
// of k and hd of v, used for 4*hd FLOPs per query head of its group: about
// 8 FLOPs per byte at H/KV = 8 in bf16, against the ~295 the tensor cores
// need before they, and not the memory, are the limit.  So the design moves
// every KV byte once and keeps enough loads in flight:
//  1. One block serves all H/KV query heads (up to 8; larger groups take
//     several blocks) of one (batch row, kv head), so each K and V row is
//     read once from device memory and used for the whole group.  The
//     Pallas grid (B, H, T/bk) fetched every KV tile H/KV times.
//  2. T is split into pieces of 64-512 positions, one block each
//     (flash-decoding), so that B*KV = 4 still fills the 132 SMs.  Each
//     block writes its partial (m, l, acc) to scratch, and decode_combine
//     merges the pieces of each (b, h).  The piece length (chosen by the
//     caller) is the largest that still gives one block per SM: shorter
//     pieces leave the combine more partials to walk in series.
//  3. A piece wholly after pos[b], or wholly at or before pos[b] - window,
//     reads nothing and writes a neutral partial (l = 0) that the combine
//     skips: the bytes follow pos, not T.  This changes no result.
//  4. A warp reads a row with 16-byte loads along hd (8-32 lanes a row),
//     each lane keeps 8 such loads of K and 8 of V in flight, and the
//     arithmetic is f32 on the CUDA cores: no tensor cores are needed at
//     8 FLOPs per byte.
//
// The TPU kernel's guards are kept: p = mask ? exp(s - m) : 0, and l == 0 -> 1
// in the final divide, so a row with no visible key gives 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 8;                    // query heads per block
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -2.3819763e38f;  // bf16-safe large negative, as in the reference

__device__ __forceinline__ void unpack(const uint4& r, float* d, float) {
  d[0] = __uint_as_float(r.x);
  d[1] = __uint_as_float(r.y);
  d[2] = __uint_as_float(r.z);
  d[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float* d, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    d[2 * i] = f.x;
    d[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// How a warp reads rows of HD values of type T with 16-byte loads.
template <typename T, int HD>
struct RowGeometry {
  static constexpr int EPC = 16 / sizeof(T);          // values per 16-byte chunk
  static constexpr int ROWB = HD / EPC;               // chunks per row
  static constexpr int LPR = ROWB < 32 ? ROWB : 32;   // lanes per row
  static constexpr int CH = ROWB / LPR;               // chunks per lane
  static constexpr int RPW = 32 / LPR;                // rows a warp reads at once
  static constexpr int EPL = CH * EPC;                // values per lane
  static constexpr int U = 8 / CH;                    // rows per lane per step
};

template <int HD>
constexpr size_t split_smem_bytes() {
  return sizeof(float) * ((size_t)GMAX * HD + (size_t)WARPS * GMAX * HD + (size_t)WARPS * GMAX * 2);
}

// Partial (m, l, acc) of one piece of positions for up to GMAX query heads.
// Scratch layout: stats (B*H, n_pieces, 2) then acc (B*H, n_pieces, HD).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ pos, float* __restrict__ part, int T_len, int H,
             int KV, int n_pieces, int piece_len, int window, float softcap, float scale) {
  using G = RowGeometry<T, HD>;
  constexpr int EPC = G::EPC, LPR = G::LPR, CH = G::CH, RPW = G::RPW, EPL = G::EPL, U = G::U;

  const int piece = blockIdx.x;
  const int group = H / KV;
  const int n_hc = (group + GMAX - 1) / GMAX;
  const int kvh = blockIdx.y / n_hc;
  const int hc = blockIdx.y % n_hc;
  const int b = blockIdx.z;
  const int h0 = kvh * group + hc * GMAX;
  const int gc = min(GMAX, group - hc * GMAX);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const long row0 = ((long)b * H + h0) * n_pieces + piece;  // partial row of head h0
  float* stats = part + 2 * row0;                             // head g: + 2 g n_pieces
  float* pacc = part + 2L * gridDim.z * H * n_pieces + row0 * HD;  // head g: + g n_pieces HD

  // visible positions of this piece: [lo, hi)
  const int p = pos[b];
  const int base = piece * piece_len;
  const int lo = max(window > 0 ? p - window + 1 : 0, base);
  const int hi = min(min(p + 1, T_len), base + piece_len);
  if (lo >= hi) {  // nothing visible: a neutral partial, no reads
    if (tid < gc) {
      stats[2L * tid * n_pieces] = NEG_INF;
      stats[2L * tid * n_pieces + 1] = 0.f;
    }
    return;
  }

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [GMAX][HD]
  float* wacc = qs + GMAX * HD;                 // [WARPS][GMAX][HD]
  float* wml = wacc + WARPS * GMAX * HD;        // [WARPS][GMAX][2]

  const T* qb = q + ((long)b * H + h0) * HD;
  for (int i = tid; i < gc * HD; i += THREADS) qs[i] = to_f32(qb[i]);
  __syncthreads();

  // each warp takes a contiguous run of the piece; each group of LPR lanes
  // (a "sub-group") reads whole rows and keeps its own online softmax
  const int rows_per_warp = piece_len / WARPS;
  const int w_lo = max(lo, base + warp * rows_per_warp);
  const int w_hi = min(hi, base + (warp + 1) * rows_per_warp);
  const int sub = lane / LPR, sl = lane % LPR;

  const long row_stride = (long)KV * HD;
  const T* kb = k + ((long)b * T_len * KV + kvh) * HD;
  const T* vb = v + ((long)b * T_len * KV + kvh) * HD;

  float m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int r0 = w_lo; r0 < w_hi; r0 += RPW * U) {
    uint4 kr[U][CH], vr[U][CH];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = r0 + u * RPW + sub;
      ok[u] = row < w_hi;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (ok[u]) {
          const long off = (long)row * row_stride + (c * LPR + sl) * EPC;
          kr[u][c] = __ldg(reinterpret_cast<const uint4*>(kb + off));
          vr[u][c] = __ldg(reinterpret_cast<const uint4*>(vb + off));
        } else {
          kr[u][c] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][c] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }

#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= gc) break;
      float qv[EPL];
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          const float4 t = *reinterpret_cast<const float4*>(&qs[g * HD + (c * LPR + sl) * EPC + e]);
          qv[c * EPC + e] = t.x;
          qv[c * EPC + e + 1] = t.y;
          qv[c * EPC + e + 2] = t.z;
          qv[c * EPC + e + 3] = t.w;
        }
      float s[U];
      float tmax = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          float kf[EPC];
          unpack(kr[u][c], kf, T());
#pragma unroll
          for (int e = 0; e < EPC; ++e) dot = fmaf(qv[c * EPC + e], kf[e], dot);
        }
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
        float x = dot * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        s[u] = ok[u] ? x : NEG_INF;
        tmax = fmaxf(tmax, s[u]);
      }
      const float m_new = fmaxf(m[g], tmax);
      const float corr = expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = ok[u] ? expf(s[u] - m_new) : 0.f;
        psum += s[u];
      }
      l[g] = l[g] * corr + psum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          float vf[EPC];
          unpack(vr[u][c], vf, T());
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            acc[g][c * EPC + e] = fmaf(s[u], vf[e], acc[g][c * EPC + e]);
        }
      m[g] = m_new;
    }
  }

  // merge the sub-groups of the warp (they hold the same columns)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= gc) break;
      const float mo = __shfl_xor_sync(FULL, m[g], off);
      const float lo_other = __shfl_xor_sync(FULL, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float ca = expf(m[g] - mn), cb = expf(mo - mn);
      l[g] = l[g] * ca + lo_other * cb;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] = acc[g][e] * ca + __shfl_xor_sync(FULL, acc[g][e], off) * cb;
      m[g] = mn;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= gc) break;
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          wacc[(warp * GMAX + g) * HD + (c * LPR + sl) * EPC + e] = acc[g][c * EPC + e];
      if (sl == 0) {
        wml[(warp * GMAX + g) * 2] = m[g];
        wml[(warp * GMAX + g) * 2 + 1] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps (a warp with no visible row holds m = NEG_INF, l = 0)
  for (int i = tid; i < gc * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float M = NEG_INF;
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wml[(w * GMAX + g) * 2]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(wml[(w * GMAX + g) * 2] - M);
      L += c * wml[(w * GMAX + g) * 2 + 1];
      A += c * wacc[(w * GMAX + g) * HD + d];
    }
    pacc[(long)g * n_pieces * HD + d] = A;
    if (d == 0) {
      stats[2L * g * n_pieces] = M;
      stats[2L * g * n_pieces + 1] = L;
    }
  }
}

// Merge the pieces of one (b, h): one block, one thread per column.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_combine(const float* __restrict__ part, T* __restrict__ out, int BH, int n_pieces) {
  const int row = blockIdx.x;  // b * H + h
  const int d = threadIdx.x;
  const float* st = part + 2L * row * n_pieces;
  const float* ac = part + 2L * BH * n_pieces + (long)row * n_pieces * HD;
  float M = NEG_INF;
  for (int p = 0; p < n_pieces; ++p)
    if (st[2 * p + 1] > 0.f) M = fmaxf(M, st[2 * p]);
  float L = 0.f, A = 0.f;
  for (int p = 0; p < n_pieces; ++p) {
    const float lp = st[2 * p + 1];
    if (lp > 0.f) {  // a neutral piece wrote no acc
      const float c = expf(st[2 * p] - M);
      L += c * lp;
      A += c * ac[(long)p * HD + d];
    }
  }
  store(out + (long)row * HD + d, A / (L == 0.f ? 1.f : L));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos, void* o,
                   float* part, int B, int T_len, int H, int KV, int piece_len, int window,
                   float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_split<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_hc = (H / KV + GMAX - 1) / GMAX;
  const int n_pieces = (T_len + piece_len - 1) / piece_len;
  dim3 grid(n_pieces, KV * n_hc, B);
  decode_split<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      part, T_len, H, KV, n_pieces, piece_len, window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T, HD><<<B * H, HD, 0, stream>>>(part, static_cast<T*>(o), B * H, n_pieces);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, const int* pos,
                      void* o, float* part, int B, int T_len, int H, int KV, int piece_len,
                      int window, float softcap, float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, pos, o, part, B, T_len, H, KV, piece_len, window, softcap, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, pos, o, part, B, T_len, H, KV, piece_len, window, softcap, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, pos, o, part, B, T_len, H, KV, piece_len, window, softcap, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  part: f32 scratch of
// B*H*ceil(T/piece_len)*(hd + 2) values.  Returns a cudaError_t (0 on
// success); the two launches are asynchronous on `stream`.
int decode_attention_fwd(const void* q, const void* k, const void* v, const void* pos,
                         void* o, void* part, int B, int T_len, int H, int KV, int hd,
                         int dtype, int piece_len, int window, float softcap, float scale,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T_len <= 0 || KV <= 0 || H % KV != 0 || piece_len <= 0 ||
      piece_len % WARPS != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* scratch = static_cast<float*>(part);
  if (dtype == 0)
    return (int)launch_hd<float>(hd, q, k, v, p, o, scratch, B, T_len, H, KV, piece_len,
                                 window, softcap, scale, st);
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>(hd, q, k, v, p, o, scratch, B, T_len, H, KV,
                                         piece_len, window, softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
