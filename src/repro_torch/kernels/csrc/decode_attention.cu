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
// every KV byte once and keeps enough loads in flight.  Two launches:
//  1. A split.  One block serves all H/KV query heads (up to 8; larger
//     groups take several blocks) of one (batch row, kv head), so each K and
//     V row is read once from device memory and used for the whole group.
//     The Pallas grid (B, H, T/bk) fetched every KV tile H/KV times.  T is
//     split into pieces of 64-512 positions, one block each (flash-decoding),
//     so that B*KV = 4 still fills the 132 SMs; each block writes its
//     partial (m, l, acc) to scratch.  The piece length (chosen by the
//     caller) is the largest that still gives one block per SM.  A piece
//     wholly after pos[b], or wholly at or before pos[b] - window, reads
//     nothing and writes a neutral partial (l = 0): the bytes follow pos,
//     not T.  The split has one kernel per type:
//     - bf16, decode_split_mma_bf16: q kᵀ and P V on the tensor cores
//       (mma.sync m16n8k16, bf16 operands, f32 accumulators), the group's
//       heads on the M dimension (padded to 16 with zero rows), K and V
//       tiles of 64 rows streamed by cp.async through a 2-stage
//       shared-memory ring so the next tile's loads overlap this tile's
//       math, 4 warps splitting each tile's rows.
//     - f32, decode_split: f32 on the CUDA cores, a warp per run of rows
//       with 16-byte loads along hd.  The tensor cores take f32 only as
//       TF32, which would miss the reference's 2e-5.
//  2. decode_combine merges the pieces of each (b, h), skipping neutral
//     ones.
//
// The TPU kernel's guards are kept: p = mask ? exp(s - m) : 0, and l == 0 -> 1
// in the final divide, so a row with no visible key gives 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// f32 split: CUDA cores
// ---------------------------------------------------------------------------

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
  for (int i = tid; i < gc * HD; i += THREADS) qs[i] = qb[i];
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

// ---------------------------------------------------------------------------
// bf16 split: mma.sync tensor cores fed by cp.async
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int TILE = 64;                   // K rows and V rows per ring stage
constexpr int STAGES = 2;                  // ring depth: the next tile loads during the math
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory: Q (GMAX rows), then STAGES x (K tile, V tile), all bf16.
// After the last tile the ring holds the warps' partials for the merge.
template <int HD>
constexpr size_t mma_smem_bytes() {
  return 2 * ((size_t)GMAX * HD + (size_t)STAGES * 2 * TILE * HD);
}
// Floats per head row of the warps' merge buffer: the padding keeps its
// float2 stores free of bank conflicts.
template <int HD>
__host__ __device__ constexpr int merge_stride() { return HD + 8; }

// Byte offset of 16-byte chunk c of row r in a bf16 tile of HD columns.  The
// chunks of a row are XOR-swizzled by r % 8, so an ldmatrix that reads one
// chunk column of 8 consecutive rows touches 8 distinct groups of 4 banks.
template <int HD>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * HD * 2 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros where !valid (src-size 0,
// nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
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

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8 and gets, of each matrix, row lane/4, columns 2*(lane%4) and +1
// (with .trans: rows 2*(lane%4) and +1 of column lane/4).
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16x8, f32) += a (16x16, bf16, row) b (16x8, bf16, col) with rows 8-15
// of a zero: only the head rows 0-7 are kept, so a's registers a1, a3 and
// d's d2, d3 (rows 8-15) are zeros in and dropped out.
__device__ __forceinline__ void mma_heads(float (&d)[2], uint32_t a0, uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm("{\n\t.reg .f32 d2, d3;\n\t"
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, d2, d3}, "
      "{%2, %3, %4, %3}, {%5, %6}, {%0, %1, %7, %7};\n\t}"
      : "+f"(d[0]), "+f"(d[1])
      : "r"(a0), "r"(0u), "r"(a2), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// Partial (m, l, acc) of one piece for up to GMAX query heads, as
// decode_split writes it.  The piece's visible rows [lo, hi) are walked in
// tiles of 64 from lo; warp w takes rows 16w..16w+15 of every tile.  In the
// m16n8 fragments, lane l holds head row l/4: S = Q Kᵀ is two n-tiles of 8
// keys (keys 8n + 2(l%4) and +1), and O += P V is HD/8 n-tiles of 8 columns
// (columns 8j + 2(l%4) and +1).  The S accumulator is, as it stands, the A
// fragment of P V, so P goes to bf16 in registers.  Each warp keeps its own
// (m, l) per head in log2 units; one merge over the warps at the end.
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
decode_split_mma_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos,
                      float* __restrict__ part, int T_len, int H, int KV, int n_pieces,
                      int piece_len, int window, float softcap, float scale) {
  constexpr int CPR = HD / 8;                    // 16-byte chunks per row
  constexpr uint32_t TILE_BYTES = TILE * HD * 2;
  constexpr int NT = HD / 8;                     // n-tiles of O
  constexpr int WS = merge_stride<HD>();

  const int piece = blockIdx.x;
  const int group = H / KV;
  const int n_hc = (group + GMAX - 1) / GMAX;
  const int kvh = blockIdx.y / n_hc;
  const int hc = blockIdx.y % n_hc;
  const int b = blockIdx.z;
  const int h0 = kvh * group + hc * GMAX;
  const int gc = min(GMAX, group - hc * GMAX);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const long row0 = ((long)b * H + h0) * n_pieces + piece;
  float* stats = part + 2 * row0;
  float* pacc = part + 2L * gridDim.z * H * n_pieces + row0 * HD;

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

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_ring = s_q + GMAX * HD * 2;   // stage s: K at + 2s TILE_BYTES, V after it

  const long row_stride = (long)KV * HD;
  const __nv_bfloat16* kb = k + ((long)b * T_len * KV + kvh) * HD;
  const __nv_bfloat16* vb = v + ((long)b * T_len * KV + kvh) * HD;
  const int n_tiles = (hi - lo + TILE - 1) / TILE;

  // Q rows of this head chunk, zeros past gc; in the first group with tile 0
  const __nv_bfloat16* qb = q + ((long)b * H + h0) * HD;
  for (int i = tid; i < GMAX * CPR; i += MMA_THREADS) {
    const int r = i / CPR, c = i % CPR;
    cp_async16(s_q + swz<HD>(r, c), qb + (r < gc ? r : 0) * HD + c * 8, r < gc);
  }
  // rows past hi arrive as zeros: no row outside [lo, hi) is read
  auto load_tile = [&](int tile) {
    const int r0 = lo + tile * TILE;
    const uint32_t sk = s_ring + (tile % STAGES) * 2 * TILE_BYTES, sv = sk + TILE_BYTES;
    for (int i = tid; i < TILE * CPR; i += MMA_THREADS) {
      const int r = i / CPR, c = i % CPR;
      const bool ok = r0 + r < hi;
      const long off = (long)(ok ? r0 + r : lo) * row_stride + c * 8;
      cp_async16(sk + swz<HD>(r, c), kb + off, ok);
      cp_async16(sv + swz<HD>(r, c), vb + off, ok);
    }
  };
  // one commit group per tile (empty past the last), so that group t holds
  // tile t (and the Q rows, with tile 0)
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  const int tq = lane & 3;                                              // lane in its quad
  const int q_row = lane & 7, q_chunk = lane >> 3;                      // + 4 per pair of k-steps
  const int k_row = warp * 16 + (lane & 7) + ((lane >> 4) << 3);
  const int k_chunk = (lane >> 3) & 1;                                  // + 2 per k-step
  const int v_row = warp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_chunk = lane >> 4;                                        // + 2 per pair of n-tiles

  float o[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = 0.f;
  float m_r = NEG_INF, l_r = 0.f;  // head lane/4: running max (log2 units), this lane's sum

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<STAGES - 2>();  // this thread's part of tile `tile` has landed
    __syncthreads();              // everyone's has, and every warp is done with tile - 1
    if (tile + STAGES - 1 < n_tiles) load_tile(tile + STAGES - 1);  // into tile - 1's stage
    cp_async_commit();
    const uint32_t sk = s_ring + (tile % STAGES) * 2 * TILE_BYTES, sv = sk + TILE_BYTES;

    // S = Q Kᵀ over this warp's 16 rows
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int kp = 0; kp < HD / 32; ++kp) {
      uint32_t a[4];  // a0, a2 of k-step 2kp, then of 2kp + 1
      ldsm_x4(s_q + swz<HD>(q_row, 4 * kp + q_chunk), a);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        uint32_t bk[4];  // b0, b1 of keys 0-7, then of keys 8-15
        ldsm_x4(sk + swz<HD>(k_row, 2 * (2 * kp + h2) + k_chunk), bk);
        mma_heads(s[0], a[2 * h2], a[2 * h2 + 1], bk[0], bk[1]);
        mma_heads(s[1], a[2 * h2], a[2 * h2 + 1], bk[2], bk[3]);
      }
    }

    // scale, softcap and, on a tile that reaches past hi, the mask; then
    // the online softmax (the four lanes of a quad hold one head)
    const int key0 = lo + tile * TILE + warp * 16 + 2 * tq;
    const bool edge = lo + (tile + 1) * TILE > hi;
    float mx = NEG_INF;
    unsigned ok_bits = 0xfu;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = s[i >> 1][i & 1] * scale;
      if (softcap != 0.f) x = softcap * tanhf(x / softcap);
      x *= LOG2E;
      if (edge && key0 + 8 * (i >> 1) + (i & 1) >= hi) {
        x = NEG_INF;
        ok_bits &= ~(1u << i);
      }
      s[i >> 1][i & 1] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(m_r, mx);
    const float corr = exp2f(m_r - m_new);
    m_r = m_new;
    float pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pr[i] = (ok_bits >> i) & 1u ? exp2f(s[i >> 1][i & 1] - m_new) : 0.f;
    l_r = l_r * corr + (pr[0] + pr[1]) + (pr[2] + pr[3]);
    const uint32_t pa0 = pack_bf16(pr[0], pr[1]), pa2 = pack_bf16(pr[2], pr[3]);

    // O = O corr + P V
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t bv[4];  // b0, b1 of columns 16jp..+7, then of 16jp+8..+15
      ldsm_x4_trans(sv + swz<HD>(v_row, 2 * jp + v_chunk), bv);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float(&oj)[2] = o[2 * jp + h2];
        oj[0] *= corr;
        oj[1] *= corr;
        mma_heads(oj, pa0, pa2, bv[2 * h2], bv[2 * h2 + 1]);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left; the ring is reused below
  __syncthreads();

  // merge the warps through shared memory (the ring is free now)
  l_r += __shfl_xor_sync(FULL, l_r, 1);
  l_r += __shfl_xor_sync(FULL, l_r, 2);
  float* wo = reinterpret_cast<float*>(smem + GMAX * HD * 2);  // [MMA_WARPS][GMAX][WS]
  float* wml = wo + MMA_WARPS * GMAX * WS;                     // [MMA_WARPS][GMAX][2]
  const int g = lane >> 2;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    *reinterpret_cast<float2*>(&wo[(warp * GMAX + g) * WS + 8 * j + 2 * tq]) =
        make_float2(o[j][0], o[j][1]);
  if (tq == 0) {
    wml[(warp * GMAX + g) * 2] = m_r;
    wml[(warp * GMAX + g) * 2 + 1] = l_r;
  }
  __syncthreads();
  for (int i = tid; i < gc * HD; i += MMA_THREADS) {
    const int gg = i / HD, d = i % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) M = fmaxf(M, wml[(w * GMAX + gg) * 2]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      const float c = exp2f(wml[(w * GMAX + gg) * 2] - M);
      L += c * wml[(w * GMAX + gg) * 2 + 1];
      A += c * wo[(w * GMAX + gg) * WS + d];
    }
    pacc[(long)gg * n_pieces * HD + d] = A;
    if (d == 0) {
      stats[2L * gg * n_pieces] = M * LN2;  // natural units, as the combine reads them
      stats[2L * gg * n_pieces + 1] = L;
    }
  }
}

// ---------------------------------------------------------------------------
// combine
// ---------------------------------------------------------------------------

// Merge the pieces of one (b, h): one block, one thread per column.  Each
// warp reads the pieces' (m, l) lane-parallel and reduces M with shuffles.
// Then, 32 pieces at a time, each lane's weight exp(m - M) is broadcast by
// shuffle, and every thread loads its column of the 32 pieces at once and
// sums it.  A neutral piece (l = 0) wrote no acc and is skipped.
template <typename T, int HD>
__global__ void decode_combine(const float* __restrict__ part, T* __restrict__ out, int BH,
                               int n_pieces) {
  const int row = blockIdx.x;  // b * H + h
  const int d = threadIdx.x, lane = d & 31;
  const float2* st = reinterpret_cast<const float2*>(part) + (long)row * n_pieces;
  const float* ac = part + 2L * BH * n_pieces + (long)row * n_pieces * HD + d;
  float M = NEG_INF;
  for (int p = lane; p < n_pieces; p += 32) {
    const float2 ml = st[p];
    if (ml.y > 0.f) M = fmaxf(M, ml.x);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, off));
  float L = 0.f, A = 0.f;
  for (int p0 = 0; p0 < n_pieces; p0 += 32) {
    float c = 0.f;  // weight of piece p0 + lane; 0 past n_pieces
    if (p0 + lane < n_pieces) {
      const float2 ml = st[p0 + lane];
      if (ml.y > 0.f) {
        c = expf(ml.x - M);
        L += c * ml.y;
      }
    }
    float x[32];
#pragma unroll
    for (int u = 0; u < 32; ++u)
      x[u] = __shfl_sync(FULL, c, u) > 0.f ? ac[(long)(p0 + u) * HD] : 0.f;
#pragma unroll
    for (int u = 0; u < 32; ++u) A = fmaf(__shfl_sync(FULL, c, u), x[u], A);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(FULL, L, off);
  store(out + (long)row * HD + d, A / (L == 0.f ? 1.f : L));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos, void* o,
                   float* part, int B, int T_len, int H, int KV, int piece_len, int window,
                   float softcap, float scale, cudaStream_t stream) {
  const int n_hc = (H / KV + GMAX - 1) / GMAX;
  const int n_pieces = (T_len + piece_len - 1) / piece_len;
  dim3 grid(n_pieces, KV * n_hc, B);
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>) {
    constexpr size_t smem = split_smem_bytes<HD>();
    err = cudaFuncSetAttribute(decode_split<float, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    decode_split<float, HD><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), pos, part, T_len, H, KV, n_pieces, piece_len, window,
        softcap, scale);
  } else {
    constexpr size_t smem = mma_smem_bytes<HD>();
    static_assert(sizeof(float) * MMA_WARPS * GMAX * (merge_stride<HD>() + 2) <=
                      2 * (size_t)STAGES * 2 * TILE * HD,
                  "the warps' merge must fit in the ring");
    err = cudaFuncSetAttribute(decode_split_mma_bf16<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    decode_split_mma_bf16<HD><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
        part, T_len, H, KV, n_pieces, piece_len, window, softcap, scale);
  }
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
