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
// of k and hd of v, used for 4*hd FLOPs per query head of its group: at
// most 8 FLOPs per byte at H/KV = 8 in bf16 (against the ~295 the tensor
// cores need before they, and not the memory, are the limit) and 4 in f32
// (against the CUDA cores' 20: 67 TFLOP/s over 3.35 TB/s).  So both routes
// move every visible KV byte once, keep enough loads in flight, and do
// their arithmetic where the type puts it:
//  - bf16: two launches.  decode_split_mma_bf16 serves all H/KV query heads
//    (up to 8; larger groups take several blocks) of one (batch row, kv
//    head) per block, so each K and V row is read once and used for the
//    whole group (the Pallas grid (B, H, T/bk) fetched every KV tile H/KV
//    times).  T is split into pieces of 64-512 positions, one block each
//    (flash-decoding), so that B*KV = 4 still fills the 132 SMs; a piece
//    wholly outside the visible rows reads nothing and writes a neutral
//    partial (l = 0).  q kᵀ and P V run on the tensor cores (mma.sync
//    m16n8k16, bf16 operands, f32 accumulators), the group's heads on the M
//    dimension (padded to 16 with zero rows), K and V tiles of 64 rows
//    streamed by cp.async through a 2-stage ring, 4 warps splitting each
//    tile's rows.  decode_combine then merges the pieces of each (b, h).
//  - f32: one launch, decode_split_f32, f32 FMAs on the CUDA cores (the
//    route is bound by bytes even there, so the tensor cores' TF32 passes
//    would buy nothing).  Its design:
//    1. The visible rows spread evenly over a grid of one wave.  A unit is
//       (batch row, kv head, chunk of up to 8 query heads); every block
//       reads pos, takes the units' visible rows in 32-row tiles (from each
//       unit's first visible row), in unit order, as one run of R tiles and
//       keeps tiles [i R / G, (i + 1) R / G), G = min(grid, R): the tiles of
//       two blocks differ by at most one, a unit may be split over blocks,
//       and a block may cover the ends of two units and any units between.
//       The grid is the SMs times the blocks an SM holds; no block reads a
//       row outside its unit's visible range, and the host never reads pos.
//    2. K and V stream through a 3-stage ring of 32-row slices in shared
//       memory by 16-byte cp.async, two slices in flight while one is
//       computed; a slice's 16-byte chunks are XOR-swizzled by row % 8.  A
//       block is hd / 32 warps; its ring lets an SM hold 4 / 2 / 1 blocks
//       at hd 64 / 128 / 256, 8 warps and 64-128 KB in flight, so the
//       registers are bounded for 8 warps an SM (the 8-head builds spill
//       under 128 and run no faster).
//    3. No shuffle chain per key.  Warp w owns columns 32w..32w+31 of hd.
//       In q kᵀ lane j scores key j of the slice for every head over the
//       warp's columns (K from the ring without bank conflicts, q
//       broadcast); the warps' partial dots meet in shared memory, and the
//       online softmax costs one max reduction per head per 32 keys.  In
//       P V lane c owns column 32w + c: V rows from the ring, P broadcast.
//    4. The merge in the same launch.  A block that holds a whole unit
//       writes its output.  Otherwise it writes one partial (m, l, acc) per
//       unit it shares and counts it on a counter (MergeTree); the block
//       that brings a count to its total merges those partials in block
//       order (never arrival order) and sets the counter back to 0.  A unit
//       of up to 16 blocks merges in one step; beyond, in groups of
//       ceil(sqrt(n)) blocks, then the groups, so that no block reads more
//       than 32 partials.  So outputs are bit-identical from call to call,
//       and there is no second launch.  The counts are release (-acquire)
//       atomics by one thread after a block barrier: the partial of the
//       block's first unit right after the next barrier (its stores done,
//       and early, so the block seldom merges that unit), the last one once
//       the walk is done.  The counters sit at the front of the scratch,
//       which the wrapper keeps per stream (zeroed once): calls on one
//       stream run in turn and find them at 0, calls on two streams never
//       share them.
//
// The TPU kernel's guards are kept: p = mask ? exp(s - m) : 0, and l == 0 -> 1
// in the final divide, so a row with no visible key gives 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int GMAX = 8;                    // query heads per block (a unit of the f32 route)
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -2.3819763e38f;  // bf16-safe large negative, as in the reference

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

// Partial (m, l, acc) of one piece for up to GMAX query heads, in the
// scratch layout decode_combine reads: stats (B*H, n_pieces, 2) then acc
// (B*H, n_pieces, HD).  The piece's visible rows [lo, hi) are walked in
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

// ---------------------------------------------------------------------------
// f32: one launch on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSlice = 32;        // rows a ring stage holds: one key a lane in q kᵀ
constexpr int kStages = 3;        // ring depth: two slices load while one is computed
constexpr int kMaxBlocks = 1024;  // grid cap: a merge takes at most 32 partials
constexpr int kFlat = 16;         // a unit of up to 16 blocks merges in one level

// Shared memory of decode_split_f32<HD, GC> in floats: the ring (kStages x a
// K slice and a V slice of kSlice rows of HD floats), kStages - 1 buffers of
// q rows (GC heads; the block's segment n reads buffer n % 2: a buffer is
// refilled only after every slice of the segment two before has been
// scored), the warps' partial dots [NW][GC][kSlice], the probabilities
// [kSlice][GC], each head's rescale and (m, l), and 16 words of 64 bits for
// the schedule.
template <int HD, int GC>
struct F32Smem {
  static constexpr int NW = HD / 32;             // warp w owns columns 32w..32w+31
  static constexpr int THREADS = 32 * NW;
  static constexpr int STAGE = 2 * kSlice * HD;  // K slice, then V slice
  static constexpr int QBUF = kStages * STAGE;
  static constexpr int PART = QBUF + (kStages - 1) * GC * HD;
  static constexpr int PROB = PART + NW * GC * kSlice;
  static constexpr int CORR = PROB + kSlice * GC;
  static constexpr int ML = CORR + GMAX;
  static constexpr int MISC = ML + 2 * GMAX;
  static constexpr size_t BYTES = sizeof(float) * (MISC + 32);
  static constexpr int SLOT = GMAX * (HD + 2);   // a partial in scratch: (m, l) x 8, acc x 8
  static_assert(kStages == 3, "two q buffers serve a ring of three stages");
  static_assert(MISC % 4 == 0, "64-bit words need 8-byte alignment");
  static_assert(32 * 32 >= kMaxBlocks && 32 * GC <= QBUF, "a merge's weights fit the ring");
  static_assert(BYTES <= 232448, "more shared memory than a block can have");
};

// Float offset of 16-byte chunk c of row r in a ring slice: chunks XOR-
// swizzled by r % 8, so that 8 lanes reading chunk c of 8 rows (q kᵀ) hit 8
// distinct groups of 4 banks, and a warp reading 32 columns of one row (P V)
// hits 32 distinct banks.
__device__ __forceinline__ int f32_swz(int r, int c) { return (c ^ (r & 7)) << 2; }

// The f32 route's units and their visible rows.  Unit u is (batch row u /
// per_b, kv head (u % per_b) / n_hc, head chunk u % n_hc).
struct Units {
  const int* pos;
  int U, per_b, n_hc, group, T, window;
  __device__ __forceinline__ void visible(int u, int& lo, int& len) const {
    const int p = __ldg(pos + u / per_b);
    const int hi = min(p + 1, T);
    lo = window > 0 ? max(p - window + 1, 0) : 0;
    len = max(hi - lo, 0);
  }
};

__device__ __forceinline__ int tiles_of(int rows) { return (rows + kSlice - 1) / kSlice; }

// Where a block is in its tiles: unit u (-1 once done), the unit's rows
// [lo, hi) this block reads, the current slice's first row r, the unit's
// tiles nt and its first tile g0 in the run of all units' tiles, and the
// segment's ordinal in the block.  Every thread holds the same walk.
struct Walk {
  int u, lo, hi, r, nt, ord;
  long long g0;
};

// The segment of unit w.u that starts at its tile a, up to the block's end
// s_end (a tile of the run).
__device__ __forceinline__ void walk_enter(Walk& w, const Units& un, int a, long long s_end) {
  int lo, len;
  un.visible(w.u, lo, len);
  w.nt = tiles_of(len);
  w.lo = lo + kSlice * a;
  w.hi = lo + (int)min((long long)len, kSlice * (s_end - w.g0));
  w.r = w.lo;
}

__device__ __forceinline__ void walk_next(Walk& w, const Units& un, long long s_end) {
  w.r += kSlice;
  if (w.r < w.hi) return;
  w.g0 += w.nt;
  ++w.ord;
  while (w.g0 < s_end && ++w.u < un.U) {
    int lo, len;
    un.visible(w.u, lo, len);
    if (len > 0) {
      walk_enter(w, un, 0, s_end);
      return;
    }
  }
  w.u = -1;
}

// The block whose tiles [i R / G, (i + 1) R / G) hold tile r of the run.
__device__ __forceinline__ int block_of(long long r, int G, long long R) {
  return (int)(((r + 1) * G - 1) / R);
}

// atomicAdd with release and acquire semantics at the card's scope: after a
// __syncthreads, the block's stores before it are visible to whoever sees
// the count, and what those saw is visible to this block after the next one.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// The same with release semantics only: its result is not waited for until
// used, and a block that finds itself last takes fence_acq_rel before it
// reads what the others released.
__device__ __forceinline__ int atomic_add_release(int* p, int v) {
  int old;
  asm volatile("atom.release.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}
__device__ __forceinline__ void fence_acq_rel() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

// Inclusive prefix sum over the block (NW warps) of x; total gets the sum
// of all.  red holds NW words of 64 bits.
template <int NW>
__device__ __forceinline__ long long block_scan(long long x, long long* red, long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  long long before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const long long t = red[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();
  return x + before;
}

// How the partials of a unit held by n > 1 blocks (bf .. bf + n - 1) are
// merged: up to kFlat, all at once by the last block to count its partial;
// beyond, in groups of fan_in = ceil(sqrt(n)) consecutive blocks, each
// merged by its last block to count into a group slot, then the groups by
// the last group to count, always in block order.  Block bf + j writes its
// partial of the unit into slot 2 (bf + j) + (0 if the unit is the first it
// holds, else 1): only bf's unit can be its last.  A group's counter and
// slot are those of its first member's partial.
struct MergeTree {
  int bf, n, fan_in, groups, first_which;
  __device__ MergeTree(int bf_, int n_, long long g0, int G, long long R) : bf(bf_), n(n_) {
    fan_in = 1;
    while (fan_in * fan_in < n) ++fan_in;
    if (n <= kFlat) fan_in = n;
    groups = (n + fan_in - 1) / fan_in;
    first_which = (long long)bf * R / G < g0 ? 1 : 0;
  }
  __device__ int group_of(int j) const { return j / fan_in; }
  __device__ int group_size(int gi) const { return min(fan_in, n - gi * fan_in); }
  __device__ int member_slot(int j) const { return 2 * (bf + j) + (j == 0 ? first_which : 0); }
  __device__ int slot(int gi) const { return member_slot(gi * fan_in); }
};

template <int GC>
__device__ __forceinline__ void load_probs(const float* p, float (&x)[GC]) {
  if constexpr (GC % 4 == 0) {
#pragma unroll
    for (int g = 0; g < GC; g += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + g);
      x[g] = t.x;
      x[g + 1] = t.y;
      x[g + 2] = t.z;
      x[g + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int g = 0; g < GC; ++g) x[g] = p[g];
  }
}

// One launch of the f32 route (file note, design 1-4).  GC is the query
// heads a unit scores, rounded up to 1, 2, 4 or 8 (heads past the unit's
// read its last head's q and are never written).  Scratch: U int32 counts
// of a unit's merged groups and 2 grid counts of a group's partials
// (MergeTree), all 0 at launch and left at 0, padded to 4; then two partial
// slots of F32Smem::SLOT floats a block, and as many group slots.
template <int HD, int GC>
__global__ void __launch_bounds__(HD, 256 / HD)  // the 8 warps an SM its shared memory allows
decode_split_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ pos,
                 float* __restrict__ out, int* __restrict__ scratch, int B, int T, int H,
                 int KV, int window, float softcap, float scale) {
  using L = F32Smem<HD, GC>;
  constexpr int NW = L::NW, THREADS = L::THREADS;
  constexpr int CPR = HD / 4;                  // 16-byte chunks a row
  constexpr int HPW = (GC + NW - 1) / NW;      // heads a warp runs the softmax of
  extern __shared__ __align__(16) float sm[];
  long long* misc = reinterpret_cast<long long*>(sm + L::MISC);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = H / KV, n_hc = (group + GMAX - 1) / GMAX;
  const Units un{pos, B * KV * n_hc, KV * n_hc, n_hc, group, T, window};
  int* unit_count = scratch;                 // [U] groups of a unit merged
  int* group_count = scratch + un.U;         // [2 grid] partials of a group in
  float* slots = reinterpret_cast<float*>(scratch) + ((un.U + 2 * gridDim.x + 3) & ~3);
  float* group_slots = slots + 2L * gridDim.x * L::SLOT;

  // R, the visible tiles of all units (a unit's visible rows in tiles of
  // kSlice from its first); a unit with none gives zeros, written by block
  // u % gridDim.x
  long long R = 0, incl0 = 0;  // incl0, nt0: this thread's unit of the first THREADS
  int nt0 = 0;
  for (int c0 = 0; c0 < un.U; c0 += THREADS) {
    int lo = 0, len = 0;
    if (c0 + tid < un.U) un.visible(c0 + tid, lo, len);
    long long tot;
    const int nt = tiles_of(len);
    const long long incl = R + block_scan<NW>(nt, misc, tot);
    if (c0 == 0) {
      incl0 = incl;
      nt0 = nt;
    }
    R += tot;
  }
  for (int u = blockIdx.x; u < un.U; u += gridDim.x) {
    int lo, len;
    un.visible(u, lo, len);
    if (len == 0) {
      const int rem = u % un.per_b, hc = rem % n_hc;
      const int h0 = (rem / n_hc) * group + hc * GMAX, gc = min(GMAX, group - hc * GMAX);
      for (int i = tid; i < gc * HD; i += THREADS) out[((long)(u / un.per_b) * H + h0) * HD + i] = 0.f;
    }
  }

  // this block's tiles [s_beg, s_end) of the run, and the unit that holds
  // s_beg: G = min(grid, R) blocks take tiles, each at least one, so that
  // the blocks of a unit are consecutive and all hold some of it
  const int G = (int)min((long long)gridDim.x, max(R, 1LL));
  const bool takes_tiles = (int)blockIdx.x < G;
  const long long s_beg = takes_tiles ? (long long)blockIdx.x * R / G : 0;
  const long long s_end = takes_tiles ? (long long)(blockIdx.x + 1) * R / G : 0;
  Walk cw{-1, 0, 0, 0, 0, 0, 0};
  if (s_beg < s_end && un.U <= THREADS) {  // the one scan above found it
    if (nt0 > 0 && incl0 - nt0 <= s_beg && s_beg < incl0) {
      misc[8] = tid;
      misc[9] = incl0 - nt0;
    }
  } else if (s_beg < s_end) {
    long long base = 0;
    for (int c0 = 0; c0 < un.U; c0 += THREADS) {
      const int u = c0 + tid;
      int lo = 0, len = 0;
      if (u < un.U) un.visible(u, lo, len);
      long long tot;
      const int nt = tiles_of(len);
      const long long incl = base + block_scan<NW>(nt, misc, tot);
      if (nt > 0 && incl - nt <= s_beg && s_beg < incl) {
        misc[8] = u;
        misc[9] = incl - nt;
      }
      base += tot;
      if (base > s_beg) break;
    }
  }
  __syncthreads();
  if (s_beg < s_end) {
    cw.u = (int)misc[8];
    cw.g0 = misc[9];
    walk_enter(cw, un, (int)(s_beg - cw.g0), s_end);
  }
  __syncthreads();
  if (tid == 0) misc[10] = 0;  // partials this block wrote: misc[11 + 2i] unit, misc[12 + 2i] g0

  // a slice's K and V rows (rows past hi arrive as zeros: no row outside
  // [lo, hi) is read) and, for a segment's first slice, its unit's q rows
  auto load_slice = [&](const Walk& w, int stage) {
    const int b = w.u / un.per_b, rem = w.u % un.per_b, kvh = rem / n_hc, hc = rem % n_hc;
    const long row_stride = (long)KV * HD;
    const float* kb = k + ((long)b * T * KV + kvh) * HD;
    const float* vb = v + ((long)b * T * KV + kvh) * HD;
    const int n_rows = min(kSlice, w.hi - w.r);
    const uint32_t sk = smem_u32(sm + stage * L::STAGE), sv = sk + kSlice * HD * 4;
#pragma unroll
    for (int j = 0; j < kSlice * CPR / THREADS; ++j) {
      const int i = tid + j * THREADS, r = i / CPR, c = i % CPR;
      const bool ok = r < n_rows;
      const long off = (long)(w.r + (ok ? r : 0)) * row_stride + c * 4;
      const uint32_t d = (uint32_t)(r * HD + f32_swz(r, c)) * 4;
      cp_async16(sk + d, kb + off, ok);
      cp_async16(sv + d, vb + off, ok);
    }
    if (w.r == w.lo) {
      const int h0 = kvh * group + hc * GMAX, gc = min(GMAX, group - hc * GMAX);
      const uint32_t sq = smem_u32(sm + L::QBUF + (w.ord & 1) * GC * HD);
      for (int i = tid; i < GC * CPR; i += THREADS) {
        const int g = i / CPR, c = i % CPR;
        cp_async16(sq + i * 16, q + ((long)b * H + h0 + min(g, gc - 1)) * HD + c * 4, true);
      }
    }
  };

  // the ring's first kStages - 1 slices, one commit group each (empty past
  // the block's last slice)
  Walk ld = cw;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (ld.u >= 0) {
      load_slice(ld, s);
      walk_next(ld, un, s_end);
    }
    cp_async_commit();
  }

  float m[HPW], l[HPW], acc[GC];
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    m[j] = NEG_INF;
    l[j] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < GC; ++g) acc[g] = 0.f;
  const int col = warp * 32 + lane;               // this thread's column in P V
  // A partial of the block's first unit that is not its last is counted
  // right after the next barrier (its stores done by then): early, so that
  // the block rarely completes that unit's group, and off the walk's path.
  // Thread 0 keeps the count it saw and the group's size.
  bool count_first = false;
  int first_slot = 0, first_size = 0, first_seen = -1;
  cp_async_wait<kStages - 2>();
  __syncthreads();

  for (int i = 0; cw.u >= 0; ++i) {
    const float* kt = sm + (i % kStages) * L::STAGE;
    const float* vt = kt + kSlice * HD;
    const float* qs = sm + L::QBUF + (cw.ord & 1) * GC * HD;

    // q kᵀ over this warp's 32 columns: lane = key
    {
      float s[GC];
#pragma unroll
      for (int g = 0; g < GC; ++g) s[g] = 0.f;
      const float* krow = kt + lane * HD;
      constexpr int QK_UNROLL = GC == 8 ? 4 : 8;  // fewer q loads in flight at 8 heads
#pragma unroll QK_UNROLL
      for (int c = 0; c < 8; ++c) {
        const int chunk = warp * 8 + c;
        const float4 kk = *reinterpret_cast<const float4*>(krow + f32_swz(lane, chunk));
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float4 qq = *reinterpret_cast<const float4*>(qs + g * HD + chunk * 4);
          s[g] = fmaf(qq.x, kk.x, s[g]);
          s[g] = fmaf(qq.y, kk.y, s[g]);
          s[g] = fmaf(qq.z, kk.z, s[g]);
          s[g] = fmaf(qq.w, kk.w, s[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) sm[L::PART + (warp * GC + g) * kSlice + lane] = s[g];
    }
    __syncthreads();  // partial dots in; every warp is done with the slice before
    if (count_first) {
      if (tid == 0) first_seen = atomic_add_release(group_count + first_slot, 1);
      count_first = false;
    }
    if (ld.u >= 0) {  // into the slice before's stage
      load_slice(ld, (i + kStages - 1) % kStages);
      walk_next(ld, un, s_end);
    }
    cp_async_commit();

    // online softmax: warp w runs heads w, w + NW, ... (lane = key)
    const bool key_ok = cw.r + lane < cw.hi;
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      const int g = warp + j * NW;
      if (g < GC) {
        float x = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) x += sm[L::PART + (w * GC + g) * kSlice + lane];
        x *= scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        x = key_ok ? x : NEG_INF;
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float m_new = fmaxf(m[j], mx);
        const float corr = expf(m[j] - m_new);
        const float p = key_ok ? expf(x - m_new) : 0.f;
        l[j] = l[j] * corr + p;
        m[j] = m_new;
        sm[L::PROB + lane * GC + g] = p;
        if (lane == 0) sm[L::CORR + g] = corr;
      }
    }
    cp_async_wait<kStages - 2>();  // this thread's part of the next slice has landed
    __syncthreads();               // P in, and everyone's part of the next slice

    // O = O corr + P V: lane = column
    {
#pragma unroll
      for (int g = 0; g < GC; ++g) acc[g] *= sm[L::CORR + g];
      const int chunk = col >> 2, e = col & 3, n_rows = min(kSlice, cw.hi - cw.r);
      constexpr int PV_UNROLL = GC == 8 ? 2 : 4;  // fewer P loads in flight at 8 heads
#pragma unroll PV_UNROLL
      for (int r = 0; r < n_rows; ++r) {
        const float vv = vt[r * HD + f32_swz(r, chunk) + e];
        float p[GC];
        load_probs<GC>(sm + L::PROB + r * GC, p);
#pragma unroll
        for (int g = 0; g < GC; ++g) acc[g] = fmaf(p[g], vv, acc[g]);
      }
    }

    if (cw.r + kSlice >= cw.hi) {  // the segment's last slice
#pragma unroll
      for (int j = 0; j < HPW; ++j) {
        const int g = warp + j * NW;
        if (g < GC) {
          float lt = l[j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) lt += __shfl_xor_sync(FULL, lt, off);
          if (lane == 0) {
            sm[L::ML + 2 * g] = m[j];
            sm[L::ML + 2 * g + 1] = lt;
          }
          m[j] = NEG_INF;
          l[j] = 0.f;
        }
      }
      __syncthreads();
      const int b = cw.u / un.per_b, rem = cw.u % un.per_b, hc = rem % n_hc;
      const int h0 = (rem / n_hc) * group + hc * GMAX, gc = min(GMAX, group - hc * GMAX);
      const int bf = block_of(cw.g0, G, R), bl = block_of(cw.g0 + cw.nt - 1, G, R);
      if (bf == bl) {  // the whole unit is this block's
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float lt = sm[L::ML + 2 * g + 1];
          if (g < gc) out[((long)b * H + h0 + g) * HD + col] = acc[g] / (lt == 0.f ? 1.f : lt);
        }
      } else {
        float* slot = slots + ((long)blockIdx.x * 2 + (cw.ord == 0 ? 0 : 1)) * L::SLOT;
#pragma unroll
        for (int g = 0; g < GC; ++g) slot[2 * GMAX + g * HD + col] = acc[g];
        if (tid < 2 * GC) slot[tid] = sm[L::ML + tid];
        if (tid == 0) {  // counted later, so that no warp waits on it here
          const long long n = misc[10];
          misc[11 + 2 * n] = cw.u;
          misc[12 + 2 * n] = cw.g0;
          misc[10] = n + 1;
        }
        if (cw.ord == 0) {
          const MergeTree mt(bf, bl - bf + 1, cw.g0, G, R);
          const int gi = mt.group_of((int)blockIdx.x - bf);
          count_first = true;
          first_slot = mt.slot(gi);
          first_size = mt.group_size(gi);
        }
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) acc[g] = 0.f;
    }
    walk_next(cw, un, s_end);
  }
  cp_async_wait<0>();  // only empty groups are left; the ring is reused below
  __syncthreads();     // the block's partials are stored

  // the merge trees of the (at most two) partials this block wrote: warp t
  // counts partial t; misc[8 + t] says what this block then merges
  const int n_parts = (int)misc[10];
  auto tree_of = [&](int t) {
    int lo, len;
    un.visible((int)misc[11 + 2 * t], lo, len);
    const long long g0 = misc[12 + 2 * t];
    const int bf = block_of(g0, G, R);
    return MergeTree(bf, block_of(g0 + tiles_of(len) - 1, G, R) - bf + 1, g0, G, R);
  };
  if (lane == 0 && warp < n_parts) {
    const MergeTree mt = tree_of(warp);
    const int gi = mt.group_of((int)blockIdx.x - mt.bf);
    bool last;
    if (warp == 0 && first_seen >= 0) {  // counted early (thread 0)
      last = first_seen == first_size - 1;
      if (last) fence_acq_rel();
    } else {
      last = atomic_add_acq_rel(group_count + mt.slot(gi), 1) == mt.group_size(gi) - 1;
    }
    if (last) group_count[mt.slot(gi)] = 0;  // the group's last block: it merges the group
    misc[8 + warp] = last;
  }
  __syncthreads();

  // Merge count <= 32 partials, src(c) the c-th in order, into the output of
  // unit u (dst null) or into slot dst: lane c of a head's warp reads
  // partial c's (m, l) and writes its weight exp(m - M) to the ring; then a
  // thread a column sums the partials in order.  The columns of the first
  // 64 / GC partials are loaded with the weights (a merge of the timed
  // shapes, one round trip)
  auto merge = [&](auto src, int count, int u, float* dst) {
    constexpr int BATCH = GC == 1 ? 32 : 64 / GC;  // partials whose columns load at once
    float* wts = sm;  // [count][GC]
    float x[BATCH][GC];
    auto load_batch = [&](int c0) {
#pragma unroll
      for (int c = 0; c < BATCH; ++c) {
        const float* xs = src(min(c0 + c, count - 1)) + 2 * GMAX + col;
#pragma unroll
        for (int g = 0; g < GC; ++g) x[c][g] = __ldcg(xs + g * HD);
      }
    };
    load_batch(0);  // in flight while the weights are made
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      const int g = warp + j * NW;
      if (g < GC) {
        const float2 ml = lane < count ? __ldcg(reinterpret_cast<const float2*>(src(lane) + 2 * g))
                                       : make_float2(NEG_INF, 0.f);
        float M = ml.x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, off));
        const float w = lane < count ? expf(ml.x - M) : 0.f;
        if (lane < count) wts[lane * GC + g] = w;
        float lt = w * ml.y;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) lt += __shfl_xor_sync(FULL, lt, off);
        if (lane == 0) {
          sm[L::ML + 2 * g] = M;
          sm[L::ML + 2 * g + 1] = lt;
        }
      }
    }
    __syncthreads();
    float a[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) a[g] = 0.f;
    for (int c0 = 0; c0 < count; c0 += BATCH) {
      if (c0 > 0) load_batch(c0);
#pragma unroll
      for (int c = 0; c < BATCH; ++c) {
        if (c0 + c < count) {
#pragma unroll
          for (int g = 0; g < GC; ++g) a[g] = fmaf(wts[(c0 + c) * GC + g], x[c][g], a[g]);
        }
      }
    }
    if (dst != nullptr) {
#pragma unroll
      for (int g = 0; g < GC; ++g) dst[2 * GMAX + g * HD + col] = a[g];
      if (tid < 2 * GC) dst[tid] = sm[L::ML + tid];
    } else {
      const int b = u / un.per_b, rem = u % un.per_b, hc = rem % n_hc;
      const int h0 = (rem / n_hc) * group + hc * GMAX, gc = min(GMAX, group - hc * GMAX);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float lt = sm[L::ML + 2 * g + 1];
        if (g < gc) out[((long)b * H + h0 + g) * HD + col] = a[g] / (lt == 0.f ? 1.f : lt);
      }
    }
    __syncthreads();
  };

  // the groups this block completes (a unit of one group: its output), then,
  // counted by warp t as above, the units whose groups this block completes
  for (int t = 0; t < n_parts; ++t) {
    if (!misc[8 + t]) continue;
    const MergeTree mt = tree_of(t);
    const int u = (int)misc[11 + 2 * t], gi = mt.group_of((int)blockIdx.x - mt.bf);
    auto member = [&](int c) { return slots + (long)mt.member_slot(gi * mt.fan_in + c) * L::SLOT; };
    merge(member, mt.group_size(gi), u,
          mt.groups == 1 ? nullptr : group_slots + (long)mt.slot(gi) * L::SLOT);
  }
  if (lane == 0 && warp < n_parts) {  // merge() ends on a barrier: the stores are in
    const MergeTree mt = tree_of(warp);
    bool last = false;
    if (misc[8 + warp] && mt.groups > 1) {
      const int u = (int)misc[11 + 2 * warp];
      last = atomic_add_acq_rel(unit_count + u, 1) == mt.groups - 1;
      if (last) unit_count[u] = 0;  // the unit's last group: this block merges the groups
    }
    misc[8 + warp] = last;
  }
  __syncthreads();
  for (int t = 0; t < n_parts; ++t) {
    if (!misc[8 + t]) continue;
    const MergeTree mt = tree_of(t);
    merge([&](int c) { return group_slots + (long)mt.slot(c) * L::SLOT; }, mt.groups,
          (int)misc[11 + 2 * t], nullptr);
  }
}

// Blocks of decode_split_f32<HD, GC> an SM holds (its shared memory set
// first), cached per device.
template <int HD, int GC>
cudaError_t f32_occupancy(int device, int* blocks) {
  static int cached[16] = {};
  if (device >= 0 && device < 16 && cached[device] > 0) {
    *blocks = cached[device];
    return cudaSuccess;
  }
  using L = F32Smem<HD, GC>;
  cudaError_t err = cudaFuncSetAttribute(decode_split_f32<HD, GC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::BYTES);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, decode_split_f32<HD, GC>,
                                                      L::THREADS, L::BYTES);
  if (err != cudaSuccess) return err;
  if (*blocks <= 0) return cudaErrorInvalidConfiguration;
  if (device >= 0 && device < 16) cached[device] = *blocks;
  return cudaSuccess;
}

// The grid of one wave: blocks an SM holds x SMs, at most kMaxBlocks, and no
// more than a slice of rows each if every row of every unit were visible
// (kernel.py's f32_grid).
template <int HD, int GC>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const int* pos,
                       float* o, int* scratch, int B, int T_len, int H, int KV, int window,
                       float softcap, float scale, int device, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = f32_occupancy<HD, GC>(device, &per_sm);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long units = (long long)B * KV * ((H / KV + GMAX - 1) / GMAX);
  const long long rows_max = units * (window > 0 ? std::min(T_len, window) : T_len);
  long long grid = (long long)sms * per_sm;
  grid = std::min(grid, (long long)kMaxBlocks);
  grid = std::max(1LL, std::min(grid, (rows_max + kSlice - 1) / kSlice));
  using L = F32Smem<HD, GC>;
  decode_split_f32<HD, GC><<<(int)grid, L::THREADS, L::BYTES, stream>>>(
      q, k, v, pos, o, scratch, B, T_len, H, KV, window, softcap, scale);
  return cudaGetLastError();
}

// Heads a unit scores: H/KV up to 8, rounded up to 1, 2, 4 or 8.
inline int f32_heads(int group) { return group >= 5 ? 8 : group >= 3 ? 4 : group; }

template <int HD>
cudaError_t launch_f32_heads(int group, const float* q, const float* k, const float* v,
                             const int* pos, float* o, int* scratch, int B, int T_len, int H,
                             int KV, int window, float softcap, float scale, int device,
                             cudaStream_t stream) {
  switch (f32_heads(group)) {
    case 1:
      return launch_f32<HD, 1>(q, k, v, pos, o, scratch, B, T_len, H, KV, window, softcap, scale, device, stream);
    case 2:
      return launch_f32<HD, 2>(q, k, v, pos, o, scratch, B, T_len, H, KV, window, softcap, scale, device, stream);
    case 4:
      return launch_f32<HD, 4>(q, k, v, pos, o, scratch, B, T_len, H, KV, window, softcap, scale, device, stream);
    default:
      return launch_f32<HD, 8>(q, k, v, pos, o, scratch, B, T_len, H, KV, window, softcap, scale, device, stream);
  }
}

template <int HD>
cudaError_t occupancy_heads(int group, int device, int* blocks) {
  switch (f32_heads(group)) {
    case 1:
      return f32_occupancy<HD, 1>(device, blocks);
    case 2:
      return f32_occupancy<HD, 2>(device, blocks);
    case 4:
      return f32_occupancy<HD, 4>(device, blocks);
    default:
      return f32_occupancy<HD, 8>(device, blocks);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const int* pos, void* o,
                        float* part, int B, int T_len, int H, int KV, int piece_len, int window,
                        float softcap, float scale, cudaStream_t stream) {
  const int n_hc = (H / KV + GMAX - 1) / GMAX;
  const int n_pieces = (T_len + piece_len - 1) / piece_len;
  dim3 grid(n_pieces, KV * n_hc, B);
  constexpr size_t smem = mma_smem_bytes<HD>();
  static_assert(sizeof(float) * MMA_WARPS * GMAX * (merge_stride<HD>() + 2) <=
                    2 * (size_t)STAGES * 2 * TILE * HD,
                "the warps' merge must fit in the ring");
  cudaError_t err = cudaFuncSetAttribute(decode_split_mma_bf16<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using T = __nv_bfloat16;
  decode_split_mma_bf16<HD><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos, part,
      T_len, H, KV, n_pieces, piece_len, window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T, HD><<<B * H, HD, 0, stream>>>(part, static_cast<T*>(o), B * H, n_pieces);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (one launch of decode_split_f32; part: the scratch of
// kernel.py's f32_scratch_floats, its counters 0; piece_len unused), 1 =
// bfloat16 (split and combine; part: f32 scratch of B*H*ceil(T/piece_len)*
// (hd + 2) values).  Returns a cudaError_t (0 on success); the launches are
// asynchronous on `stream`.
int decode_attention_fwd(const void* q, const void* k, const void* v, const void* pos,
                         void* o, void* part, int B, int T_len, int H, int KV, int hd,
                         int dtype, int piece_len, int window, float softcap, float scale,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T_len <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (dtype == 0) {
    const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v);
    float* fo = static_cast<float*>(o);
    int* scratch = static_cast<int*>(part);
    const int group = H / KV;
    switch (hd) {
      case 64:
        return (int)launch_f32_heads<64>(group, fq, fk, fv, p, fo, scratch, B, T_len, H, KV, window, softcap, scale, device, st);
      case 128:
        return (int)launch_f32_heads<128>(group, fq, fk, fv, p, fo, scratch, B, T_len, H, KV, window, softcap, scale, device, st);
      case 256:
        return (int)launch_f32_heads<256>(group, fq, fk, fv, p, fo, scratch, B, T_len, H, KV, window, softcap, scale, device, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 1 || piece_len <= 0) return (int)cudaErrorInvalidValue;
  float* scratch = static_cast<float*>(part);
  switch (hd) {
    case 64:
      return (int)launch_bf16<64>(q, k, v, p, o, scratch, B, T_len, H, KV, piece_len, window, softcap, scale, st);
    case 128:
      return (int)launch_bf16<128>(q, k, v, p, o, scratch, B, T_len, H, KV, piece_len, window, softcap, scale, st);
    case 256:
      return (int)launch_bf16<256>(q, k, v, p, o, scratch, B, T_len, H, KV, piece_len, window, softcap, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the f32 route's kernel for head size hd and H/KV = group that an
// SM holds (kernel.py sizes the grid and the scratch with it), or a negative
// cudaError_t.
int decode_f32_blocks_per_sm(int hd, int group, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  switch (hd) {
    case 64:
      err = occupancy_heads<64>(group, device, &blocks);
      break;
    case 128:
      err = occupancy_heads<128>(group, device, &blocks);
      break;
    case 256:
      err = occupancy_heads<256>(group, device, &blocks);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
