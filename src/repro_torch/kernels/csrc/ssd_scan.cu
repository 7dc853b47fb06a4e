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
// x's type, h_final (B,nh,hd,N) f32.
//
// Decays from tile-local cumsums.  One f32 cumsum over a 256-step chunk
// reaches about -180 at mamba2's dt and a, so exp(cum_i - cum_j) taken as a
// difference of two such sums loses ~1e-4 in each weight: 5x the 2e-5 the
// reference's tests hold y to.  Here da is summed within tiles of SUB = 16
// positions (loc_i inclusive, rem_j the exclusive suffix, tot_s the tile's
// total), and every exponent is built from sums of terms of one sign, never
// from a difference of long sums:
//   cum_i - cum_j = loc_i - loc_j                       (same tile)
//   exp(cum_i - cum_j) = exp(loc_i) exp(mid(s_i, s_j)) exp(rem_j)
//                                                       (mid: tot over the
//                                                        tiles strictly between)
//   cum_last - cum_j = rem_j + suf(s_j),  cum_i = pre(s_i) + loc_i,
//   cum_last = sum of tot.
// Off the diagonal tile the three factors (each <= 1) are a row factor, a
// table entry and a column factor, so only the diagonal tile takes an expf
// per element.
//
// What bounds it on this card: operations.  Per (head, chunk) the products
// att @ x, C . h_prev^T and the state update are 3 * 2*Q*hd*N-sized (12.6
// MFLOP at mamba2-370m: Q=256, hd=64, N=128) on about 2*Q*hd*4 bytes of x
// and y.  On the tensor cores f32 operands go as split TF32 (v = hi + lo;
// hi.hi + hi.lo + lo.hi on mma.sync m16n8k8 with f32 accumulators, ~22 bits
// of each operand), and an operand that is bf16 is exact in TF32, so its
// products take two passes, not three.  At mamba2's types (x f32, B/C bf16)
// that is 7.6 GFLOP of TF32 passes at B=1, 15 us at the 495 TFLOP/s TF32
// peak, against 10.7 us for the bytes.  What the design does:
//  1. The Pallas grid (B*nh, NC) walked the chunks in order, carrying h in
//     VMEM.  Here the SSD's own split runs the chunks in parallel, in three
//     launches:
//       ssd_chunk_state  per (b*h, chunk): S_c = (x w)^T B with w_j =
//                        exp(cum_last - cum_j) dt_j, and exp(cum_last);
//                        x and B stream through a 2-stage cp.async ring of
//                        64-row tiles;
//       ssd_state_pass   per (b*h, 1024 state elements): h_c =
//                        exp(cum_last,c) h_{c-1} + S_c, NC steps, written in
//                        place over S_c as the state in force before chunk
//                        c, and h_final; 16-byte accesses, the loads of 8
//                        chunks in flight before their stores;
//       ssd_chunk_out    per (b, chunk, group of HG heads, pair of 64-row
//                        tiles): intra + inter.
//  2. C.B^T has no head axis.  ssd_chunk_out builds a tile's 64 rows of it
//     (columns up to the tile's diagonal) once in shared memory, as f32, and
//     then loops over its HG heads, which only rescale it by their decays:
//     C.B^T is computed nh/HG times per (b, chunk), not nh times.  A block
//     takes a long and a short tile (rows 192-255 and 0-63, or 128-191 and
//     64-127), so blocks carry equal work; at mamba2-370m B=1, HG = 4 gives
//     128 such blocks, one wave on 132 SMs.  Where that leaves the SMs
//     idle, the launch takes fewer heads a block, then single tiles.
//  3. Products: C.B^T on m16n8k16 bf16 (exact products, f32 sums: the
//     reference's f32 dot of upcast bf16) or, for f32 B/C, 3-pass TF32;
//     att.x 3 passes (2 for bf16 x); C.h_prev^T and (x w)^T.B 2 passes for
//     bf16 B/C, 3 for f32.  att is built in registers as the A fragment, from
//     C.B^T in shared memory; column tiles wholly above the diagonal are
//     skipped at 16 columns.  The tensor cores truncate as they accumulate,
//     so each 16-column step's passes start from zero and are added to the
//     running sum in f32: without that the kernel was 2.6x further from an
//     f64 recurrence than its own CPU emulation.  The passes run pass by pass
//     over 8 n-tiles, so that consecutive mma.sync are independent.
//  4. Operands arrive by cp.async (16-byte chunks) and are read into
//     fragments with 32-bit shared loads, and bf16 B of ssd_chunk_state with
//     ldmatrix.trans.  Rows are padded, not XOR-swizzled: a fragment read
//     touches 8 rows x 4 consecutive words, so a row stride of an odd
//     multiple of 4 words (operands read [row][k], or rows 2t and 2t + 1) or
//     of 8 or 24 words mod 32 (read [k][row]) puts the 32 lanes on 32 banks,
//     at every width down to hd = N = 16, where 8-chunk swizzles do not fit.
//  5. ssd_chunk_out runs 12 warps: warp w takes 16 output rows (w % 4) and
//     every third 16-column step of their k range (w / 4); the three partial
//     sums meet in shared memory before y is written.  The next head's state
//     loads during this head's att.x, and its x during C.h_prev^T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 16;              // positions per tile-local cumsum
constexpr int TQ = 64;               // y rows per ssd_chunk_out block; ring tile rows
constexpr int QMAX = 256;            // largest chunk
constexpr int NSMAX = QMAX / SUB;    // tile-local cumsums per chunk
constexpr int HGMAX = 4;             // heads per ssd_chunk_out block

template <typename T> struct Bf16 { static constexpr bool value = false; };
template <> struct Bf16<__nv_bfloat16> { static constexpr bool value = true; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Row strides, in 4-byte words, for rows of `words` words (a multiple of 4,
// so rows stay 16-byte aligned for cp.async).  rstride: operands read as
// [row g][k t] (g = lane / 4, t = lane % 4): an odd multiple of 4 words.
// kstride: operands read as [k t][row g]: 8 or 24 words mod 32.
__host__ __device__ constexpr int rstride(int words) {
  return ((words + 3) / 4) % 2 ? (words + 3) / 4 * 4 : (words + 3) / 4 * 4 + 4;
}
__host__ __device__ constexpr int kstride(int words) {
  int w = (words + 3) / 4 * 4;
  while (w % 32 != 8 && w % 32 != 24) w += 4;
  return w;
}
template <typename T>
__host__ __device__ constexpr int elems(int words) { return words * 4 / (int)sizeof(T); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// Two 8x8 b16 matrices, transposed: lane i (< 16) gives the address of row
// i % 8 of matrix i / 8; each lane gets, of each matrix, rows 2 (lane % 4)
// and + 1 of column lane / 4, the lower row in the lower half.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// rows x (cols of T) from global (row pitch `gpitch` elements) into shared
// (row pitch `spitch` elements), 16 bytes a thread per step; cols * sizeof(T)
// is 16 bytes times a power of two.
template <typename T, int NTHREADS = THREADS>
__device__ __forceinline__ void copy_rows(T* dst, int spitch, const T* src, long gpitch, int rows,
                                          int cols) {
  constexpr int EPC = 16 / sizeof(T);
  const int cpr = cols / EPC, shift = __ffs(cpr) - 1;  // chunks a row, a power of two
  for (int i = threadIdx.x; i < rows * cpr; i += NTHREADS) {
    const int r = i >> shift, c = (i & (cpr - 1)) * EPC;
    cp_async16(dst + r * spitch + c, src + r * gpitch + c);
  }
}

// v = hi + lo.  hi is v rounded to nearest (ties away) onto TF32's 10
// mantissa bits, as cvt.rna.tf32 gives it, in two integer operations (finite
// v; cvt.rna's inf/nan checks cost it four).  lo = v - hi is exact in f32 and
// goes to the tensor cores as it is: they read its top 10 mantissa bits, and
// the bits they drop are below 2^-23 of v.  An operand that is exact in TF32
// (a bf16 value) keeps its bits as hi and has no lo.
template <bool EXACT>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
  }
}

// d (16x8 f32) += a (16x8 tf32, row) b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d (16x8 f32) += a (16x16 bf16, row) b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The split product: hi.hi, then hi.lo and lo.hi where that operand is not
// exact (lo.lo, below 2^-22 of the product, is dropped).
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  if (!B_EXACT) mma_tf32(d, ah, bl0, bl1);
  if (!A_EXACT) mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bh0, bh1);
}
// d[e] += a b[e] for NT n-tiles, pass by pass, so that consecutive mma.sync
// are independent: hi.lo, lo.hi, then hi.hi.
template <bool A_EXACT, bool B_EXACT, int NT>
__device__ __forceinline__ void mma_passes(float (&d)[NT][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[NT][2],
                                           const uint32_t (&bl)[NT][2]) {
  if (!B_EXACT) {
#pragma unroll
    for (int e = 0; e < NT; ++e) mma_tf32(d[e], ah, bl[e][0], bl[e][1]);
  }
  if (!A_EXACT) {
#pragma unroll
    for (int e = 0; e < NT; ++e) mma_tf32(d[e], al, bh[e][0], bh[e][1]);
  }
#pragma unroll
  for (int e = 0; e < NT; ++e) mma_tf32(d[e], ah, bh[e][0], bh[e][1]);
}
// acc += d in f32 (round to nearest).  The tensor cores truncate as they
// accumulate, so each k-step's passes start from zero and are added here.
__device__ __forceinline__ void add4(float (&acc)[4], const float (&d)[4]) {
  acc[0] += d[0];
  acc[1] += d[1];
  acc[2] += d[2];
  acc[3] += d[3];
}

// Tile-local sums of da = dt * a over one (head, chunk): thread s < Q/SUB
// walks tile s.  dts = dt, loc = inclusive cumsum within the tile, rem =
// exclusive suffix sum within the tile, tot[s] = the tile's total.
__device__ __forceinline__ void tile_sums(const float* __restrict__ dt, float a, long first,
                                          int nh, int s, float* dts, float* loc, float* rem,
                                          float* tot) {
  float v[SUB];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < SUB; ++e) {
    const int j = s * SUB + e;
    const float d = dt[first + (long)j * nh];
    dts[j] = d;
    v[e] = d * a;
    run += v[e];
    loc[j] = run;
  }
  tot[s] = run;
  run = 0.f;
#pragma unroll
  for (int e = SUB - 1; e >= 0; --e) {
    rem[s * SUB + e] = run;
    run += v[e];
  }
}

// ---------------------------------------------------------------------------
// ssd_chunk_state: S_c (hd, N) of one (b*h, chunk) -> states, exp(cum_last)
// -> decay.  Warp w owns m-tile w % MT (16 rows of hd) and n-tiles w / MT +
// WN p (8 columns of N each).  The sum runs over positions, so a k8 step may
// take its rows in any order: slots t and t + 4 take rows 2t and 2t + 1.  Then
// ldmatrix.trans of row-major bf16 B hands each lane its two B values packed
// in one register.
// ---------------------------------------------------------------------------

template <typename TX, typename TB, int HD, int N>
struct StateSmem {
  // rows 2t and 2t + 1 are read together (see ssd_chunk_state): an odd
  // multiple of 4 words keeps them on distinct banks, and keeps the 8 rows of
  // an ldmatrix on distinct 16-byte groups
  static constexpr int XW = rstride(HD * (int)sizeof(TX) / 4);  // words per x row
  static constexpr int BW = rstride(N * (int)sizeof(TB) / 4);   // words per B row
  static constexpr size_t STAGE = 4 * (size_t)TQ * (XW + BW);   // bytes a ring stage
  static constexpr size_t BYTES = sizeof(float) * (4 * QMAX + 2 * NSMAX) + 2 * STAGE;
};

template <typename TX, typename TB, int HD, int N>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state(const TX* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const TB* __restrict__ bmat,
                float* __restrict__ states, float* __restrict__ decay, int L, int nh, int Q) {
  using S = StateSmem<TX, TB, HD, N>;
  constexpr bool B_EXACT = Bf16<TB>::value;  // x w is never exact: x is always split
  constexpr int MT = HD / 16, NT = N / 8;
  constexpr int WN = WARPS / MT;                    // warps along N
  constexpr int NPW = NT > WN ? NT / WN : 1;        // n-tiles a warp
  constexpr int XS = elems<TX>(S::XW), BS = elems<TB>(S::BW);

  extern __shared__ __align__(16) float smem[];
  float* dts = smem;
  float* loc = dts + QMAX;
  float* rem = loc + QMAX;
  float* w = rem + QMAX;
  float* tot = w + QMAX;
  float* suf = tot + NSMAX;
  unsigned char* ring = reinterpret_cast<unsigned char*>(suf + NSMAX);
  auto xs_of = [&](int st) { return reinterpret_cast<TX*>(ring + st * S::STAGE); };
  auto bs_of = [&](int st) {
    return reinterpret_cast<TB*>(ring + st * S::STAGE + 4 * (size_t)TQ * S::XW);
  };

  const int c = blockIdx.x, bh = blockIdx.y, NC = gridDim.x;
  const int b = bh / nh, h = bh % nh;
  const long pos0 = (long)b * L + (long)c * Q;  // first position, in (b*L + l) units
  const int CT = min(TQ, Q);                    // rows a ring tile
  const int n_tiles = Q / CT;
  auto load_tile = [&](int t) {
    const long p = pos0 + (long)t * CT;
    copy_rows(xs_of(t & 1), XS, x + (p * nh + h) * HD, (long)nh * HD, CT, HD);
    copy_rows(bs_of(t & 1), BS, bmat + p * N, N, CT, N);
  };
  load_tile(0);
  cp_async_commit();

  const int tid = threadIdx.x, NS = Q / SUB;
  if (tid < NS) tile_sums(dt, a[h], pos0 * nh + h, nh, tid, dts, loc, rem, tot);
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int s = NS - 1; s >= 0; --s) {
      suf[s] = run;
      run += tot[s];
    }
    run = 0.f;
    for (int s = 0; s < NS; ++s) run += tot[s];
    decay[(long)bh * NC + c] = expf(run);
  }
  __syncthreads();
  for (int j = tid; j < Q; j += THREADS) w[j] = expf(rem[j] + suf[j / SUB]) * dts[j];

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int wm = warp % MT, wn = warp / MT;
  const bool active = wn < NT;                  // N = 16 has fewer n-tiles than warps
  const int d0 = 16 * wm + g;
  float acc[NPW][4];
#pragma unroll
  for (int p = 0; p < NPW; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t landed for all; w written; everyone done with tile t - 1
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    if (!active) continue;
    const TX* xs = xs_of(t & 1);
    const TB* bs = bs_of(t & 1);
    const float* wt = w + t * CT;
    for (int k0 = 0; k0 < CT; k0 += 16) {
      // A = (x w)^T of two k8 steps: slot t is row k + 2t, slot t + 4 row k + 2t + 1
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = k0 + 8 * kk + 2 * t4 + (r >> 1), d = d0 + 8 * (r & 1);
          split<false>(to_f32(xs[k * XS + d]) * wt[k], ah[kk][r], al[kk][r]);
        }
      [[maybe_unused]] uint32_t mb[NPW][2];  // bf16 B of both k8 steps, two rows a register
      if constexpr (B_EXACT) {
#pragma unroll
        for (int p = 0; p < NPW; ++p)
          ldsm_x2_trans(smem_u32(bs + (k0 + (lane & 15)) * BS + 8 * (wn + WN * p)), mb[p]);
      }
      float d[NPW][4] = {};  // 16 rows' passes, then one f32 add
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t bh[NPW][2], bl[NPW][2];
#pragma unroll
        for (int p = 0; p < NPW; ++p) {
          if constexpr (B_EXACT) {
            bh[p][0] = mb[p][kk] << 16;  // the lower half holds row 2t
            bh[p][1] = mb[p][kk] & 0xffff0000u;
            bl[p][0] = bl[p][1] = 0u;
          } else {
            const int k = k0 + 8 * kk + 2 * t4, n = 8 * (wn + WN * p) + g;
            split<false>(bs[k * BS + n], bh[p][0], bl[p][0]);
            split<false>(bs[(k + 1) * BS + n], bh[p][1], bl[p][1]);
          }
        }
        mma_passes<false, B_EXACT>(d, ah[kk], al[kk], bh, bl);
      }
#pragma unroll
      for (int p = 0; p < NPW; ++p) add4(acc[p], d[p]);
    }
  }
  if (!active) return;
  float* out = states + ((long)bh * NC + c) * HD * N;
#pragma unroll
  for (int p = 0; p < NPW; ++p) {
    const int n0 = 8 * (wn + WN * p) + 2 * t4;
    store2(out + d0 * N + n0, acc[p][0], acc[p][1]);
    store2(out + (d0 + 8) * N + n0, acc[p][2], acc[p][3]);
  }
}

// ---------------------------------------------------------------------------
// ssd_state_pass: the carried state, chunk by chunk, in place: states[bh, c]
// <- the state before chunk c, and h_final <- the state after the last.  Two
// FLOPs and 8 bytes an element: bound by bytes.  The in-place store to chunk
// c and the load from chunk c + 1 go through one pointer, so the compiler
// keeps them in program order: a loop that loads and stores one chunk at a
// time has one load in flight.  So a thread owns 4 consecutive elements
// (16-byte loads and stores) and issues the loads of PASS_BATCH chunks
// before any store; the batch loop carries hs, so any NC works.  A block
// reads its bh's decays once, a batch at a time, into shared memory.  hs =
// decay * hs + sc contracts to one fma, as in the reference's order of the
// recurrence.  No streaming hint on the stores: ssd_chunk_out reads the
// states next, from L2.
// ---------------------------------------------------------------------------

constexpr int PASS_BATCH = 8;  // chunks whose loads are in flight together

__global__ void __launch_bounds__(THREADS)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ decay,
               float* __restrict__ h_final, int NC, int size) {
  __shared__ float dec[PASS_BATCH];
  const int e = blockIdx.x * THREADS + threadIdx.x;       // float4 of the state
  const int bh = blockIdx.y;
  const long step = size / 4;                             // float4s a chunk
  const bool live = e < step;
  float4* s = reinterpret_cast<float4*>(states) + (long)bh * NC * step + e;
  float4 hs = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < NC; c0 += PASS_BATCH) {
    const int nb = min(PASS_BATCH, NC - c0);
    float4 sc[PASS_BATCH];
#pragma unroll
    for (int i = 0; i < PASS_BATCH; ++i)
      if (live && i < nb) sc[i] = s[(c0 + i) * step];
    if (threadIdx.x < nb) dec[threadIdx.x] = decay[(long)bh * NC + c0 + threadIdx.x];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PASS_BATCH; ++i)
      if (live && i < nb) {
        s[(c0 + i) * step] = hs;
        const float d = dec[i];
        hs.x = d * hs.x + sc[i].x;
        hs.y = d * hs.y + sc[i].y;
        hs.z = d * hs.z + sc[i].z;
        hs.w = d * hs.w + sc[i].w;
      }
    __syncthreads();  // dec read before the next batch writes it
  }
  if (live) reinterpret_cast<float4*>(h_final)[(long)bh * step + e] = hs;
}

// ---------------------------------------------------------------------------
// ssd_chunk_out: y of one (b, chunk) for HG heads, over two row tiles of TR
// rows, a long one and a short one (tiles n-1-x and x of the chunk's n), so
// that every block has about the same work.  Within a tile, warp w takes the
// 16 rows rt = w % 4 and every KSPLIT-th step of their k range (kq = w / 4):
// 16-column steps of att.x, 8-column steps of C.h_prev^T, 8-column n-tiles of
// C.B^T.  The KSPLIT partial sums of y meet in shared memory.
// ---------------------------------------------------------------------------

constexpr int OUT_THREADS = 384;
constexpr int KSPLIT = OUT_THREADS / 32 / 4;
constexpr int GQ = (TQ / 8 + KSPLIT - 1) / KSPLIT;  // C.B^T n-tiles a warp, per column tile

template <typename TX, typename TB, int HD>
struct OutSmem {
  static constexpr int XW = kstride(HD * (int)sizeof(TX) / 4);
  static constexpr int RW = HD + 4;                                               // partial y row
  static __host__ __device__ int gw(int q) { return rstride(q); }                 // C.B^T row
  static __host__ __device__ int cw(int n) { return rstride(n * (int)sizeof(TB) / 4); }
  static __host__ __device__ int hw(int n) { return rstride(n); }                 // state row
  // words: decays (dts, loc, cdt per head; tot, mexp, pre), C.B^T rows, C
  // rows, then a region that holds the B column tiles (all of a tile's where
  // they fit, else a ring of two), then one head's x rows, then the partial
  // sums of y; then one head's state
  static constexpr size_t DECAY = (size_t)HGMAX * (3 * QMAX + NSMAX + 4 * NSMAX + NSMAX);
  static __host__ __device__ size_t region(int q, int n) {
    const size_t b_tiles = 2 * (size_t)TQ * cw(n);
    const size_t xrows = (size_t)q * XW;
    const size_t partial = (KSPLIT - 1) * (size_t)TQ * RW;
    const size_t m = b_tiles > xrows ? b_tiles : xrows;
    return m > partial ? m : partial;
  }
  static __host__ __device__ size_t bytes(int q, int n) {
    return 4 * (DECAY + (size_t)TQ * gw(q) + (size_t)TQ * cw(n) + region(q, n) +
                (size_t)HD * hw(n));
  }
};

template <typename TX, typename TB, int HD>
__global__ void __launch_bounds__(OUT_THREADS)
ssd_chunk_out(const TX* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a, const TB* __restrict__ bmat,
              const TB* __restrict__ cmat, const float* __restrict__ states,
              TX* __restrict__ y, int L, int nh, int N, int Q, int HG, int paired) {
  using S = OutSmem<TX, TB, HD>;
  constexpr bool X_EXACT = Bf16<TX>::value, C_EXACT = Bf16<TB>::value;
  constexpr int NTD = HD / 8;  // n-tiles of y
  constexpr int XS = elems<TX>(S::XW);
  const int GS = S::gw(Q), CS = elems<TB>(S::cw(N)), HS = S::hw(N);

  extern __shared__ __align__(16) float smem[];
  float* dts = smem;                      // [HGMAX][QMAX]
  float* loc = dts + HGMAX * QMAX;        // [HGMAX][QMAX]
  float* cdt = loc + HGMAX * QMAX;        // [HGMAX][QMAX]  rem, then exp(rem_j) dt_j
  float* tot = cdt + HGMAX * QMAX;        // [HGMAX][NSMAX]
  float* mexp = tot + HGMAX * NSMAX;      // [HGMAX][4][NSMAX]: exp(mid(s_blk + r, sj))
  float* pre = mexp + HGMAX * 4 * NSMAX;  // [HGMAX][NSMAX]
  float* gs = smem + S::DECAY;            // [TQ][GS]  C.B^T rows
  TB* cs = reinterpret_cast<TB*>(gs + TQ * GS);   // [TQ][CS]
  float* region = gs + TQ * GS + TQ * S::cw(N);
  TB* bs0 = reinterpret_cast<TB*>(region);        // 2 x [TQ][CS] B column tiles
  TX* xs = reinterpret_cast<TX*>(region);         // [Q][XS]  x rows of one head
  float* part = region;                           // [KSPLIT - 1][TQ][RW] partial y
  float* hs = region + S::region(Q, N);           // [HD][HS] a head's state before the chunk

  const int TR = min(TQ, Q);                      // rows of a tile
  const int n_row_tiles = Q / TR;
  const int n_tiles = paired && 2 * (int)blockIdx.x + 1 != n_row_tiles ? 2 : 1;
  const int c = blockIdx.y, NC = gridDim.y;
  const int n_groups = nh / HG;
  const int b = blockIdx.z / n_groups, h0 = (blockIdx.z % n_groups) * HG;
  const long pos0 = (long)b * L + (long)c * Q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int NS = Q / SUB;
  const int CW = TR;                              // columns a B tile
  const int fit = (int)(S::region(Q, N) / ((size_t)TQ * S::cw(N)));  // B tiles the region holds
  auto load_b = [&](int jt, int slot) {
    copy_rows<TB, OUT_THREADS>(bs0 + slot * TQ * CS, CS, bmat + (pos0 + (long)jt * CW) * N, N,
                               CW, N);
  };
  auto load_h = [&](int hh) {
    copy_rows<float, OUT_THREADS>(hs, HS, states + (((long)b * nh + h0 + hh) * NC + c) * HD * N,
                                  N, HD, N);
  };
  // a tile's C rows and its B column tiles (all, or the first of a ring),
  // in one commit group
  auto load_tile = [&](int i0) {
    copy_rows<TB, OUT_THREADS>(cs, CS, cmat + (pos0 + i0) * N, N, TR, N);
    const int n_col = i0 / CW + 1;
    for (int jt = 0; jt < (n_col <= fit ? n_col : 1); ++jt) load_b(jt, jt);
    cp_async_commit();
  };
  load_tile((n_row_tiles - 1 - blockIdx.x) * TR);

  // decays of the group's heads (the same for both tiles)
  for (int i = tid; i < HG * NS; i += OUT_THREADS) {
    const int hh = i / NS, s = i % NS;
    tile_sums(dt, a[h0 + hh], pos0 * nh + h0 + hh, nh, s, dts + hh * QMAX, loc + hh * QMAX,
              cdt + hh * QMAX, tot + hh * NSMAX);
  }
  __syncthreads();
  for (int i = tid; i < HG * NS * SUB; i += OUT_THREADS) {
    const int hh = i / (NS * SUB), j = i % (NS * SUB);
    cdt[hh * QMAX + j] = expf(cdt[hh * QMAX + j]) * dts[hh * QMAX + j];
  }
  if (tid < HG) {
    float run = 0.f;
    for (int s = 0; s < NS; ++s) {
      pre[tid * NSMAX + s] = run;
      run += tot[tid * NSMAX + s];
    }
  }

  const int rt = warp & 3, kq = warp >> 2;
  const bool rows_ok = 16 * rt < TR;
  const int r0 = 16 * rt + g;                     // this lane's rows: r0, r0 + 8 (tile-local)
  for (int tp = 0; tp < n_tiles; ++tp) {
    const int i0 = (tp == 0 ? n_row_tiles - 1 - blockIdx.x : blockIdx.x) * TR, s_blk = i0 / SUB;
    const int n_col_tiles = i0 / CW + 1;
    const bool all_b = n_col_tiles <= fit;
    if (tp > 0) {
      __syncthreads();  // the previous tile's partial sums read: its region is free
      load_tile(i0);
    }
    // off the diagonal tile, exp(cum_i - cum_j) = exp(loc_i) exp(mid) exp(rem_j):
    // a row factor, a table entry and a column factor, each of a sum of one sign
    for (int i = tid; i < HG * 4 * NSMAX; i += OUT_THREADS) {
      const int hh = i / (4 * NSMAX), r = (i / NSMAX) % 4, sj = i % NSMAX;
      float run = 0.f;
      for (int k = s_blk + r - 1; k > sj; --k) run += tot[hh * NSMAX + k];
      mexp[(hh * 4 + r) * NSMAX + sj] = expf(run);
    }
    // G = C.B^T over columns [0, i0 + TR); n-tiles wholly above the warp's
    // last row are skipped.  The first head's state loads during G.
    for (int jt = 0; jt < n_col_tiles; ++jt) {
      if (!all_b || jt == 0) {
        cp_async_wait<0>();
        __syncthreads();  // tile jt (or all) landed for all; everyone done with tile jt - 1
        if (all_b || jt + 1 == n_col_tiles)
          load_h(0);
        else
          load_b(jt + 1, (jt + 1) & 1);
        cp_async_commit();
      }
      const TB* bs = bs0 + (all_b ? jt : jt & 1) * TQ * CS;
      if (!rows_ok) continue;
      // this warp's n-tiles nt = kq + KSPLIT q of the column tile, each while
      // it reaches the warp's last row; one A fragment per k-step serves all
      float gacc[GQ][4] = {};
      bool live[GQ];
      int bro[GQ];  // B tile row of each n-tile's column g (clamped where not live)
#pragma unroll
      for (int q = 0; q < GQ; ++q) {
        const int nt = kq + KSPLIT * q;
        live[q] = nt < CW / 8 && jt * CW + 8 * nt <= i0 + 16 * rt + 15;
        bro[q] = 8 * (live[q] ? nt : 0) + g;
      }
      if constexpr (C_EXACT) {  // bf16 products are exact: no split, no f32 promotion
        const uint32_t* c32 = reinterpret_cast<const uint32_t*>(cs);
        const uint32_t* b32 = reinterpret_cast<const uint32_t*>(bs);
        const int cw32 = CS / 2;
        for (int k0 = 0; k0 < N / 2; k0 += 8) {   // k16 steps, in 32-bit pairs
          const uint32_t af[4] = {c32[r0 * cw32 + k0 + t4], c32[(r0 + 8) * cw32 + k0 + t4],
                                  c32[r0 * cw32 + k0 + t4 + 4],
                                  c32[(r0 + 8) * cw32 + k0 + t4 + 4]};
#pragma unroll
          for (int q = 0; q < GQ; ++q) {
            const uint32_t b0 = b32[bro[q] * cw32 + k0 + t4], b1 = b32[bro[q] * cw32 + k0 + t4 + 4];
            if (live[q]) mma_bf16(gacc[q], af, b0, b1);
          }
        }
      } else {
        for (int k0 = 0; k0 < N; k0 += 8) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split<false>(to_f32(cs[(r0 + 8 * (r & 1)) * CS + k0 + t4 + 4 * (r >> 1)]), ah[r],
                         al[r]);
#pragma unroll
          for (int q = 0; q < GQ; ++q) {
            uint32_t bh0, bh1, bl0, bl1;
            split<false>(to_f32(bs[bro[q] * CS + k0 + t4]), bh0, bl0);
            split<false>(to_f32(bs[bro[q] * CS + k0 + t4 + 4]), bh1, bl1);
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            if (live[q]) mma_split<false, false>(d, ah, al, bh0, bh1, bl0, bl1);
            add4(gacc[q], d);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < GQ; ++q)
        if (live[q]) {
          const int j0 = jt * CW + 8 * (kq + KSPLIT * q);
          store2(gs + r0 * GS + j0 + 2 * t4, gacc[q][0], gacc[q][1]);
          store2(gs + (r0 + 8) * GS + j0 + 2 * t4, gacc[q][2], gacc[q][3]);
        }
    }

    const int si = s_blk + rt;                      // the lane's rows' cumsum tile
    const int ia = i0 + r0, ib = ia + 8;            // chunk-local rows
    const int n_x = i0 + TR;                        // x rows this tile reads
    for (int hh = 0; hh < HG; ++hh) {
      const int h = h0 + hh;
      __syncthreads();  // G written; the previous head's partial sums read
      copy_rows<TX, OUT_THREADS>(xs, XS, x + (pos0 * nh + h) * HD, (long)nh * HD, n_x, HD);
      cp_async_commit();
      cp_async_wait<1>();  // this head's state has landed; its x may still be in flight
      __syncthreads();

      float acc[NTD][4];
#pragma unroll
      for (int e = 0; e < NTD; ++e) acc[e][0] = acc[e][1] = acc[e][2] = acc[e][3] = 0.f;
      const float* hl = loc + hh * QMAX;
      const float* hc = cdt + hh * QMAX;
      const float* hd_t = dts + hh * QMAX;
      if (rows_ok) {
        // inter: C.h_prev^T over this warp's k-steps, then scaled by exp(cum_i)
        for (int k0 = 8 * kq; k0 < N; k0 += 8 * KSPLIT) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split<C_EXACT>(to_f32(cs[(r0 + 8 * (r & 1)) * CS + k0 + t4 + 4 * (r >> 1)]), ah[r],
                           al[r]);
          uint32_t bh[NTD][2], bl[NTD][2];
#pragma unroll
          for (int e = 0; e < NTD; ++e) {
            split<false>(hs[(8 * e + g) * HS + k0 + t4], bh[e][0], bl[e][0]);
            split<false>(hs[(8 * e + g) * HS + k0 + t4 + 4], bh[e][1], bl[e][1]);
          }
          float d[NTD][4] = {};
          mma_passes<C_EXACT, false>(d, ah, al, bh, bl);
#pragma unroll
          for (int e = 0; e < NTD; ++e) add4(acc[e], d[e]);
        }
        const float pa = pre[hh * NSMAX + si];
        const float ea = expf(pa + hl[ia]), eb = expf(pa + hl[ib]);
#pragma unroll
        for (int e = 0; e < NTD; ++e) {
          acc[e][0] *= ea;
          acc[e][1] *= ea;
          acc[e][2] *= eb;
          acc[e][3] *= eb;
        }
      }
      __syncthreads();  // the state read: the next head's loads during this head's att.x
      if (hh + 1 < HG) load_h(hh + 1);
      cp_async_commit();
      cp_async_wait<1>();  // this head's x has landed
      __syncthreads();
      if (rows_ok) {
        // intra: att.x over this warp's 16-column steps sj = kq, kq + KSPLIT, ... <= si;
        // the passes of each step start from zero and are added in f32
        const float la = hl[ia], lb = hl[ib];
        const float ra = expf(la), rb = expf(lb);
        for (int sj = kq; sj <= si; sj += KSPLIT) {
          uint32_t ah[2][4], al[2][4];
          if (sj < si) {
            const float f = mexp[(hh * 4 + rt) * NSMAX + sj];
            const float fa = ra * f, fb = rb * f;
#pragma unroll
            for (int kk = 0; kk < 2; ++kk)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const bool lo_row = r & 1;
                const int j = 16 * sj + 8 * kk + t4 + 4 * (r >> 1);
                const float v = gs[(r0 + 8 * lo_row) * GS + j] * (lo_row ? fb : fa) * hc[j];
                split<false>(v, ah[kk][r], al[kk][r]);
              }
          } else {  // the diagonal tile: exp(loc_i - loc_j), j <= i
#pragma unroll
            for (int kk = 0; kk < 2; ++kk)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const bool lo_row = r & 1;
                const int i = lo_row ? ib : ia, j = 16 * sj + 8 * kk + t4 + 4 * (r >> 1);
                const float e = (lo_row ? lb : la) - hl[j];
                const float v = gs[(r0 + 8 * lo_row) * GS + j] * expf(e) * hd_t[j];
                split<false>(j <= i ? v : 0.f, ah[kk][r], al[kk][r]);
              }
          }
          float d[NTD][4] = {};
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int j0 = 16 * sj + 8 * kk;
            uint32_t bh[NTD][2], bl[NTD][2];
#pragma unroll
            for (int e = 0; e < NTD; ++e) {
              split<X_EXACT>(to_f32(xs[(j0 + t4) * XS + 8 * e + g]), bh[e][0], bl[e][0]);
              split<X_EXACT>(to_f32(xs[(j0 + t4 + 4) * XS + 8 * e + g]), bh[e][1], bl[e][1]);
            }
            mma_passes<false, X_EXACT>(d, ah[kk], al[kk], bh, bl);
          }
#pragma unroll
          for (int e = 0; e < NTD; ++e) add4(acc[e], d[e]);
        }
      }
      __syncthreads();  // x read: the region takes the partial sums
      if (rows_ok && kq > 0) {
#pragma unroll
        for (int e = 0; e < NTD; ++e) {
          float* pr = part + ((kq - 1) * TQ + r0) * S::RW + 8 * e + 2 * t4;
          store2(pr, acc[e][0], acc[e][1]);
          store2(pr + 8 * S::RW, acc[e][2], acc[e][3]);
        }
      }
      __syncthreads();
      if (rows_ok && kq == 0) {
        TX* ya = y + ((pos0 + ia) * nh + h) * HD;
        TX* yb = y + ((pos0 + ib) * nh + h) * HD;
#pragma unroll
        for (int e = 0; e < NTD; ++e) {
          float s0 = acc[e][0], s1 = acc[e][1], s2 = acc[e][2], s3 = acc[e][3];
#pragma unroll
          for (int k = 0; k < KSPLIT - 1; ++k) {
            const float* pr = part + (k * TQ + r0) * S::RW + 8 * e + 2 * t4;
            s0 += pr[0];
            s1 += pr[1];
            s2 += pr[8 * S::RW];
            s3 += pr[8 * S::RW + 1];
          }
          store2(ya + 8 * e + 2 * t4, s0, s1);
          store2(yb + 8 * e + 2 * t4, s2, s3);
        }
      }
    }
  }  // row tiles
}

int sm_count(int device) {
  static int count[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (count[device] == 0 &&
      cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    count[device] = 132;
  return count[device];
}

template <typename TX, typename TB, int HD, int N>
cudaError_t launch_state(const TX* x, const float* dt, const float* a, const TB* bmat,
                         float* states, float* decay, int B, int L, int nh, int Q,
                         cudaStream_t stream) {
  constexpr size_t smem = StateSmem<TX, TB, HD, N>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state<TX, TB, HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_state<TX, TB, HD, N><<<dim3(L / Q, B * nh), THREADS, smem, stream>>>(
      x, dt, a, bmat, states, decay, L, nh, Q);
  return cudaGetLastError();
}

// ssd_chunk_out's blocks: a pair of row tiles with HG heads (4, 2 or 1), the
// largest HG whose grid fills 3/4 of the SMs in one wave; else, where even
// HG = 1 does not, single tiles of one head, which make twice the blocks.
void out_layout(int B, int L, int nh, int Q, int device, int& HG, int& paired) {
  const int n_row_tiles = Q / (Q < TQ ? Q : TQ);
  for (int hg = HGMAX; hg >= 1; hg /= 2)
    if (nh % hg == 0 && 4 * ((n_row_tiles + 1) / 2) * (L / Q) * B * (nh / hg) >=
                            3 * sm_count(device)) {
      HG = hg;
      paired = 1;
      return;
    }
  HG = 1;
  paired = 0;
}

template <typename TX, typename TB, int HD>
cudaError_t launch(const void* x, const float* dt, const float* a, const void* bmat,
                   const void* cmat, void* y, float* h_final, float* states, float* decay,
                   int B, int L, int nh, int N, int Q, int device, int* layout,
                   cudaStream_t stream) {
  const int NC = L / Q, BH = B * nh;
  const int n_row_tiles = Q / (Q < TQ ? Q : TQ);
  int HG, paired;
  out_layout(B, L, nh, Q, device, HG, paired);
  layout[0] = HG;
  layout[1] = paired;
  const TX* xt = static_cast<const TX*>(x);
  const TB* bt = static_cast<const TB*>(bmat);
  // N is a template parameter of ssd_chunk_state: sized for the largest N
  // and cut short at run time, its accumulators and n-tile loops took 128
  // registers at hd=64, N=128 (96 here) and the launch 1.3x the time at
  // mamba2-370m's widths
  cudaError_t err;
  switch (N) {
    case 16:
      err = launch_state<TX, TB, HD, 16>(xt, dt, a, bt, states, decay, B, L, nh, Q, stream);
      break;
    case 32:
      err = launch_state<TX, TB, HD, 32>(xt, dt, a, bt, states, decay, B, L, nh, Q, stream);
      break;
    case 64:
      err = launch_state<TX, TB, HD, 64>(xt, dt, a, bt, states, decay, B, L, nh, Q, stream);
      break;
    case 128:
      err = launch_state<TX, TB, HD, 128>(xt, dt, a, bt, states, decay, B, L, nh, Q, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int size = HD * N;  // a multiple of 4: hd and N are
  ssd_state_pass<<<dim3((size / 4 + THREADS - 1) / THREADS, BH), THREADS, 0, stream>>>(
      states, decay, h_final, NC, size);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = OutSmem<TX, TB, HD>::bytes(Q, N);
  err = cudaFuncSetAttribute(ssd_chunk_out<TX, TB, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(paired ? (n_row_tiles + 1) / 2 : n_row_tiles, NC, B * (nh / HG));
  ssd_chunk_out<TX, TB, HD><<<grid, OUT_THREADS, smem, stream>>>(
      xt, dt, a, bt, static_cast<const TB*>(cmat), states, static_cast<TX*>(y), L, nh, N, Q, HG,
      paired);
  return cudaGetLastError();
}

template <typename TX, typename TB>
cudaError_t launch_hd(int hd, const void* x, const float* dt, const float* a, const void* bmat,
                      const void* cmat, void* y, float* h_final, float* states, float* decay,
                      int B, int L, int nh, int N, int Q, int device, int* layout,
                      cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<TX, TB, 16>(x, dt, a, bmat, cmat, y, h_final, states, decay, B, L, nh, N, Q,
                                device, layout, stream);
    case 32:
      return launch<TX, TB, 32>(x, dt, a, bmat, cmat, y, h_final, states, decay, B, L, nh, N, Q,
                                device, layout, stream);
    case 64:
      return launch<TX, TB, 64>(x, dt, a, bmat, cmat, y, h_final, states, decay, B, L, nh, N, Q,
                                device, layout, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TX>
cudaError_t launch_bc(int bc_dtype, int hd, const void* x, const float* dt, const float* a,
                      const void* bmat, const void* cmat, void* y, float* h_final,
                      float* states, float* decay, int B, int L, int nh, int N, int Q,
                      int device, int* layout, cudaStream_t stream) {
  if (bc_dtype == 0)
    return launch_hd<TX, float>(hd, x, dt, a, bmat, cmat, y, h_final, states, decay, B, L, nh,
                                N, Q, device, layout, stream);
  if (bc_dtype == 1)
    return launch_hd<TX, __nv_bfloat16>(hd, x, dt, a, bmat, cmat, y, h_final, states, decay, B,
                                        L, nh, N, Q, device, layout, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x_dtype, bc_dtype: 0 = float32, 1 = bfloat16.  states: f32 scratch of
// B*nh*(L/Q)*hd*N values; decay: f32 scratch of B*nh*(L/Q).  All device
// pointers 16-byte aligned.  layout (host, 2 ints) receives ssd_chunk_out's
// heads a block and whether its blocks take a pair of row tiles.  Returns a
// cudaError_t (0 on success); the three launches are asynchronous on `stream`.
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* bmat,
                 const void* cmat, void* y, void* h_final, void* states, void* decay, int B,
                 int L, int nh, int hd, int N, int Q, int x_dtype, int bc_dtype, int device,
                 int* layout, void* stream) {
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
    return (int)launch_bc<float>(bc_dtype, hd, x, dtp, ap, bmat, cmat, y, hf, sp, dp, B, L, nh,
                                 N, Q, device, layout, st);
  if (x_dtype == 1)
    return (int)launch_bc<__nv_bfloat16>(bc_dtype, hd, x, dtp, ap, bmat, cmat, y, hf, sp, dp, B,
                                         L, nh, N, Q, device, layout, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
