// w4a8 group-quantized projections: int8 activations times nibble-packed int4
// weights with one bf16 scale per `group` K elements (16 or 32).
//
// Replaces src/repro/kernels/mmt4d_q4.py: fused_gemv_q4_pallas (decode, plain
// rows) and mmt4d_q4_pallas (packed rows) (TPU).
//   rhs4_p (N1, K1, 128, 64) uint8: byte j of a tile row holds K elements 2j
//          (low nibble) and 2j+1 (high nibble), two's complement in [-8, 7];
//   s_w4   (N1, K1, 128, 128/group) bf16: the scale of each K group of a row;
//   W[n, k] = nibble(n, k) * s_w4[n/128][k/128][n%128][(k%128)/group].
//   fused_gemv_q4: lhs_q (M, K) int8, s_a (M, 1) f32 -> out (M, N) f32;
//   mmt4d_q4:      lhs4_q (M1, K1, M0, 128) int8, s_a (M1, M0) f32
//                  -> out4 (M1, N1, M0, 128) f32;
//   out = (sum_k a_q[m, k] * W[n, k]) * s_a[m].
//
// What bounds it on the H100: bytes at decode (0.625 weight bytes per
// element at group 16: the nibbles and the bf16 scales, streamed once),
// operations at prefill.  The TPU kernels dequantize each tile to f32 and
// contract in f32.  Here the per-group integer sum comes first (the GEMV:
// __dp4a takes four int8 products into an int32; the GEMM: an s8 tensor-core
// step per group), and the group's sum (|sum| <= 2^15) times
// its bf16 scale (8 significant bits) is exact.  Those terms are summed in
// float64, where the sum is exact as long as a row's group scales span less
// than a factor 2^21 (far wider than any weight row's), and rounded to f32
// once before the s_a epilogue.  So the result does not depend on the order
// of summation: it equals the plain version (ref.mmt4d_q4, a float64
// contraction) bit for bit, and differs from the TPU's f32 sum only by that
// sum's rounding.  The float64 adds are one per group and row-column pair,
// off the byte-bound path of the decode GEMV.
//
// The GEMV's nibbles to int8: a 32-bit word of packed bytes holds 8 K elements; its low
// nibbles (elements 0, 2, 4, 6) and high nibbles (1, 3, 5, 7) each become 4
// sign-extended bytes with one mask, one xor and one per-byte subtract
// (__vsub4).  The activations are staged in shared memory in the matching
// order: every 8 K elements a0..a7 are stored as a0 a2 a4 a6 a1 a3 a5 a7
// (__byte_perm), so each nibble word meets its 4 activations in one int.
//
// fused_gemv_q4 (decode, M <= 8 rows): one warp per output column n walks
// that column's K1 packed rows; a tile row is 64 bytes, so 4 lanes read it
// with 16-byte loads (32 K elements each) and a warp covers 8 K tiles per
// load.  The int8 rows are staged in shared memory one K chunk at a time.
// M is a template parameter; rows are never padded.
//
// mmt4d_q4 (packed rows, any M0 in 1..8 or 128): the skinny split-K body
// of the bf16 and int8 packed GEMMs (packed_skinny.cuh), instantiated for
// the nibble weight (Nib4<G>), for every row count; the host's plan
// (kernels/mmt4d_q4.py: q4_plan) picks the block width and the K split.
//   - Loads.  The weight through a 2-D TMA map over rhs4_p viewed as
//     (N1*K1*128, 64) u8: a K tile row is 64 bytes, one 64B-swizzled box
//     row, so a stage's weight is half the int8 body's.  The block's 16 or
//     64 weight rows' scales of one K tile are one contiguous run of
//     rows * 128/G bf16 (256 B for 16 rows at g16; a g32 row has only 8 B,
//     below a TMA box row's 16), landed whole by a bulk copy in the same
//     stage.  The int8 rows through the int8 body's rank-4 map, one box a K
//     tile: row groups of whole row blocks up to 64 rows (M0 <= 8), or, at
//     the prefill's M0 = 128, 64-row slabs of one row block (SkSlabRows).
//   - Products.  mma.sync s8 with the weight as the A side (16 w: the
//     nibble in the high half of its byte) and the rows' int8 fragments
//     unchanged: one m16n8k32 per group at g32, one m16n8k16 per group at
//     g16, each starting a fresh int32 fragment, rescaled into float64
//     accumulators with one DFMA a term (packed_skinny.cuh, "the int4
//     products").  Not wgmma: its k32 s8 step straddles two groups at g16,
//     and its asynchronous accumulation leaves no per-group int32 sum to
//     rescale.
//   - Blocks.  A warp owns 16 output columns (one m16 fragment: half the
//     bf16 / int8 body's 32, so its 4 * NT f64 accumulators, 8 * NT
//     registers, leave room for two blocks an SM at 64 rows).  16-column
//     blocks whose four warps split the K tiles (decode windows, and wide
//     windows whose 64-column grid would not fill a wave), or 64-column
//     blocks of four warps on every K tile (wide windows: the rows are
//     re-read from L2 a quarter as often); the plan's sweep is in PERF.md.  Split partials are f64 in
//     the wrapper's scratch, merged in split order by the last block, the
//     epilogue float(sum) * s_a once.
//   - Plain rows (`mmt4d_q4_rows`, the ops path's entry): the same plan
//     and blocks with the rows read through a 2-D map over lhs (M, K) (a
//     block's G * M0 rows, or its 64-row slab) and each row stored at out
//     + r*N: the packed result unpacked, bit for bit, in one launch.
// What bounds it: bytes at decode (0.625 weight bytes an element at g16),
// the f64 rescale at prefill: one DFMA per (row, column, group), 2048 x
// 2048 x 512 ~ 2.1e9 at K = 8192 g16, ~0.13 ms at the H100's ~17e12 DFMA/s
// (about 4x the int8 tensor-core bound), half that at g32; measured 4-5x
// that floor (PERF.md, section 7: why is open).
#include "packed_skinny.cuh"

namespace {

constexpr int T0 = 128;   // N0 = K0
constexpr int T0P = 64;   // packed bytes of a K0 tile row

__device__ __forceinline__ void expand_nibbles(unsigned w, int& lo, int& hi) {
  const unsigned l = w & 0x0F0F0F0Fu;
  const unsigned h = (w >> 4) & 0x0F0F0F0Fu;
  lo = static_cast<int>(__vsub4(l ^ 0x08080808u, 0x08080808u));
  hi = static_cast<int>(__vsub4(h ^ 0x08080808u, 0x08080808u));
}

__device__ __forceinline__ double warp_sum_f64(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 8 int8 activations a0..a7 -> {a0 a2 a4 a6, a1 a3 a5 a7}.
__device__ __forceinline__ uint2 deinterleave8(uint2 v) {
  return make_uint2(__byte_perm(v.x, v.y, 0x6420), __byte_perm(v.x, v.y, 0x7531));
}

// ---- decode GEMV --------------------------------------------------------------------
constexpr int WARPS = 8;    // output columns per block
constexpr int KC = 4096;    // K elements of the rows staged per pass
constexpr int TPW = 8;      // K tiles a warp covers per load (4 lanes each)

template <int M, int G>
__global__ void __launch_bounds__(WARPS * 32)
fused_gemv_q4_kernel(const int8_t* __restrict__ lhs, const uint8_t* __restrict__ rhs4,
                     const float* __restrict__ s_a, const bf16* __restrict__ s_w4,
                     float* __restrict__ out, int n1, int k1) {
  constexpr int GPT = T0 / G;    // groups per tile row
  constexpr int GPL = 32 / G;    // groups per lane (32 K elements)
  constexpr int CPG = G / 8;     // 8-element chunks per group
  __shared__ __align__(16) int8_t xs[M][KC];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int N = n1 * T0;
  const int K = k1 * T0;
  const int n = blockIdx.x * WARPS + warp;  // grid covers N exactly
  const int nt = n / T0;
  const int n0 = n % T0;
  const int sub = lane >> 2;   // which of the TPW tiles this lane reads
  const int q = lane & 3;      // its 32 K elements: q*32 .. q*32+31 of the tile

  double acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.0;

  for (int kc = 0; kc < K; kc += KC) {
    const int kn = min(KC, K - kc);  // a multiple of T0
    __syncthreads();
    for (int i = threadIdx.x; i < M * kn / 8; i += blockDim.x) {
      const int m = i / (kn / 8);
      const int kk = (i - m * (kn / 8)) * 8;
      *reinterpret_cast<uint2*>(&xs[m][kk]) =
          deinterleave8(*reinterpret_cast<const uint2*>(lhs + (size_t)m * K + kc + kk));
    }
    __syncthreads();
    const int tiles = kn / T0;
    const size_t row0 = ((size_t)nt * k1 + kc / T0) * T0 + n0;  // tile row of the chunk's first tile
#pragma unroll 2
    for (int t0 = 0; t0 < tiles; t0 += TPW) {
      const int t = t0 + sub;
      if (t < tiles) {
        const size_t row = row0 + (size_t)t * T0;
        const uint4 w = *reinterpret_cast<const uint4*>(rhs4 + row * T0P + q * 16);
        double sc[GPL];
#pragma unroll
        for (int g = 0; g < GPL; ++g) sc[g] = __bfloat162float(s_w4[row * GPT + q * GPL + g]);
        int lo[4], hi[4];
        expand_nibbles(w.x, lo[0], hi[0]);
        expand_nibbles(w.y, lo[1], hi[1]);
        expand_nibbles(w.z, lo[2], hi[2]);
        expand_nibbles(w.w, lo[3], hi[3]);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int* x = reinterpret_cast<const int*>(&xs[m][t * T0 + q * 32]);
          const int4 xa = *reinterpret_cast<const int4*>(x);
          const int4 xb = *reinterpret_cast<const int4*>(x + 4);
          const int xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
          for (int g = 0; g < GPL; ++g) {
            int s = 0;
#pragma unroll
            for (int c = g * CPG; c < (g + 1) * CPG; ++c) {
              s = __dp4a(lo[c], xv[2 * c], s);
              s = __dp4a(hi[c], xv[2 * c + 1], s);
            }
            acc[m] += static_cast<double>(s) * sc[g];
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const double s = warp_sum_f64(acc[m]);
    if (lane == 0) out[(size_t)m * N + n] = static_cast<float>(s) * s_a[m];
  }
}

template <int G>
int launch_gemv(const void* lhs, const void* rhs4, const void* s_a, const void* s_w4, void* out,
                int m, int n1, int k1, cudaStream_t stream) {
  const dim3 grid(n1 * T0 / WARPS);
  const dim3 block(WARPS * 32);
  const int8_t* a = static_cast<const int8_t*>(lhs);
  const uint8_t* w = static_cast<const uint8_t*>(rhs4);
  const float* sa = static_cast<const float*>(s_a);
  const bf16* sw = static_cast<const bf16*>(s_w4);
  float* o = static_cast<float*>(out);
  switch (m) {
#define CASE(MM) \
  case MM: fused_gemv_q4_kernel<MM, G><<<grid, block, 0, stream>>>(a, w, sa, sw, o, n1, k1); break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The packed GEMM on the skinny body, a block `bn` output columns wide: 16
// (the four consumer warps split the K tiles of one 16-column slice) or 64
// (every warp walks every K tile for its own 16 columns; a block of 57-64
// rows).  K in `splits` ranges; with splits > 1, `part` holds tiles *
// splits * SK_ROWS * bn doubles and `cnt` tiles zeroed ints, tiles = (N1*128
// / bn) * row groups (kernels/mmt4d_q4.py mirrors this).  Row groups:
// ceil(M1 / G) of G = min(M1, 64 / M0) row blocks, or M1 * M0 / 64 slabs of
// one row block when M0 > 64.
template <int G>
int launch_gemm(const void* lhs4, const void* rhs4, const void* s_a, const void* s_w4,
                void* out4, int m1, int m0, int n1, int k1, int bn, int splits, void* part,
                int* cnt, cudaStream_t stream) {
  constexpr int NARROW = 16, WIDE = 64, NT8 = SK_ROWS / 8;
  if (m1 < 1 || m0 < 1 || (m0 > SK_ROWS && m0 % SK_ROWS != 0) || (bn != NARROW && bn != WIDE) ||
      !skinny_plan_ok(n1, k1, splits, part, cnt))
    return static_cast<int>(cudaErrorInvalidValue);
  using W = Nib4<G>;
  const bool slabs = m0 > SK_ROWS;
  const int g = slabs ? 1 : std::min(m1, SK_ROWS / m0);
  const int nt = slabs ? NT8 : (g * m0 + 7) / 8;  // 8-row groups a block holds
  if (bn == WIDE && nt != NT8) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_lhs, tm_rhs;
  cudaError_t e = weight_map<int8_t>(&tm_rhs, rhs4, n1, k1, bn, T0P);
  if (e == cudaSuccess)
    e = encode_packed_rows<int8_t>(&tm_lhs, lhs4, m1, m0, k1, slabs ? SK_ROWS : m0, g);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* o = static_cast<float*>(out4);
  const SkinnyArgs a{part, cnt, k1, splits, Scales{static_cast<const float*>(s_a), nullptr},
                     static_cast<const bf16*>(s_w4)};
  const int gx = n1 * T0 / bn;
  if (slabs) {
    const SkSlabRows p{o, m1 * m0, m0, n1, SK_ROWS};
    const dim3 grid(gx, splits, m1 * (m0 / SK_ROWS));
    return static_cast<int>(
        bn == WIDE ? launch_skinny_nt<W, NT8, SkSlabRows, SK_CW, 1>(tm_lhs, tm_rhs, p, a, grid, stream)
                   : launch_skinny_nt<W, NT8, SkSlabRows, 1, 1>(tm_lhs, tm_rhs, p, a, grid, stream));
  }
  const SkPackedRows p{o, m1 * m0, m0, n1, g};
  const dim3 grid(gx, splits, (m1 + g - 1) / g);
  if (bn == WIDE)
    return static_cast<int>(
        launch_skinny_nt<W, NT8, SkPackedRows, SK_CW, 1>(tm_lhs, tm_rhs, p, a, grid, stream));
  switch (nt) {
#define CASE(NT) \
  case NT:       \
    return static_cast<int>(launch_skinny_nt<W, NT, SkPackedRows, 1, 1>(tm_lhs, tm_rhs, p, a, grid, stream));
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plain-row entry of launch_gemm: int8 lhs (m, K1*128), s_a (m,) ->
// out (m, N1*128) under the packed twin's plan at M1 = ceil(m / m0).  Block
// row group z holds plain rows [z * rows, (z + 1) * rows), the rows its
// packed twin's block holds: G * m0 (G = min(M1, 64 / m0)), or a 64-row
// slab at m0 = 128 (slab z of row block z / 2 is rows 64 z ..).  Rows past
// m are read as zeros (TMA) and never stored.  The same blocks, K splits
// and order of sums: equal to the packed result, unpacked, bit for bit.
template <int G>
int launch_gemm_rows(const void* lhs, const void* rhs4, const void* s_a, const void* s_w4,
                     void* out, int m, int m0, int n1, int k1, int bn, int splits, void* part,
                     int* cnt, cudaStream_t stream) {
  constexpr int NARROW = 16, WIDE = 64, NT8 = SK_ROWS / 8;
  if (m < 1 || m0 < 1 || (m0 > SK_ROWS && m0 % SK_ROWS != 0) || (bn != NARROW && bn != WIDE) ||
      !skinny_plan_ok(n1, k1, splits, part, cnt))
    return static_cast<int>(cudaErrorInvalidValue);
  using W = Nib4<G>;
  const int m1 = (m + m0 - 1) / m0;
  const int rows = m0 > SK_ROWS ? SK_ROWS : std::min(m1, SK_ROWS / m0) * m0;
  const int nt = (rows + 7) / 8;  // 8-row groups a block holds
  if (bn == WIDE && nt != NT8) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_lhs, tm_rhs;
  cudaError_t e = weight_map<int8_t>(&tm_rhs, rhs4, n1, k1, bn, T0P);
  if (e == cudaSuccess) e = plain_rows_map<int8_t>(&tm_lhs, lhs, m, k1, rows);
  if (e != cudaSuccess) return static_cast<int>(e);
  const SkPlainRows p{static_cast<float*>(out), m, n1 * T0, rows};
  const SkinnyArgs a{part, cnt, k1, splits, Scales{static_cast<const float*>(s_a), nullptr},
                     static_cast<const bf16*>(s_w4)};
  const dim3 grid(n1 * T0 / bn, splits, (m + rows - 1) / rows);
  if (bn == WIDE)
    return static_cast<int>(
        launch_skinny_nt<W, NT8, SkPlainRows, SK_CW, 1>(tm_lhs, tm_rhs, p, a, grid, stream));
  switch (nt) {
#define CASE(NT) \
  case NT:       \
    return static_cast<int>(launch_skinny_nt<W, NT, SkPlainRows, 1, 1>(tm_lhs, tm_rhs, p, a, grid, stream));
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int fused_gemv_q4(const void* lhs, const void* rhs4, const void* s_a,
                             const void* s_w4, void* out, int m, int n1, int k1, int group,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group == 16) return launch_gemv<16>(lhs, rhs4, s_a, s_w4, out, m, n1, k1, s);
  if (group == 32) return launch_gemv<32>(lhs, rhs4, s_a, s_w4, out, m, n1, k1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bn, splits, part, cnt: the plan's block width (16 or 64 columns) and K
// split, and the wrapper's scratch when splits > 1.
extern "C" int mmt4d_q4(const void* lhs4, const void* rhs4, const void* s_a, const void* s_w4,
                        void* out4, int m1, int m0, int n1, int k1, int group, int bn, int splits,
                        void* part, void* cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* c = static_cast<int*>(cnt);
  if (group == 16)
    return launch_gemm<16>(lhs4, rhs4, s_a, s_w4, out4, m1, m0, n1, k1, bn, splits, part, c, s);
  if (group == 32)
    return launch_gemm<32>(lhs4, rhs4, s_a, s_w4, out4, m1, m0, n1, k1, bn, splits, part, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plain-row entry of mmt4d_q4 (launch_gemm_rows): lhs (m, K1*128) int8,
// s_a (m,) f32 -> out (m, N1*128) f32, under the plan (bn, splits) of the
// packed entry at lhs4 (ceil(m / m0), K1, m0, 128).
extern "C" int mmt4d_q4_rows(const void* lhs, const void* rhs4, const void* s_a,
                             const void* s_w4, void* out, int m, int m0, int n1, int k1,
                             int group, int bn, int splits, void* part, void* cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* c = static_cast<int*>(cnt);
  if (group == 16)
    return launch_gemm_rows<16>(lhs, rhs4, s_a, s_w4, out, m, m0, n1, k1, bn, splits, part, c, s);
  if (group == 32)
    return launch_gemm_rows<32>(lhs, rhs4, s_a, s_w4, out, m, m0, n1, k1, bn, splits, part, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
