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
// contract in f32.  Here the per-group integer sum comes first (an s8
// tensor-core step per group, or two groups kept apart in one step by the
// GEMV), and the group's sum (|sum| <= 2^15) times its bf16 scale (8
// significant bits) is exact.  Those terms are summed in
// float64, where the sum is exact as long as a row's group scales span less
// than a factor 2^21 (far wider than any weight row's), and rounded to f32
// once before the s_a epilogue.  So the result does not depend on the order
// of summation: it equals the plain version (ref.mmt4d_q4, a float64
// contraction) bit for bit, and differs from the TPU's f32 sum only by that
// sum's rounding.  The float64 adds are one per group and row-column pair,
// off the byte-bound path of the decode GEMV.
//
// fused_gemv_q4 (decode, M <= 8 plain rows): the decode-GEMV body of
// gemv_warps.cuh (16-column blocks over the whole of K, the warps splitting
// the K tiles, one launch, no merge through memory) on nibbles; its
// section below says how a step's slots keep the groups apart.
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
#include "gemv_warps.cuh"

namespace {

constexpr int T0 = 128;   // N0 = K0
constexpr int T0P = 64;   // packed bytes of a K0 tile row

// ---- decode GEMV: the body of gemv_warps.cuh on nibbles ------------------------------
//
// Lane (g, t) loads bytes 16t..16t+15 of weight rows g and g+8 of its
// block's slice in each K tile: K 32t..32t+31, one g32 group or two g16
// groups.  A k32 step sums its 32 slots over the quad's four lanes, so one
// step must see one group (g32) or keep two apart: the quad exchanges its
// words (quad_transpose) so that lane t holds word t (K 8t..8t+7) of each
// of the tile's four 32-element chunks; a step then takes chunk c, its low
// nibbles (K 8t + 0, 2, 4, 6) in slots 4t.. and its high ones in 16+4t..,
// each nibble in the high half of its byte (16 w, as the skinny body
// does), and the rows' matching bytes (lhs at K 32c + 8t, split into even
// and odd elements by a byte permute) on the B side.
//   g32: chunk c is group c; B column j is row j.
//   g16: lane t's slots hold group 2c + t/2, so B column j takes row
//        4 rb + j%4 only on the lanes of group half j/4 (zeros elsewhere):
//        column j sums one group, and rows 0-3 (rb = 0) and 4-7 (rb = 1,
//        a second step, when M > 4) share the weight registers.
// Each group's int32 fragment starts at Q4_C and is rescaled into f64 by
// q4_rescale; the scales' sum removes the offset at the end (exact, as in
// the skinny body).  At g16 lanes t and t^2 hold the two group halves of
// the same outputs and are added before the warps' sums meet.

// Lane t of each quad ends with word t of the quad's four 16-byte loads,
// in lane order: a 4 x 4 transpose in two exchanges.
__device__ __forceinline__ uint4 quad_transpose(uint4 v, int t) {
  const bool odd = t & 1;
  unsigned r0 = __shfl_xor_sync(0xffffffffu, odd ? v.x : v.y, 1);
  unsigned r1 = __shfl_xor_sync(0xffffffffu, odd ? v.z : v.w, 1);
  if (odd) {
    v.x = r0;
    v.z = r1;
  } else {
    v.y = r0;
    v.w = r1;
  }
  const bool high = t & 2;
  r0 = __shfl_xor_sync(0xffffffffu, high ? v.x : v.z, 2);
  r1 = __shfl_xor_sync(0xffffffffu, high ? v.y : v.w, 2);
  if (high) {
    v.x = r0;
    v.y = r1;
  } else {
    v.z = r0;
    v.w = r1;
  }
  return v;
}

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ unsigned word(const uint2& v, int i) { return i == 0 ? v.x : v.y; }

// The bf16 in half `h` (0 low, 1 high) of a 32-bit word, as a double.
__device__ __forceinline__ double bf16_half(unsigned w, int h) {
  return static_cast<double>(__uint_as_float(h ? (w & 0xFFFF0000u) : (w << 16)));
}

template <int G>
struct GvScales;  // a weight row's scales of one K tile
template <>
struct GvScales<16> {
  using V = uint4;  // 8 bf16
  static __device__ __forceinline__ V load(const bf16* p) { return ld_once16(p); }
  // the scale of lane t's group in chunk c: group 2c + t/2
  static __device__ __forceinline__ double at(const V& v, int c, int t) {
    return bf16_half(word(v, c), t >> 1);
  }
};
template <>
struct GvScales<32> {
  using V = uint2;  // 4 bf16
  static __device__ __forceinline__ V load(const bf16* p) { return ld_once8(p); }
  static __device__ __forceinline__ double at(const V& v, int c, int) {
    return bf16_half(word(v, c >> 1), c & 1);
  }
};

// W warps; NB: 8-row blocks of B (1, or 2 at g16 when M > 4).
template <int W, int G, int NB>
__global__ void __launch_bounds__(W * 32)
gemv_q4_warps(const int8_t* __restrict__ lhs, const uint8_t* __restrict__ rhs4,
              const float* __restrict__ s_a, const bf16* __restrict__ s_w4,
              float* __restrict__ out, int m, int n1, int k1) {
  constexpr int GPT = T0 / G;  // scales a tile row
  using S = GvScales<G>;
  using SV = typename S::V;
  __shared__ double red[W][GV_ROWS * GV_LDR];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_base = blockIdx.x * GV_BN;
  const int K = k1 * T0;
  const int e = threadIdx.x;
  const float sa = e < m * GV_BN ? s_a[e / GV_BN] : 0.f;
  // Tile row of weight row g of the slice in K tile 0; K tile kt is kt * T0
  // rows on, row g + 8 is 8 rows on.
  const size_t row0 = (size_t)(n_base / T0) * k1 * T0 + n_base % T0 + g;
  const uint8_t* wp = rhs4 + row0 * T0P + 16 * t;
  const bf16* sp = s_w4 + row0 * GPT;
  const int8_t* xp[NB];
  bool xr[NB];
#pragma unroll
  for (int rb = 0; rb < NB; ++rb) {
    const int r = G == 32 ? g : 4 * rb + (g & 3);
    xr[rb] = r < m && (G == 32 || (t >> 1) == (g >> 2));
    xp[rb] = lhs + (size_t)(xr[rb] ? r : 0) * K + 8 * t;
  }
  int lo, hi;
  gv_warp_tiles(warp, W, k1, lo, hi);
  double acc[NB][4] = {};
  double ssum[2] = {0.0, 0.0};  // the scales of rows g and g + 8 this lane used
  for (int kt = lo; kt < hi; ++kt) {
    const size_t row = (size_t)kt * T0;  // this K tile's rows past row0
    const uint4 w0 = ld_once16(wp + row * T0P), w1 = ld_once16(wp + (row + 8) * T0P);
    const SV s0 = S::load(sp + row * GPT), s1 = S::load(sp + (row + 8) * GPT);
    uint2 xv[NB][4];
#pragma unroll
    for (int rb = 0; rb < NB; ++rb)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        xv[rb][c] = xr[rb] ? __ldg(reinterpret_cast<const uint2*>(xp[rb] + kt * T0 + 32 * c))
                           : make_uint2(0, 0);
    const uint4 v0 = quad_transpose(w0, t), v1 = quad_transpose(w1, t);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned p0 = word(v0, c), p1 = word(v1, c);
      const unsigned fa[4] = {(p0 << 4) & 0xF0F0F0F0u, (p1 << 4) & 0xF0F0F0F0u, p0 & 0xF0F0F0F0u,
                              p1 & 0xF0F0F0F0u};
      const double d0 = S::at(s0, c, t), d1 = S::at(s1, c, t);
      ssum[0] += d0;
      ssum[1] += d1;
#pragma unroll
      for (int rb = 0; rb < NB; ++rb) {
        const uint2 x = xv[rb][c];
        const unsigned fb[2] = {__byte_perm(x.x, x.y, 0x6420), __byte_perm(x.x, x.y, 0x7531)};
        int cc[4] = {Q4_C, Q4_C, Q4_C, Q4_C};
        mma_16x8(cc, fa, fb);
        q4_rescale(acc[rb], cc, d0, d1);
      }
    }
  }
  double* rw = red[warp];
#pragma unroll
  for (int rb = 0; rb < NB; ++rb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[rb][i] = fma(-Q4_OFFSET, ssum[i >> 1], acc[rb][i]);
      if (G == 16) acc[rb][i] += __shfl_xor_sync(0xffffffffu, acc[rb][i], 2);
    }
    // acc[rb]: (column g, row r0), (g, r0 + 1), (g + 8, r0), (g + 8, r0 + 1)
    const int r0 = G == 32 ? 2 * t : 4 * rb + 2 * (t & 1);
    if (G == 32 || t < 2) {
      rw[r0 * GV_LDR + g] = acc[rb][0];
      rw[(r0 + 1) * GV_LDR + g] = acc[rb][1];
      rw[r0 * GV_LDR + g + 8] = acc[rb][2];
      rw[(r0 + 1) * GV_LDR + g + 8] = acc[rb][3];
    }
  }
  const int n = n1 * T0;
  gv_store<W>(red, m, [&](double s, int r, int c) {
    out[(size_t)r * n + n_base + c] = static_cast<float>(s) * sa;
  });
}

template <int G, int NB>
int launch_gemv(const void* lhs, const void* rhs4, const void* s_a, const void* s_w4, void* out,
                int m, int n1, int k1, int warps, cudaStream_t s) {
  const int8_t* a = static_cast<const int8_t*>(lhs);
  const uint8_t* w = static_cast<const uint8_t*>(rhs4);
  const float* sa = static_cast<const float*>(s_a);
  const bf16* sw = static_cast<const bf16*>(s_w4);
  float* o = static_cast<float*>(out);
  const dim3 grid(n1 * T0 / GV_BN);
  switch (warps) {
    case 8: gemv_q4_warps<8, G, NB><<<grid, 8 * 32, 0, s>>>(a, w, sa, sw, o, m, n1, k1); break;
    case 16: gemv_q4_warps<16, G, NB><<<grid, 16 * 32, 0, s>>>(a, w, sa, sw, o, m, n1, k1); break;
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

// warps: the plan's warps a block (kernels/mmt4d_q4.py: gemv_q4_plan).
extern "C" int fused_gemv_q4(const void* lhs, const void* rhs4, const void* s_a,
                             const void* s_w4, void* out, int m, int n1, int k1, int group,
                             int warps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || m > GV_ROWS || n1 < 1 || k1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (group == 32) return launch_gemv<32, 1>(lhs, rhs4, s_a, s_w4, out, m, n1, k1, warps, s);
  if (group != 16) return static_cast<int>(cudaErrorInvalidValue);
  return m > 4 ? launch_gemv<16, 2>(lhs, rhs4, s_a, s_w4, out, m, n1, k1, warps, s)
               : launch_gemv<16, 1>(lhs, rhs4, s_a, s_w4, out, m, n1, k1, warps, s);
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
