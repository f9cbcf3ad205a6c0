// The "skinny" GEMM body: few rows times the packed weight, K split across
// blocks and merged in the same launch.  Shared by the packed GEMM at up to
// 64 rows (mmt4d.cu, kernel 4), the packed decode GEMV (mmt4d_gemv.cu,
// kernel 5, the case M1 = 1), the decode GEMV on plain rows (fused_gemv.cu,
// kernel 1) in bf16, the int8 packed GEMM at up to 64 rows (mmt4d_q8.cu,
// kernel 6), and the w4a8 packed GEMM at every row count (mmt4d_q4.cu,
// kernel 8: int4 nibble weights, the section "the int4 products" below).
//
//   packed rows: lhs4 (M1, K1, M0, 128) x rhs4 (N1, K1, 128, 128) -> out4 (M1, N1, M0, 128) f32,
//     out4[m1, n1, m0, n0] = sum_{k1, k0} lhs4[m1, k1, m0, k0] * rhs4[n1, k1, n0, k0]
//   plain rows:  lhs (M, K1*128) x rhs4 -> out (M, N1*128) f32: the decode
//     GEMV (M <= 8), and the packed GEMMs' plain-row entries (any M, the
//     packed twin's plan; the activation pack and output unpack are the
//     TMA loads' and the epilogue's addressing)
//   int8: the sum in int32, then (float(sum) * s_a[row]) * s_w[col].
//   int4: per K group an int32 sum times the group's scale, summed in f64,
//     then float(sum) * s_a[row].
//
// What bounds it on the H100: bytes.  Up to 64 rows do at most 128
// operations per weight byte, below the card's ~295 (bf16) and ~590 (int8)
// ridges, and at the decode windows (1-24 rows) far below them: the floor
// is the packed weight streamed once at 3.35 TB/s.  So the design is about
// keeping enough weight bytes in flight on every SM, and about touching
// each weight byte once.
//
// Design.
//   - Blocks and split-K.  A block owns a 32-column slice of one packed N
//     tile (BN = 32 rows of the weight), one group of up to 64 rows (every
//     row when there are at most 64), and one K range: split s of S covers
//     packed K tiles [s*K1/S, (s+1)*K1/S).  The host picks S
//     (kernels/mmt4d.py: mmt4d_plan) as the least count that brings the
//     grid to a target number of blocks, at most one split per K tile, so
//     the k/v and down projections (16-64 N slices) still fill the card.
//   - Loads.  Every TMA box row is 128 bytes (tma.cuh): 64 bf16 or 128 int8
//     K elements, so a packed K tile is two boxes in bf16 and one in int8.
//     BN rows of a packed tile are BN x 256 (bf16) or BN x 128 (int8)
//     contiguous bytes.  One producer warp streams them with TMA (the 2-D
//     map over rhs4 viewed as (N1*K1*128, 128) that the wide path uses
//     too) into a ring of 4 or 8 stages guarded by full/empty mbarriers:
//     16-64 KB of weight in flight per block, 2-3 blocks an SM.  The same
//     stage carries the group's rows of that K tile, by the rows policy:
//     PackedRows through a rank-4 map over lhs4 whose box (slab, M0, 1, G)
//     lands G row blocks as consecutive 128-byte rows (rows past M1 read
//     zeros); SkPlainRows through a 2-D map over lhs (M, K) whose box
//     (slab, rows) lands the same rows from plain memory (rows past M read
//     zeros): the row group's G * M0 rows, a slab's 64, or 8 for the
//     decode GEMV.  A box of either kind lands the same bytes at the same
//     shared-memory rows.  Both are 128B-swizzled, so the fragment loads below are free of bank
//     conflicts.  A block reads its rows once per K tile, never per warp.
//   - Products.  Tensor cores with the weight as the A operand (16 weight
//     rows = 16 output columns) and the rows as the narrow B side:
//     mma.sync m16n8k16 (bf16 in, f32 accumulate) or m16n8k32 (s8 in, s32
//     accumulate), so rows are padded to 8, not 64.  Both consume 32 bytes
//     of K a row and share their fragment layouts byte for byte, so one
//     ldmatrix addressing serves both.  Chosen over wgmma m64nNk16 because
//     the row count is known only at run time (N would need one
//     instantiation per multiple of 8, and wgmma's 64-row A side would need
//     BN = 64 and so half the N slices), and because this body is bound by
//     bytes, not by the tensor cores' issue rate.
//   - Warps.  Four consumer warps take the block's K tiles round-robin
//     (warp w: tiles w, w+4, ...), each with its own accumulators; at the
//     end they are summed in warp order through shared memory.  The ring's
//     stage count is a multiple of four, so each stage has one reader.
//   - Merge.  With S > 1 every block writes its partial (up to 64 rows x
//     BN, f32 or int32) to scratch; an atomic counter per output tile
//     (after __threadfence()) finds the last block, which sums the S
//     partials in split order, writes the output and resets the counter to
//     0, all in the one launch.  Every sum has a fixed order, so a repeat
//     call gives the same bits.  int8 partials stay int32 (|sum| reaches
//     127 * 127 * 8192 ~ 1.3e8 > 2^24, where f32 would round), and the
//     scale epilogue runs once, in the block that stores: the result equals
//     the plain version bit for bit.  The wrappers allocate the scratch and
//     the counters; the kernel allocates nothing.
//   - Output.  A row's BN columns are contiguous in any layout (packed
//     out4 or plain rows): 16-byte stores.  Rows past the last (M1 * M0
//     packed, M plain) are never stored.
// Internal linkage throughout (see tma.cuh).
#pragma once

#include <type_traits>

#include "tma.cuh"

namespace {

constexpr int SK_BN = 32;    // output columns (weight rows) of a block of the bf16 and int8 bodies
constexpr int SK_ROWS = 64;  // rows a block holds at most
constexpr int SK_CW = 4;     // consumer warps
constexpr int SK_THREADS = (SK_CW + 1) * 32;

// The int4 weight (w4a8, mmt4d_q4.cu): rhs4_p (N1, K1, 128, 64) uint8, K
// elements 2j and 2j+1 in the low and high nibble of byte j, and one bf16
// scale per G consecutive K elements, s_w4 (N1, K1, 128, 128/G).
template <int G>
struct Nib4 {};

// Per weight format: a weight box row's bytes, the scale bytes a weight
// row brings into a stage, and the products' accumulator.
template <typename T>
struct SkFormat {  // bf16, int8: 128-byte box rows, scales (int8) in the epilogue
  static constexpr int GROUP = 0;
  static constexpr int BOXES = tile_boxes<T>;
  static constexpr int W_ROW = 128;
  static constexpr int S_ROW = 0;
  using Acc = typename TmaElem<T>::Acc;
};
template <int G>
struct SkFormat<Nib4<G>> {  // one 64-byte box row a K tile, its 128/G scales beside it
  static constexpr int GROUP = G;
  static constexpr int BOXES = 1;
  static constexpr int W_ROW = 64;
  static constexpr int S_ROW = TMA_T0 / G * 2;
  using Acc = double;
};

// T: the weight format; NT: the block's 8-row groups (1..8); WN: consumer
// warps across N (1: the warps share one slice of columns and split its K
// tiles; 4: each warp owns a slice of the block and walks every K tile);
// WJ: 16-column MMA fragments a warp's slice holds (2: 32 columns; 1: 16,
// half the accumulators).  A stage is [weight box 0][box 1][scales][rows box 0][box 1]
// (bf16; one weight and one rows box in int8 and int4, scales in int4
// only), the weight and rows boxes 1024-byte aligned (the swizzle atom).
template <typename T, int NT, int WN = 1, int WJ = 2>
struct SkinnyGeo {
  using F = SkFormat<T>;
  using Acc = typename F::Acc;
  static constexpr int WJ_ = WJ;
  static constexpr int WC = 16 * WJ;                  // output columns a warp owns
  static constexpr int BN = WC * WN;                  // output columns a block owns
  static constexpr int BOXES = F::BOXES;
  static constexpr int W_BOX = BN * F::W_ROW;         // BN rows of W_ROW bytes
  static constexpr int S_BYTES = BN * F::S_ROW;
  static constexpr int A_OFF = BOXES * W_BOX + (S_BYTES + 1023) / 1024 * 1024;
  static constexpr int A_BOX = NT * 1024;             // 8 * NT rows of 128 bytes
  static constexpr int STAGE = A_OFF + BOXES * A_BOX;
  // 8 stages where they fit 96 KB (two blocks an SM), else 4: with WN = 1
  // a multiple of the consumer warps, so that warp w, which takes K tiles
  // w, w+4, ..., is the only reader of stages w, w+4, ... and waits on each
  // of their phases in order (an mbarrier parity wait is right only for a
  // waiter that has seen the previous phase); with WN = 4 every warp reads
  // every stage in order.
  static constexpr int STAGES = 96 * 1024 / STAGE >= 8 ? 8 : 4;
  static_assert(96 * 1024 / STAGE >= 4 && STAGES % SK_CW == 0, "ring of whole warp rounds");
  static constexpr int LDR = WC + 4;  // row of a warp's sums, in accumulators
  static constexpr int RED = SK_CW * NT * 8 * LDR * static_cast<int>(sizeof(Acc));
  static constexpr int RING = STAGES * STAGE;
  // int4: each consumer warp's scales of its stage as doubles, [group][row],
  // then the rows' sums, past the ring.
  static constexpr int SCR_OFF = RING > RED ? RING : RED;
  static constexpr int SCR_WARP = F::GROUP ? (TMA_T0 / (F::GROUP ? F::GROUP : 1) + 1) * WC : 0;
  static constexpr int SMEM = SCR_OFF + SK_CW * SCR_WARP * 8 + 1024;
};

// ---- rows policies: where the rows come from and where the output goes

// Output row gr (a flattened packed row) at column n_base of out4 (M1, N1,
// M0, 128).
__device__ __forceinline__ float* packed_out_row(float* out, int m0, int n1, int gr, int n_base) {
  const int b1 = gr / m0;
  return out + ((static_cast<size_t>(b1) * n1 + n_base / TMA_T0) * m0 + (gr - b1 * m0)) * TMA_T0 +
         n_base % TMA_T0;
}

struct SkPackedRows {  // lhs4 (M1, K1, M0, 128) -> out4 (M1, N1, M0, 128)
  float* out;
  int rows;      // M1 * M0
  int m0, n1;
  int group_m1;  // G: row blocks a block holds
  // The rows a block holds, which its box lands: G * M0.
  __device__ __forceinline__ int group_rows() const { return group_m1 * m0; }
  // K elements k0 .. of packed tile kt, for row group blockIdx.z.
  __device__ __forceinline__ void load(void* dst, const CUtensorMap* map, uint64_t* bar, int k0,
                                       int kt) const {
    tma_load4(dst, map, bar, k0, 0, kt, blockIdx.z * group_m1);
  }
  __device__ __forceinline__ float* row(int gr, int n_base) const {
    return packed_out_row(out, m0, n1, gr, n_base);
  }
};

// lhs4 (M1, K1, M0, 128) with M0 > SK_ROWS (the prefill's 128) -> out4: a
// block holds one slab of `slab` rows of one row block; blockIdx.z = m1 *
// (M0 / slab) + the slab.
struct SkSlabRows {
  float* out;
  int rows;  // M1 * M0
  int m0, n1;
  int slab;  // rows a block holds, a divisor of M0
  __device__ __forceinline__ int group_rows() const { return slab; }
  __device__ __forceinline__ void load(void* dst, const CUtensorMap* map, uint64_t* bar, int k0,
                                       int kt) const {
    const int per = m0 / slab;
    tma_load4(dst, map, bar, k0, (blockIdx.z % per) * slab, kt, blockIdx.z / per);
  }
  __device__ __forceinline__ float* row(int gr, int n_base) const {
    return packed_out_row(out, m0, n1, gr, n_base);
  }
};

// lhs (M, K) -> out (M, N): block row group blockIdx.z holds plain rows
// [z * group, (z + 1) * group), the rows its packed twin's block holds (G *
// M0 of SkPackedRows, a slab of SkSlabRows, or 8 for the decode GEMV, M <=
// 8), through a 2-D box of `group` rows (zeros past M).
struct SkPlainRows {
  float* out;
  int rows;   // M
  int n;      // N1 * 128
  int group;  // rows a block holds, at most SK_ROWS
  __device__ __forceinline__ int group_rows() const { return group; }
  __device__ __forceinline__ void load(void* dst, const CUtensorMap* map, uint64_t* bar, int k0,
                                       int kt) const {
    tma_load(dst, map, bar, kt * TMA_T0 + k0, blockIdx.z * group);
  }
  __device__ __forceinline__ float* row(int gr, int n_base) const {
    return out + static_cast<size_t>(gr) * n + n_base;
  }
};

struct SkinnyArgs {
  void* part;        // [tiles][splits][SK_ROWS][BN] partials (splits > 1): f32, int32 or f64
  int* cnt;          // [tiles] arrival counters, 0 between launches (splits > 1)
  int k1;
  int splits;
  Scales sc;         // int8: s_a and s_w; int4: s_a
  const bf16* s_w4;  // int4 only: the group scales
};

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(unsigned addr, unsigned* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d (16 x 8 f32) += a (16 x 16 bf16, row-major) b (16 x 8 bf16, col-major).
__device__ __forceinline__ void mma_16x8(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (16 x 8 s32) += a (16 x 32 s8, row-major) b (32 x 8 s8, col-major): the
// bf16 step's registers hold the same bytes of the same rows.
__device__ __forceinline__ void mma_16x8(int* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (16 x 8 s32) += a (16 x 16 s8, row-major: a[0] row g, a[1] row g+8, K
// 4t..4t+3) b (16 x 8 s8: K 4t..4t+3 of column g).
__device__ __forceinline__ void mma_16x8_k16(int* d, unsigned a0, unsigned a1, unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

struct __align__(16) D4 {  // four f64 sums
  double x, y, z, w;
};

template <typename Acc>
struct SkVec;  // four accumulators, as one load
template <>
struct SkVec<float> { using type = float4; };
template <>
struct SkVec<int> { using type = int4; };
template <>
struct SkVec<double> { using type = D4; };

__device__ __forceinline__ void add4(float4& v, const float4& x) {
  v.x += x.x; v.y += x.y; v.z += x.z; v.w += x.w;
}
__device__ __forceinline__ void add4(int4& v, const int4& x) {
  v.x += x.x; v.y += x.y; v.z += x.z; v.w += x.w;
}
__device__ __forceinline__ void add4(D4& v, const D4& x) {
  v.x += x.x; v.y += x.y; v.z += x.z; v.w += x.w;
}

// Four partials from global memory, through L2 (written by other blocks).
__device__ __forceinline__ float4 ldcg4(const float4* p) { return __ldcg(p); }
__device__ __forceinline__ int4 ldcg4(const int4* p) { return __ldcg(p); }
__device__ __forceinline__ D4 ldcg4(const D4* p) {
  const double2 a = __ldcg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcg(reinterpret_cast<const double2*>(p) + 1);
  return D4{a.x, a.y, b.x, b.y};
}

// The stored value of four summed columns from n of row gr: the f32 sums
// as they are; int32 sums through the scale epilogue; the int4 body's f64
// sums rounded to f32 once, then * s_a.
__device__ __forceinline__ float4 finish4(const float4& v, int, int, const Scales&) { return v; }
__device__ __forceinline__ float4 finish4(const int4& v, int gr, int n, const Scales& sc) {
  return scale4(make_float4(static_cast<float>(v.x), static_cast<float>(v.y),
                            static_cast<float>(v.z), static_cast<float>(v.w)),
                sc.s_a[gr], sc.s_w + n);
}
__device__ __forceinline__ float4 finish4(const D4& v, int gr, int, const Scales& sc) {
  const float sa = sc.s_a[gr];
  return make_float4(static_cast<float>(v.x) * sa, static_cast<float>(v.y) * sa,
                     static_cast<float>(v.z) * sa, static_cast<float>(v.w) * sa);
}

// Shared-memory address of 16-byte chunk `ch` (0..7) of 128-byte row `r` in
// a 128B-swizzled box at `base` (1024-aligned): the chunk index is XORed
// with the row's index within its 8-row atom.
__device__ __forceinline__ unsigned sw128(unsigned base, int r, int ch) {
  return base + r * 128 + ((ch ^ (r & 7)) << 4);
}

// ---- the int4 products
//
// A stage holds the block's weight rows (64 bytes, 64B-swizzled: 16-byte
// chunk ch of row r sits at chunk ch ^ ((r >> 1) & 3)), their 128/G bf16
// scales each, and the rows (int8, 128B-swizzled, as in the int8 body).
// One step takes 32 K elements: 16 nibble bytes of a weight row, 32 bytes
// of a row.  For the m16n8k32 / m16n8k16 s8 fragments, lane (g = lane/4,
// t = lane%4) needs K 4t..4t+3 and 16+4t..16+4t+3 of its weight rows: the
// nibble bytes 2t, 2t+1, 8+2t and 9+2t of the chunk.  Two 4-byte loads and
// a byte permute gather them; one more permute per half restores the
// natural K order (byte j holds K 2j low, 2j+1 high), so the rows' B
// fragments are the int8 body's ldmatrix fragments unchanged.  Each nibble
// lands in the high half of its byte: the s8 operand is 16 w, exact, and
// the integer sum 16 s.
//
// The rescale.  A group's sum starts from the constant Q4_C in its int32
// fragment: 0x40F80000 + 16 s is the high word of the double 1.5 * 2^16 +
// s (|s| <= 32 * 128 * 8 = 2^15), so the f64 term costs one DFMA, acc +=
// (1.5 * 2^16 + s) * scale, with no conversion: (1.5 * 2^16 + s) has 17
// significant bits and a bf16 scale 8, so the product is exact.  Each warp
// also sums its weight rows' scales (exact) and at the end subtracts 1.5 *
// 2^16 times that sum once (exact: the result, the warp's true sum, is
// representable).  The sums are exact in f64 while a row's group scales
// span less than 2^(35 - log2 K) (2^22 at K = 8192; the plain version's f64
// sum needs 2^(36 - log2 K)), so they do not depend on the order: every
// warp, split and merge order gives the plain version's bits.
constexpr int Q4_C = 0x40F80000;
constexpr double Q4_OFFSET = 98304.0;  // 1.5 * 2^16

// acc[e] += (the group's f64 term of fragment element e), scales s0 (rows
// g) and s1 (rows g + 8).
__device__ __forceinline__ void q4_rescale(double* acc, const int* c, double s0, double s1) {
  acc[0] = fma(__hiloint2double(c[0], 0), s0, acc[0]);
  acc[1] = fma(__hiloint2double(c[1], 0), s0, acc[1]);
  acc[2] = fma(__hiloint2double(c[2], 0), s1, acc[2]);
  acc[3] = fma(__hiloint2double(c[3], 0), s1, acc[3]);
}

// One stage's int4 products into acc[j][q] (weight rows j*16 + g (+8) of
// this warp's slice, rows q*8 + 2t (+1)); ssum[j][h] sums the scales of
// weight row j*16 + h*8 + g.  dsc: the warp's scratch (Geo::SCR_WARP
// doubles).
template <class Geo, int NT>
__device__ __forceinline__ void q4_stage(double (&acc)[Geo::WJ_][NT][4],
                                         double (&ssum)[Geo::WJ_][2], const unsigned char* st,
                                         unsigned st_addr, int wcol, int lane, double* dsc) {
  constexpr int WJ = Geo::WJ_;
  constexpr int G = Geo::F::GROUP;
  constexpr int GPT = TMA_T0 / G;  // groups a K tile
  const int g = lane >> 2;
  const int t = lane & 3;
  const unsigned char* wrows = st + wcol * Geo::WC * 64;
  const unsigned short* scl =
      reinterpret_cast<const unsigned short*>(st + Geo::W_BOX) + wcol * Geo::WC * GPT;
  const unsigned ab = st_addr + Geo::A_OFF;
  const unsigned pick = (t & 1) ? 0x7632u : 0x5410u;
  const int rb = lane & 7;
  const int cb = (lane >> 3) & 1;
  // The warp's scales of this K tile as doubles, [group][row], and each
  // row's sum after them: converted once, by the lane (two lanes at 16 rows
  // a warp) that owns the row, not by each of the four lanes that read it.
  constexpr int WC = Geo::WC;
  constexpr int LPR = 32 / WC;  // lanes a row
  __syncwarp();                 // the previous stage's reads are done
  {
    const int r = lane % WC;
    double rs = 0.0;
#pragma unroll
    for (int gi = lane / WC; gi < GPT; gi += LPR) {
      const double v = __uint_as_float(static_cast<unsigned>(scl[r * GPT + gi]) << 16);
      dsc[gi * WC + r] = v;
      rs += v;
    }
    if constexpr (LPR == 2) rs += __shfl_xor_sync(0xffffffffu, rs, 16);
    if (lane < WC) dsc[GPT * WC + r] = rs;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < WJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) ssum[j][h] += dsc[GPT * WC + j * 16 + h * 8 + g];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // 32 K elements a step
    unsigned xa[2 * WJ], ya[2 * WJ];  // weight rows i*8 + g: K 4t.. and 16+4t.., 16 w each
#pragma unroll
    for (int i = 0; i < 2 * WJ; ++i) {
      const int r = i * 8 + g;
      const unsigned char* chunk = wrows + r * 64 + ((kk ^ ((r >> 1) & 3)) << 4) + 4 * (t >> 1);
      const unsigned w = __byte_perm(*reinterpret_cast<const unsigned*>(chunk),
                                     *reinterpret_cast<const unsigned*>(chunk + 8), pick);
      const unsigned w4 = w << 4;
      xa[i] = __byte_perm(w4, w, 0x5140) & 0xF0F0F0F0u;
      ya[i] = __byte_perm(w4, w, 0x7362) & 0xF0F0F0F0u;
    }
    constexpr int GS = 32 / G;  // groups a step
    double sc[GS][WJ][2];
#pragma unroll
    for (int gs = 0; gs < GS; ++gs)
#pragma unroll
      for (int j = 0; j < WJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sc[gs][j][h] = dsc[(kk * GS + gs) * WC + j * 16 + h * 8 + g];
        }
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      unsigned fb[2];
      ldsm_x2(sw128(ab, q * 8 + rb, 2 * kk + cb), fb);
#pragma unroll
      for (int j = 0; j < WJ; ++j) {
        if constexpr (G == 32) {
          int c[4] = {Q4_C, Q4_C, Q4_C, Q4_C};
          const unsigned fa[4] = {xa[2 * j], xa[2 * j + 1], ya[2 * j], ya[2 * j + 1]};
          mma_16x8(c, fa, fb);
          q4_rescale(acc[j][q], c, sc[0][j][0], sc[0][j][1]);
        } else {
          int c[4] = {Q4_C, Q4_C, Q4_C, Q4_C};
          mma_16x8_k16(c, xa[2 * j], xa[2 * j + 1], fb[0]);
          q4_rescale(acc[j][q], c, sc[0][j][0], sc[0][j][1]);
          int d[4] = {Q4_C, Q4_C, Q4_C, Q4_C};
          mma_16x8_k16(d, ya[2 * j], ya[2 * j + 1], fb[1]);
          q4_rescale(acc[j][q], d, sc[1][j][0], sc[1][j][1]);
        }
      }
    }
  }
}

template <typename T, int NT, class P, int WN = 1, int WJ = 2>
__global__ void __launch_bounds__(SK_THREADS)
skinny_kernel(const __grid_constant__ CUtensorMap tm_lhs,
              const __grid_constant__ CUtensorMap tm_rhs, const P p, const SkinnyArgs a) {
  using Geo = SkinnyGeo<T, NT, WN, WJ>;
  using F = typename Geo::F;
  using Acc = typename Geo::Acc;
  using V4 = typename SkVec<Acc>::type;
  constexpr int STAGES = Geo::STAGES;
  constexpr int BOXES = Geo::BOXES;
  constexpr int BN = Geo::BN;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ int last_block;
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_base = blockIdx.x * BN;
  const int nt = n_base / TMA_T0;
  const int split = blockIdx.y;
  const int kt_lo = split * a.k1 / a.splits;
  const int n_kt = (split + 1) * a.k1 / a.splits - kt_lo;
  const int group_rows = p.group_rows();
  const int row_base = blockIdx.z * group_rows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);    // the producer's arrive (+ the copies' bytes)
      mbar_init(&empty[s], WN);  // the consuming warps' arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == SK_CW) {
    // ---- producer: one lane keeps the ring full
    if (lane == 0) {
      const int row0 = nt * a.k1 * TMA_T0 + n_base % TMA_T0;  // weight row of tile (nt, 0)
      const unsigned tx = BOXES * (Geo::W_BOX + 128 * group_rows) + Geo::S_BYTES;
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % STAGES;
        const int kt = kt_lo + i;
        unsigned char* st = smem + s * Geo::STAGE;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        mbar_arrive_tx(&full[s], tx);
#pragma unroll
        for (int b = 0; b < BOXES; ++b)
          tma_load(st + b * Geo::W_BOX, &tm_rhs, &full[s], b * box_k<T>, row0 + kt * TMA_T0);
        if constexpr (F::GROUP > 0)
          bulk_load(st + Geo::W_BOX,
                    a.s_w4 + static_cast<size_t>(row0 + kt * TMA_T0) * (TMA_T0 / F::GROUP),
                    Geo::S_BYTES, &full[s]);
#pragma unroll
        for (int b = 0; b < BOXES; ++b)
          p.load(st + Geo::A_OFF + b * Geo::A_BOX, &tm_lhs, &full[s], b * box_k<T>, kt);
      }
    }
    return;
  }

  // ---- consumers: with WN = 1 warp w takes the block's K tiles w, w + 4,
  // ...; with WN = 4 every K tile, for its own WC columns
  const int wcol = WN == 1 ? 0 : warp;  // this warp's slice of the block
  Acc acc[WJ][NT][4];
#pragma unroll
  for (int j = 0; j < WJ; ++j)
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][q][e] = 0;
  double ssum[WJ][2] = {};  // int4: the scales' sums
  const int ra = lane & 15;        // ldmatrix row of the weight (x4)
  const int ca = lane >> 4;        // and its chunk offset
  const int rb = lane & 7;         // ldmatrix row of the rows (x2)
  const int cb = (lane >> 3) & 1;  // and its chunk offset
  for (int i = WN == 1 ? warp : 0; i < n_kt; i += WN == 1 ? SK_CW : 1) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const unsigned st = smem_addr(smem + s * Geo::STAGE);
    if constexpr (F::GROUP > 0) {
      q4_stage<Geo, NT>(acc, ssum, smem + s * Geo::STAGE, st, wcol, lane,
                        reinterpret_cast<double*>(smem + Geo::SCR_OFF) + warp * Geo::SCR_WARP);
    } else {
#pragma unroll
      for (int kk = 0; kk < BOXES * 4; ++kk) {  // 32 bytes of K a step, four a box
        const int h = kk >> 2;         // box
        const int c0 = (kk & 3) * 2;   // first 16-byte chunk of the step
        const unsigned wb = st + h * Geo::W_BOX + wcol * Geo::WC * 128;
        const unsigned ab = st + Geo::A_OFF + h * Geo::A_BOX;
        unsigned fa[WJ][4];
#pragma unroll
        for (int j = 0; j < WJ; ++j) ldsm_x4(sw128(wb, j * 16 + ra, c0 + ca), fa[j]);
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          unsigned fb[2];
          ldsm_x2(sw128(ab, q * 8 + rb, c0 + cb), fb);
#pragma unroll
          for (int j = 0; j < WJ; ++j) mma_16x8(acc[j][q], fa[j], fb);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if constexpr (F::GROUP > 0) {
#pragma unroll
    for (int j = 0; j < WJ; ++j)
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][q][e] = fma(-Q4_OFFSET, ssum[j][e >> 1], acc[j][q][e]);
  }

  // ---- the warps' sums, in warp order (WN = 1), through the drained ring:
  // every consumer has waited on every stage it read, so no copy is in
  // flight.
  asm volatile("bar.sync 1, %0;\n" ::"n"(SK_CW * 32) : "memory");
  Acc* red = reinterpret_cast<Acc*>(smem);  // [warp][8 * NT rows][LDR]
  {
    Acc* rw = red + warp * NT * 8 * Geo::LDR;
    const int g = lane >> 2;
    const int t2 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < WJ; ++j)
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        // acc[j][q]: (weight row j*16 + g (+8), row q*8 + t2 (+1))
        const int n = j * 16 + g;
        const int r = q * 8 + t2;
        rw[r * Geo::LDR + n] = acc[j][q][0];
        rw[(r + 1) * Geo::LDR + n] = acc[j][q][1];
        rw[r * Geo::LDR + n + 8] = acc[j][q][2];
        rw[(r + 1) * Geo::LDR + n + 8] = acc[j][q][3];
      }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(SK_CW * 32) : "memory");
  const int tid = threadIdx.x;
  const int vr = min(group_rows, p.rows - row_base);  // rows this block stores
  constexpr int C4 = BN / 4;                          // 4-vectors a row
  auto store = [&](int r, int c, const V4& v) {
    *reinterpret_cast<float4*>(p.row(row_base + r, n_base) + c) =
        finish4(v, row_base + r, n_base + c, a.sc);
  };
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  Acc* part_of = a.splits > 1
                     ? static_cast<Acc*>(a.part) + static_cast<size_t>(tile) * a.splits * SK_ROWS * BN
                     : nullptr;
  for (int e = tid; e < vr * C4; e += SK_CW * 32) {
    const int r = e / C4;
    const int c = (e % C4) * 4;
    const int w0 = c / Geo::WC;  // the warp that owns column c (WN > 1), else 0
    V4 v = *reinterpret_cast<const V4*>(red + (w0 * NT * 8 + r) * Geo::LDR + c % Geo::WC);
    if constexpr (WN == 1) {
#pragma unroll
      for (int w = 1; w < SK_CW; ++w)
        add4(v, *reinterpret_cast<const V4*>(red + (w * NT * 8 + r) * Geo::LDR + c));
    }
    if (a.splits == 1) {
      store(r, c, v);
    } else {
      *reinterpret_cast<V4*>(part_of + (static_cast<size_t>(split) * SK_ROWS + r) * BN + c) = v;
    }
  }
  if (a.splits == 1) return;

  // ---- merge: the last split of this output tile to finish
  __threadfence();
  asm volatile("bar.sync 1, %0;\n" ::"n"(SK_CW * 32) : "memory");
  if (tid == 0) last_block = atomicAdd(a.cnt + tile, 1) == a.splits - 1;
  asm volatile("bar.sync 1, %0;\n" ::"n"(SK_CW * 32) : "memory");
  if (!last_block) return;
  __threadfence();
  for (int e = tid; e < vr * C4; e += SK_CW * 32) {
    const int r = e / C4;
    const int c = (e % C4) * 4;
    const V4* src = reinterpret_cast<const V4*>(part_of + r * BN + c);
    V4 v = ldcg4(src);
    for (int sp = 1; sp < a.splits; ++sp) add4(v, ldcg4(src + sp * (SK_ROWS * BN / 4)));
    store(r, c, v);
  }
  if (tid == 0) a.cnt[tile] = 0;  // ready for the next launch
}

template <typename T, int NT, class P, int WN = 1, int WJ = 2>
cudaError_t launch_skinny_nt(const CUtensorMap& tm_lhs, const CUtensorMap& tm_rhs, const P& p,
                             const SkinnyArgs& a, dim3 grid, cudaStream_t s) {
  auto kern = skinny_kernel<T, NT, P, WN, WJ>;
  constexpr int smem = SkinnyGeo<T, NT, WN, WJ>::SMEM;
  static unsigned long long opted = 0;  // devices whose shared-memory limit is raised
  const cudaError_t e = opt_in_smem(kern, smem, opted);
  if (e != cudaSuccess) return e;
  kern<<<grid, SK_THREADS, smem, s>>>(tm_lhs, tm_rhs, p, a);
  return cudaGetLastError();
}

bool skinny_plan_ok(int n1, int k1, int splits, const void* part, const int* cnt) {
  return n1 >= 1 && k1 >= 1 && splits >= 1 && splits <= k1 &&
         (splits == 1 || (part != nullptr && cnt != nullptr));
}

// Packed rows lhs4 (M1, K1, M0, 128) x rhs4 -> out4, K in `splits` ranges.
// With splits > 1, `part` holds tiles * splits * SK_ROWS * SK_BN 4-byte
// words and `cnt` tiles zeroed ints, tiles = (N1*128 / SK_BN) * ceil(M1 /
// G), G = min(M1, SK_ROWS / M0) (kernels/mmt4d.py mirrors this).  `sc`:
// the int8 scales.
template <typename T>
cudaError_t launch_skinny(const void* lhs4, const void* rhs4, float* out4, int m1, int m0, int n1,
                          int k1, int splits, void* part, int* cnt, const Scales& sc,
                          cudaStream_t s) {
  if (m1 < 1 || m0 < 1 || m0 > SK_ROWS || !skinny_plan_ok(n1, k1, splits, part, cnt))
    return cudaErrorInvalidValue;
  const int g = std::min(m1, SK_ROWS / m0);
  CUtensorMap tm_lhs, tm_rhs;
  cudaError_t e = encode_packed_rows<T>(&tm_lhs, lhs4, m1, m0, k1, m0, g);
  if (e == cudaSuccess) e = weight_map<T>(&tm_rhs, rhs4, n1, k1, SK_BN);
  if (e != cudaSuccess) return e;
  const SkPackedRows p{out4, m1 * m0, m0, n1, g};
  const SkinnyArgs a{part, cnt, k1, splits, sc, nullptr};
  const dim3 grid(n1 * TMA_T0 / SK_BN, splits, (m1 + g - 1) / g);
  switch ((g * m0 + 7) / 8) {  // 8-row groups a block holds
#define CASE(NT) \
  case NT: return launch_skinny_nt<T, NT>(tm_lhs, tm_rhs, p, a, grid, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

// The map over plain rows lhs (M, K1*128) whose box lands `group` rows.
template <typename T>
cudaError_t plain_rows_map(CUtensorMap* map, const void* lhs, int m, int k1, int group) {
  return encode_map<T>(map, lhs, m, static_cast<uint64_t>(k1) * TMA_T0, group);
}

// Plain rows lhs (M, K1*128), M <= 8 (one 8-row group), x rhs4 -> out (M,
// N1*128); the scratch as above with one row group.
template <typename T>
cudaError_t launch_skinny_plain(const void* lhs, const void* rhs4, float* out, int m, int n1,
                                int k1, int splits, void* part, int* cnt, cudaStream_t s) {
  if (m < 1 || m > 8 || !skinny_plan_ok(n1, k1, splits, part, cnt)) return cudaErrorInvalidValue;
  CUtensorMap tm_lhs, tm_rhs;
  cudaError_t e = plain_rows_map<T>(&tm_lhs, lhs, m, k1, 8);
  if (e == cudaSuccess) e = weight_map<T>(&tm_rhs, rhs4, n1, k1, SK_BN);
  if (e != cudaSuccess) return e;
  const SkPlainRows p{out, m, n1 * TMA_T0, 8};
  const SkinnyArgs a{part, cnt, k1, splits, Scales{}, nullptr};
  return launch_skinny_nt<T, 1>(tm_lhs, tm_rhs, p, a, dim3(n1 * TMA_T0 / SK_BN, splits, 1), s);
}

// The packed GEMMs' plain-row entry on this body: lhs (M, K1*128) x rhs4 ->
// out (M, N1*128) under the plan of the packed twin at M1 = ceil(M / M0):
// the same grid, K splits and row groups of G = min(M1, SK_ROWS / M0) row
// blocks (G * M0 rows a block, which need not be a multiple of 8: the
// shared-memory rows past them feed only accumulators that are never
// stored), so each row's sums run in the same order and the result equals
// unpack(mmt4d(pack(x))) bit for bit.  Rows past M are never read (TMA
// fills zeros, as the packed twin's pad rows hold) nor stored, and `sc`'s
// s_a is read only for rows < M.  The scratch as launch_skinny's.
template <typename T>
cudaError_t launch_skinny_rows(const void* lhs, const void* rhs4, float* out, int m, int m0,
                               int n1, int k1, int splits, void* part, int* cnt, const Scales& sc,
                               cudaStream_t s) {
  if (m < 1 || m0 < 1 || m0 > SK_ROWS || !skinny_plan_ok(n1, k1, splits, part, cnt))
    return cudaErrorInvalidValue;
  const int m1 = (m + m0 - 1) / m0;
  const int group = std::min(m1, SK_ROWS / m0) * m0;
  CUtensorMap tm_lhs, tm_rhs;
  cudaError_t e = plain_rows_map<T>(&tm_lhs, lhs, m, k1, group);
  if (e == cudaSuccess) e = weight_map<T>(&tm_rhs, rhs4, n1, k1, SK_BN);
  if (e != cudaSuccess) return e;
  const SkPlainRows p{out, m, n1 * TMA_T0, group};
  const SkinnyArgs a{part, cnt, k1, splits, sc, nullptr};
  const dim3 grid(n1 * TMA_T0 / SK_BN, splits, (m + group - 1) / group);
  switch ((group + 7) / 8) {
#define CASE(NT) \
  case NT: return launch_skinny_nt<T, NT>(tm_lhs, tm_rhs, p, a, grid, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
