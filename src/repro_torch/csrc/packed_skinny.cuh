// The "skinny" GEMM body: few rows times the packed weight, K split across
// blocks and merged in the same launch.  Shared by the packed GEMM at up to
// 64 rows (mmt4d.cu, kernel 4), the packed decode GEMV (mmt4d_gemv.cu,
// kernel 5, the case M1 = 1), the decode GEMV on plain rows (fused_gemv.cu,
// kernel 1) in bf16, and the int8 packed GEMM at up to 64 rows
// (mmt4d_q8.cu, kernel 6).
//
//   packed rows: lhs4 (M1, K1, M0, 128) x rhs4 (N1, K1, 128, 128) -> out4 (M1, N1, M0, 128) f32,
//     out4[m1, n1, m0, n0] = sum_{k1, k0} lhs4[m1, k1, m0, k0] * rhs4[n1, k1, n0, k0]
//   plain rows:  lhs (M, K1*128) x rhs4 -> out (M, N1*128) f32, M <= 8
//   int8: the sum in int32, then (float(sum) * s_a[row]) * s_w[col].
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
//     zeros); PlainRows through a 2-D map over lhs (M <= 8, K) whose box
//     (64, 8) lands the rows padded to 8 (rows past M read zeros).  Both
//     are 128B-swizzled, so the fragment loads below are free of bank
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
//   - Output.  A row's BN columns are contiguous in either layout: 16-byte
//     stores.  Rows past the last are never stored.
// Internal linkage throughout (see tma.cuh).
#pragma once

#include <type_traits>

#include "tma.cuh"

namespace {

constexpr int SK_BN = 32;    // output columns (weight rows) a block owns
constexpr int SK_ROWS = 64;  // rows a block holds at most
constexpr int SK_CW = 4;     // consumer warps
constexpr int SK_THREADS = (SK_CW + 1) * 32;

// T: the operand type; NT: the block's 8-row groups (1..8).  A stage is
// [weight box 0][box 1][rows box 0][box 1] (bf16; one box each in int8),
// each box 1024-byte aligned (the swizzle atom).
template <typename T, int NT>
struct SkinnyGeo {
  static constexpr int BOXES = tile_boxes<T>;
  static constexpr int W_BOX = SK_BN * 128;  // BN rows of 128 bytes
  static constexpr int A_BOX = NT * 1024;    // 8 * NT rows of 128 bytes
  static constexpr int STAGE = BOXES * (W_BOX + A_BOX);
  // 8 stages where they fit 96 KB (two blocks an SM), else 4: a multiple
  // of the consumer warps, so that warp w, which takes K tiles w, w+4, ...,
  // is the only reader of stages w, w+4, ... and waits on each of their
  // phases in order (an mbarrier parity wait is right only for a waiter
  // that has seen the previous phase).
  static constexpr int STAGES = 96 * 1024 / STAGE >= 8 ? 8 : 4;
  static_assert(96 * 1024 / STAGE >= 4 && STAGES % SK_CW == 0, "ring of whole warp rounds");
  static constexpr int LDR = SK_BN + 4;  // row of the warps' sums, in 4-byte words
  static constexpr int RED = SK_CW * NT * 8 * LDR * 4;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = (RING > RED ? RING : RED) + 1024;
};

// ---- rows policies: where the rows come from and where the output goes

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
    const int b1 = gr / m0;
    return out + ((static_cast<size_t>(b1) * n1 + n_base / TMA_T0) * m0 + (gr - b1 * m0)) * TMA_T0 +
           n_base % TMA_T0;
  }
};

struct SkPlainRows {  // lhs (M, K) -> out (M, N), M <= 8: one 8-row group
  float* out;
  int rows;  // M
  int n;     // N1 * 128
  // The box's rows: 8, zeros past M.
  __device__ __forceinline__ int group_rows() const { return 8; }
  __device__ __forceinline__ void load(void* dst, const CUtensorMap* map, uint64_t* bar, int k0,
                                       int kt) const {
    tma_load(dst, map, bar, kt * TMA_T0 + k0, 0);
  }
  __device__ __forceinline__ float* row(int gr, int n_base) const {
    return out + static_cast<size_t>(gr) * n + n_base;
  }
};

struct SkinnyArgs {
  void* part;   // [tiles][splits][SK_ROWS][SK_BN] f32 or int32 partials (splits > 1)
  int* cnt;     // [tiles] arrival counters, 0 between launches (splits > 1)
  int k1;
  int splits;
  Scales sc;    // int8 only
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

__device__ __forceinline__ void add4(float4& v, const float4& x) {
  v.x += x.x; v.y += x.y; v.z += x.z; v.w += x.w;
}
__device__ __forceinline__ void add4(int4& v, const int4& x) {
  v.x += x.x; v.y += x.y; v.z += x.z; v.w += x.w;
}

// The stored value of four summed columns from n of row gr: the f32 sums
// as they are; int32 sums through the scale epilogue.
__device__ __forceinline__ float4 finish4(const float4& v, int, int, const Scales&) { return v; }
__device__ __forceinline__ float4 finish4(const int4& v, int gr, int n, const Scales& sc) {
  return scale4(make_float4(static_cast<float>(v.x), static_cast<float>(v.y),
                            static_cast<float>(v.z), static_cast<float>(v.w)),
                sc.s_a[gr], sc.s_w + n);
}

// Shared-memory address of 16-byte chunk `ch` (0..7) of 128-byte row `r` in
// a 128B-swizzled box at `base` (1024-aligned): the chunk index is XORed
// with the row's index within its 8-row atom.
__device__ __forceinline__ unsigned sw128(unsigned base, int r, int ch) {
  return base + r * 128 + ((ch ^ (r & 7)) << 4);
}

template <typename T, int NT, class P>
__global__ void __launch_bounds__(SK_THREADS)
skinny_kernel(const __grid_constant__ CUtensorMap tm_lhs,
              const __grid_constant__ CUtensorMap tm_rhs, const P p, const SkinnyArgs a) {
  using G = SkinnyGeo<T, NT>;
  using Acc = typename TmaElem<T>::Acc;
  using V4 = typename std::conditional<sizeof(T) == 1, int4, float4>::type;
  constexpr int STAGES = G::STAGES;
  constexpr int BOXES = G::BOXES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ int last_block;
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_base = blockIdx.x * SK_BN;
  const int nt = n_base / TMA_T0;
  const int split = blockIdx.y;
  const int kt_lo = split * a.k1 / a.splits;
  const int n_kt = (split + 1) * a.k1 / a.splits - kt_lo;
  const int group_rows = p.group_rows();
  const int row_base = blockIdx.z * group_rows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive (+ the copies' bytes)
      mbar_init(&empty[s], 1);  // the consuming warp's arrive
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == SK_CW) {
    // ---- producer: one lane keeps the ring full
    if (lane == 0) {
      const int row0 = nt * a.k1 * TMA_T0 + n_base % TMA_T0;  // weight row of tile (nt, 0)
      const unsigned tx = BOXES * 128 * (SK_BN + group_rows);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % STAGES;
        const int kt = kt_lo + i;
        unsigned char* st = smem + s * G::STAGE;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        mbar_arrive_tx(&full[s], tx);
#pragma unroll
        for (int b = 0; b < BOXES; ++b)
          tma_load(st + b * G::W_BOX, &tm_rhs, &full[s], b * box_k<T>, row0 + kt * TMA_T0);
#pragma unroll
        for (int b = 0; b < BOXES; ++b)
          p.load(st + BOXES * G::W_BOX + b * G::A_BOX, &tm_lhs, &full[s], b * box_k<T>, kt);
      }
    }
    return;
  }

  // ---- consumers: warp w takes the block's K tiles w, w + 4, ...
  Acc acc[2][NT][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][q][e] = 0;
  const int ra = lane & 15;        // ldmatrix row of the weight (x4)
  const int ca = lane >> 4;        // and its chunk offset
  const int rb = lane & 7;         // ldmatrix row of the rows (x2)
  const int cb = (lane >> 3) & 1;  // and its chunk offset
  for (int i = warp; i < n_kt; i += SK_CW) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const unsigned st = smem_addr(smem + s * G::STAGE);
#pragma unroll
    for (int kk = 0; kk < BOXES * 4; ++kk) {  // 32 bytes of K a step, four a box
      const int h = kk >> 2;         // box
      const int c0 = (kk & 3) * 2;   // first 16-byte chunk of the step
      const unsigned wb = st + h * G::W_BOX;
      const unsigned ab = st + BOXES * G::W_BOX + h * G::A_BOX;
      unsigned fa[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) ldsm_x4(sw128(wb, j * 16 + ra, c0 + ca), fa[j]);
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        unsigned fb[2];
        ldsm_x2(sw128(ab, q * 8 + rb, c0 + cb), fb);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_16x8(acc[j][q], fa[j], fb);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- the warps' sums, in warp order, through the drained ring: every
  // consumer has waited on every stage it read, so no copy is in flight.
  asm volatile("bar.sync 1, %0;\n" ::"n"(SK_CW * 32) : "memory");
  Acc* red = reinterpret_cast<Acc*>(smem);  // [warp][8 * NT rows][LDR]
  {
    Acc* rw = red + warp * NT * 8 * G::LDR;
    const int g = lane >> 2;
    const int t2 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        // acc[j][q]: (weight row j*16 + g (+8), row q*8 + t2 (+1))
        const int n = j * 16 + g;
        const int r = q * 8 + t2;
        rw[r * G::LDR + n] = acc[j][q][0];
        rw[(r + 1) * G::LDR + n] = acc[j][q][1];
        rw[r * G::LDR + n + 8] = acc[j][q][2];
        rw[(r + 1) * G::LDR + n + 8] = acc[j][q][3];
      }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(SK_CW * 32) : "memory");
  const int tid = threadIdx.x;
  const int vr = min(group_rows, p.rows - row_base);  // rows this block stores
  constexpr int C4 = SK_BN / 4;                       // 4-vectors a row
  auto store = [&](int r, int c, const V4& v) {
    *reinterpret_cast<float4*>(p.row(row_base + r, n_base) + c) =
        finish4(v, row_base + r, n_base + c, a.sc);
  };
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  Acc* part_of = a.splits > 1
                     ? static_cast<Acc*>(a.part) + static_cast<size_t>(tile) * a.splits * SK_ROWS * SK_BN
                     : nullptr;
  for (int e = tid; e < vr * C4; e += SK_CW * 32) {
    const int r = e / C4;
    const int c = (e % C4) * 4;
    V4 v = *reinterpret_cast<const V4*>(red + r * G::LDR + c);
#pragma unroll
    for (int w = 1; w < SK_CW; ++w)
      add4(v, *reinterpret_cast<const V4*>(red + (w * NT * 8 + r) * G::LDR + c));
    if (a.splits == 1) {
      store(r, c, v);
    } else {
      *reinterpret_cast<V4*>(part_of + (static_cast<size_t>(split) * SK_ROWS + r) * SK_BN + c) = v;
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
    const V4* src = reinterpret_cast<const V4*>(part_of + r * SK_BN + c);
    V4 v = __ldcg(src);
    for (int sp = 1; sp < a.splits; ++sp) add4(v, __ldcg(src + sp * (SK_ROWS * SK_BN / 4)));
    store(r, c, v);
  }
  if (tid == 0) a.cnt[tile] = 0;  // ready for the next launch
}

template <typename T, int NT, class P>
cudaError_t launch_skinny_nt(const CUtensorMap& tm_lhs, const CUtensorMap& tm_rhs, const P& p,
                             const SkinnyArgs& a, dim3 grid, cudaStream_t s) {
  auto kern = skinny_kernel<T, NT, P>;
  static unsigned long long opted = 0;  // devices whose shared-memory limit is raised
  const cudaError_t e = opt_in_smem(kern, SkinnyGeo<T, NT>::SMEM, opted);
  if (e != cudaSuccess) return e;
  kern<<<grid, SK_THREADS, SkinnyGeo<T, NT>::SMEM, s>>>(tm_lhs, tm_rhs, p, a);
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
  const SkinnyArgs a{part, cnt, k1, splits, sc};
  const dim3 grid(n1 * TMA_T0 / SK_BN, splits, (m1 + g - 1) / g);
  switch ((g * m0 + 7) / 8) {  // 8-row groups a block holds
#define CASE(NT) \
  case NT: return launch_skinny_nt<T, NT>(tm_lhs, tm_rhs, p, a, grid, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

// Plain rows lhs (M, K1*128), M <= 8 (one 8-row group), x rhs4 -> out (M,
// N1*128); the scratch as above with one row group.
template <typename T>
cudaError_t launch_skinny_plain(const void* lhs, const void* rhs4, float* out, int m, int n1,
                                int k1, int splits, void* part, int* cnt, cudaStream_t s) {
  if (m < 1 || m > 8 || !skinny_plan_ok(n1, k1, splits, part, cnt)) return cudaErrorInvalidValue;
  CUtensorMap tm_lhs, tm_rhs;
  cudaError_t e = encode_map<T>(&tm_lhs, lhs, m, static_cast<uint64_t>(k1) * TMA_T0, 8);
  if (e == cudaSuccess) e = weight_map<T>(&tm_rhs, rhs4, n1, k1, SK_BN);
  if (e != cudaSuccess) return e;
  const SkPlainRows p{out, m, n1 * TMA_T0};
  const SkinnyArgs a{part, cnt, k1, splits, Scales{}};
  return launch_skinny_nt<T, 1>(tm_lhs, tm_rhs, p, a, dim3(n1 * TMA_T0 / SK_BN, splits, 1), s);
}

}  // namespace
