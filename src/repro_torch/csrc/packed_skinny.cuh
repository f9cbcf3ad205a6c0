// The packed "skinny" GEMM body: few packed rows times the packed weight,
// K split across blocks and merged in the same launch.  Shared by the
// packed GEMM at up to 64 rows (mmt4d.cu, kernel 4) and the packed decode
// GEMV (mmt4d_gemv.cu, kernel 5, which is the case M1 = 1), bf16 only.
//
//   lhs4 (M1, K1, M0, 128) x rhs4 (N1, K1, 128, 128) -> out4 (M1, N1, M0, 128) f32,
//   out4[m1, n1, m0, n0] = sum_{k1, k0} lhs4[m1, k1, m0, k0] * rhs4[n1, k1, n0, k0]
//
// What bounds it on the H100: bytes.  Up to 64 rows do at most 128 flops
// per weight byte, below the card's ~295 ridge, and at the decode windows
// (1-24 rows) far below it: the floor is the packed weight streamed once at
// 3.35 TB/s.  So the design is about keeping enough weight bytes in flight
// on every SM, and about touching each weight byte once.
//
// Design.
//   - Blocks and split-K.  A block owns a 32-column slice of one packed N
//     tile (BN = 32 rows of the weight), one group of up to 64 packed rows
//     (every row when M1 * M0 <= 64), and one K range: split s of S covers
//     packed K tiles [s*K1/S, (s+1)*K1/S).  The host picks S
//     (kernels/mmt4d.py: mmt4d_plan) as the least count that brings the
//     grid to a target number of blocks, at most one split per K tile, so
//     the k/v and down projections (16-64 N slices) still fill the card.
//   - Loads.  BN rows of a packed 128 x 128 tile are BN x 256 contiguous
//     bytes.  One producer warp streams them with TMA (two 64-wide K halves,
//     the 2-D map over rhs4 viewed as (N1*K1*128, 128) that the wide path
//     uses too) into a ring of 4 or 8 stages guarded by full/empty
//     mbarriers: 32-64 KB of weight in flight per block, 2-3 blocks an SM.  The same
//     stage carries the group's rows of that K tile in their own dtype,
//     through a rank-4 map over lhs4 whose box (64, M0, 1, G) lands G row
//     blocks as consecutive 128-byte rows (rows past M1 read zeros).  Both
//     are 128B-swizzled, so the fragment loads below are free of bank
//     conflicts.  A block reads its rows once per K tile, never per warp.
//   - Products.  Tensor cores with the weight as the A operand (16 weight
//     rows = 16 output columns) and the packed rows as the narrow B side:
//     mma.sync m16n8k16 (bf16 in, f32 accumulate), so rows are padded to
//     8, not 64.  Chosen over wgmma m64nNk16 because the row count is
//     known only at run time (N would need one instantiation per multiple
//     of 8, and wgmma's 64-row A side would need BN = 64 and so half the
//     N slices), and because this body is bound by bytes, not by the
//     tensor cores' issue rate: mma.sync's rate is not the limit here.
//     Fragments come from the swizzled stages by ldmatrix.
//   - Warps.  Four consumer warps take the block's K tiles round-robin
//     (warp w: tiles w, w+4, ...), each with its own accumulators; at the
//     end they are summed in warp order through shared memory.  The ring's
//     stage count is a multiple of four, so each stage has one reader.
//   - Merge.  With S > 1 every block writes its f32 partial (up to 64 rows
//     x BN) to scratch; an atomic counter per output tile (after
//     __threadfence()) finds the last block, which sums the S partials in
//     split order, writes out4 and resets the counter to 0, all in the one
//     launch.  Every sum has a fixed order, so a repeat call gives the
//     same bits.  The wrappers allocate the scratch and the counters; the
//     kernel allocates nothing.
//   - Output.  A row's BN columns lie in one packed N tile, contiguous in
//     out4: 16-byte stores.  Rows past M1 * M0 are never stored.
// Internal linkage throughout (see tma.cuh).
#pragma once

#include "tma.cuh"

namespace {

constexpr int SK_BN = 32;    // output columns (weight rows) a block owns
constexpr int SK_ROWS = 64;  // packed rows a block holds at most
constexpr int SK_CW = 4;     // consumer warps
constexpr int SK_THREADS = (SK_CW + 1) * 32;

// NT: the block's 8-row groups (1..8).  A stage is [weight K half 0][half
// 1][rows K half 0][half 1], each half 1024-byte aligned (the swizzle atom).
template <int NT>
struct SkinnyGeo {
  static constexpr int W_HALF = SK_BN * 128;  // BN rows of 64 bf16
  static constexpr int A_HALF = NT * 1024;    // 8 * NT rows of 64 bf16
  static constexpr int STAGE = 2 * (W_HALF + A_HALF);
  // 8 stages where they fit 96 KB (two blocks an SM), else 4: a multiple
  // of the consumer warps, so that warp w, which takes K tiles w, w+4, ...,
  // is the only reader of stages w, w+4, ... and waits on each of their
  // phases in order (an mbarrier parity wait is right only for a waiter
  // that has seen the previous phase).
  static constexpr int STAGES = 96 * 1024 / STAGE >= 8 ? 8 : 4;
  static_assert(96 * 1024 / STAGE >= 4 && STAGES % SK_CW == 0, "ring of whole warp rounds");
  static constexpr int LDR = SK_BN + 4;  // f32 row of the warps' sums, in floats
  static constexpr int RED = SK_CW * NT * 8 * LDR * 4;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = (RING > RED ? RING : RED) + 1024;
};

struct SkinnyArgs {
  float* out;       // out4 (M1, N1, M0, 128)
  float* part;      // [tiles][splits][SK_ROWS][SK_BN] f32 partials (splits > 1)
  int* cnt;         // [tiles] arrival counters, 0 between launches (splits > 1)
  int rows;         // M1 * M0
  int m0, n1, k1;
  int group_m1;     // G: row blocks a block holds
  int splits;
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
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared-memory address of 16-byte chunk `ch` (0..7) of 128-byte row `r` in
// a 128B-swizzled box at `base` (1024-aligned): the chunk index is XORed
// with the row's index within its 8-row atom.
__device__ __forceinline__ unsigned sw128(unsigned base, int r, int ch) {
  return base + r * 128 + ((ch ^ (r & 7)) << 4);
}

template <int NT>
__global__ void __launch_bounds__(SK_THREADS)
skinny_kernel(const __grid_constant__ CUtensorMap tm_lhs,
              const __grid_constant__ CUtensorMap tm_rhs, const SkinnyArgs a) {
  using G = SkinnyGeo<NT>;
  constexpr int STAGES = G::STAGES;
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
  const int group_rows = a.group_m1 * a.m0;
  const int b1_base = blockIdx.z * a.group_m1;
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
      const unsigned tx = 2 * 128 * (SK_BN + group_rows);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % STAGES;
        const int kt = kt_lo + i;
        unsigned char* st = smem + s * G::STAGE;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        mbar_arrive_tx(&full[s], tx);
        tma_load(st, &tm_rhs, &full[s], 0, row0 + kt * TMA_T0);
        tma_load(st + G::W_HALF, &tm_rhs, &full[s], TMA_BK, row0 + kt * TMA_T0);
        tma_load4(st + 2 * G::W_HALF, &tm_lhs, &full[s], 0, 0, kt, b1_base);
        tma_load4(st + 2 * G::W_HALF + G::A_HALF, &tm_lhs, &full[s], TMA_BK, 0, kt, b1_base);
      }
    }
    return;
  }

  // ---- consumers: warp w takes the block's K tiles w, w + 4, ...
  float acc[2][NT][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][q][e] = 0.f;
  const int ra = lane & 15;        // ldmatrix row of the weight (x4)
  const int ca = lane >> 4;        // and its chunk offset
  const int rb = lane & 7;         // ldmatrix row of the rows (x2)
  const int cb = (lane >> 3) & 1;  // and its chunk offset
  for (int i = warp; i < n_kt; i += SK_CW) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const unsigned st = smem_addr(smem + s * G::STAGE);
#pragma unroll
    for (int kk = 0; kk < TMA_T0 / 16; ++kk) {
      const int h = kk >> 2;         // K half
      const int c0 = (kk & 3) * 2;   // first 16-byte chunk of the k16 step
      const unsigned wb = st + h * G::W_HALF;
      const unsigned ab = st + 2 * G::W_HALF + h * G::A_HALF;
      unsigned fa[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) ldsm_x4(sw128(wb, j * 16 + ra, c0 + ca), fa[j]);
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        unsigned fb[2];
        ldsm_x2(sw128(ab, q * 8 + rb, c0 + cb), fb);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_bf16(acc[j][q], fa[j], fb);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- the warps' sums, in warp order, through the drained ring: every
  // consumer has waited on every stage it read, so no copy is in flight.
  asm volatile("bar.sync 1, %0;\n" ::"n"(SK_CW * 32) : "memory");
  float* red = reinterpret_cast<float*>(smem);  // [warp][8 * NT rows][LDR]
  {
    float* rw = red + warp * NT * 8 * G::LDR;
    const int g = lane >> 2;
    const int t2 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        // acc[j][q]: (weight row j*16 + g (+8), packed row q*8 + t2 (+1))
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
  const int vr = min(group_rows, a.rows - row_base);  // rows this block stores
  constexpr int C4 = SK_BN / 4;                       // float4s a row
  auto out_row = [&](int r) {
    const int gr = row_base + r;
    const int b1 = gr / a.m0;
    return a.out + ((static_cast<size_t>(b1) * a.n1 + nt) * a.m0 + (gr - b1 * a.m0)) * TMA_T0 +
           n_base % TMA_T0;
  };
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  float* part_of =
      a.splits > 1 ? a.part + static_cast<size_t>(tile) * a.splits * SK_ROWS * SK_BN : nullptr;
  for (int e = tid; e < vr * C4; e += SK_CW * 32) {
    const int r = e / C4;
    const int c = (e % C4) * 4;
    float4 v = *reinterpret_cast<const float4*>(red + r * G::LDR + c);
#pragma unroll
    for (int w = 1; w < SK_CW; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(red + (w * NT * 8 + r) * G::LDR + c);
      v.x += x.x; v.y += x.y; v.z += x.z; v.w += x.w;
    }
    float* dst = a.splits == 1 ? out_row(r) + c
                               : part_of + (static_cast<size_t>(split) * SK_ROWS + r) * SK_BN + c;
    *reinterpret_cast<float4*>(dst) = v;
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
    const float4* src = reinterpret_cast<const float4*>(part_of + r * SK_BN + c);
    float4 v = __ldcg(src);
    for (int sp = 1; sp < a.splits; ++sp) {
      const float4 x = __ldcg(src + sp * (SK_ROWS * SK_BN / 4));
      v.x += x.x; v.y += x.y; v.z += x.z; v.w += x.w;
    }
    *reinterpret_cast<float4*>(out_row(r) + c) = v;
  }
  if (tid == 0) a.cnt[tile] = 0;  // ready for the next launch
}

template <int NT>
cudaError_t launch_skinny_nt(const CUtensorMap& tm_lhs, const CUtensorMap& tm_rhs,
                             const SkinnyArgs& a, dim3 grid, cudaStream_t s) {
  auto kern = skinny_kernel<NT>;
  static unsigned long long opted = 0;  // devices whose shared-memory limit is raised
  const cudaError_t e = opt_in_smem(kern, SkinnyGeo<NT>::SMEM, opted);
  if (e != cudaSuccess) return e;
  kern<<<grid, SK_THREADS, SkinnyGeo<NT>::SMEM, s>>>(tm_lhs, tm_rhs, a);
  return cudaGetLastError();
}

// bf16 lhs4 (M1, K1, M0, 128) x rhs4 -> out4, K in `splits` ranges.  With
// splits > 1, `part` holds tiles * splits * SK_ROWS * SK_BN floats and
// `cnt` tiles zeroed ints, tiles = (N1*128 / SK_BN) * ceil(M1 / G),
// G = min(M1, SK_ROWS / M0) (kernels/mmt4d.py mirrors this).
cudaError_t launch_skinny(const void* lhs4, const void* rhs4, float* out4, int m1, int m0, int n1,
                          int k1, int splits, float* part, int* cnt, cudaStream_t s) {
  if (m1 < 1 || m0 < 1 || m0 > SK_ROWS || n1 < 1 || k1 < 1 || splits < 1 || splits > k1 ||
      (splits > 1 && (part == nullptr || cnt == nullptr)))
    return cudaErrorInvalidValue;
  const int g = std::min(m1, SK_ROWS / m0);
  const int nt8 = (g * m0 + 7) / 8;
  CUtensorMap tm_lhs, tm_rhs;
  cudaError_t e = encode_packed_rows(&tm_lhs, lhs4, m1, m0, k1, m0, g);
  if (e == cudaSuccess) e = weight_map(&tm_rhs, rhs4, n1, k1, SK_BN);
  if (e != cudaSuccess) return e;
  const SkinnyArgs a{out4, part, cnt, m1 * m0, m0, n1, k1, g, splits};
  const dim3 grid(n1 * TMA_T0 / SK_BN, splits, (m1 + g - 1) / g);
  switch (nt8) {
#define CASE(NT) \
  case NT: return launch_skinny_nt<NT>(tm_lhs, tm_rhs, a, grid, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
