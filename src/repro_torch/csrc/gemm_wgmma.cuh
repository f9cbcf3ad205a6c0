// The TMA + wgmma GEMM pipeline shared by the prefill GEMM
// (fused_pack_mmt4d.cu, kernel 3) and the packed GEMMs' wide windows
// (mmt4d.cu, kernel 4, bf16; mmt4d_q8.cu, kernel 6, int8), templated on the
// operand type, the block tile and a policy P that says where lhs comes
// from and where the output goes.
//
//   out (rows, N1*128) f32 = lhs (rows, K1*128) x W^T,
//   W[n, k] = rhs4[n/128][k/128][n%128][k%128]  (the packed weight)
//
// Design (kernel 3's measurements: PERF.md, section 6):
//   - A warp-specialised block: one producer warp, BM/64 consumer
//     warpgroups.  Both operands are K-major (lhs rows are contiguous in K;
//     a packed 128 x 128 weight tile is [n][k] with k contiguous), the
//     layout wgmma takes untransposed (int8 wgmma takes no other).
//   - Loads: TMA copies 128-byte K slabs (64 bf16 or 128 int8 elements) of
//     lhs (the policy's map, a (BM, 128-byte) slab of rows) and of the
//     weight (a 2-D map over rhs4 viewed as (N1*K1*128, 128), box (slab,
//     BN): the slab of packed tile (nt, kt) at row (nt*K1 + kt)*128 +
//     n_off), 128B-swizzled, into a ring of 3-6 shared-memory stages (two
//     blocks fit on an SM) with a full and an empty mbarrier each.  A
//     stage is the same bytes in either type: half a packed K tile in
//     bf16, a whole one in int8.  TMA zero-fills rows past the edge.
//   - Products: each consumer warpgroup owns 64 rows of the BM x BN tile and
//     issues wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulate) or
//     m64nBNk32 (s8 in, s32 accumulate) in registers, four per stage: both
//     consume 32 bytes of K a row, so the descriptors advance alike.  It
//     commits a stage's group, retires the previous one (wait_group 1) and
//     only then releases that stage.
//   - Each block walks all of K in a fixed order: a repeat call gives the
//     same bits (int8: the integer sum is exact in any order).
//   - Epilogue: the tile goes through shared memory (the drained stages) as
//     f32 (int8: float(acc), one rounding) and leaves as 16-byte stores
//     along each row's BN columns, which the policy places (P::row); rows
//     >= P::rows are never stored.  int8 applies the scale epilogue on the
//     way out: (float(acc) * s_a[row]) * s_w[col], the JAX order.
//
// Policies: PlainRows (kernel 3, and the plain-row entries of kernels 4
// and 6) reads lhs (M, K) through a 2-D map, box (slab, BM), and stores
// plain (M, N) rows; rows >= M are read as zeros and never stored, and
// int8 reads s_a only for them.  PackedRows (kernels 4, 6)
// reads lhs4 (M1, K1, M0, 128) through a rank-4 map whose box (slab,
// min(M0, BM), 1, max(1, BM/M0)) lands the same swizzled (BM, slab) tile
// of flattened rows r = m1*M0 + m0 (M0 divides BM, or BM divides M0), and
// stores into the packed (M1, N1, M0, 128) output: a row's BN columns lie
// in one packed N tile, contiguous.  Internal linkage throughout (see
// tma.cuh).
#pragma once

#include "tma.cuh"

namespace {

template <int BM, int BN>
struct GemmGeo {
  static constexpr int CWG = BM / 64;             // consumer warpgroups
  static constexpr int THREADS = CWG * 128 + 32;  // and one producer warp
  static constexpr int A_BYTES = BM * 128;        // one stage of lhs: BM 128-byte box rows
  static constexpr int B_BYTES = BN * 128;        // one stage of the weight
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // As many stages as leave room for two blocks on an SM (one block's
  // epilogue then overlaps the other's products): 3 at 128 x 128, 4 at
  // 128 x 64, 6 at 64 x 64.
  static constexpr int STAGES = 110 * 1024 / STAGE_BYTES < 6 ? 110 * 1024 / STAGE_BYTES : 6;
  static constexpr int LDC = BN + 8;              // f32 epilogue row, in floats
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int EPI = BM * LDC * 4;
  // + 1024: the base is aligned up to 1024 bytes (the swizzle atom) in the kernel.
  static constexpr int SMEM = (RING > EPI ? RING : EPI) + 1024;
};

// wgmma shared-memory descriptor of a K-major, 128B-swizzled operand whose
// rows are 128 bytes: 8-row groups 1024 bytes apart (SBO), LBO unused (1).
// Advancing K by one 32-byte step (16 bf16 or 32 int8 elements) adds 2 to
// the address field.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (static_cast<uint64_t>(smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// acc (64 x 64 f32, the warpgroup's fragment layout) += A (64 x 16) B^T (64 x 16),
// both bf16 K-major in 128B-swizzled shared memory.
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// acc (64 x 128 f32, the warpgroup's fragment layout) += A (64 x 16) B^T (128 x 16),
// both bf16 K-major in 128B-swizzled shared memory.
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 128) {
    wgmma_n128(d, da, db);
  } else {
    wgmma_n64(d, da, db);
  }
}

// Keep the compiler from moving reads of an accumulator above the last
// wait_group.
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void pin(int& x) { asm volatile("" : "+r"(x)::"memory"); }

#define WG_OUT8(i)                                                                       \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

// acc (64 x 64 s32, the same fragment layout as f32) += A (64 x 32) B^T
// (64 x 32), both s8 K-major in 128B-swizzled shared memory.
__device__ __forceinline__ void wgmma_n64(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24)
      : "l"(da), "l"(db), "r"(1));
}

// acc (64 x 128 s32) += A (64 x 32) B^T (128 x 32), s8 K-major.
__device__ __forceinline__ void wgmma_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24), WG_OUT8(32), WG_OUT8(40),
        WG_OUT8(48), WG_OUT8(56)
      : "l"(da), "l"(db), "r"(1));
}
#undef WG_OUT8

template <int BN>
__device__ __forceinline__ void wgmma_tile(int* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 128) {
    wgmma_n128(d, da, db);
  } else {
    wgmma_n64(d, da, db);
  }
}


// ---- policies ----------------------------------------------------------------

struct PlainRows {
  float* out;
  int rows;  // M
  int n;     // N = N1 * 128
  // The (box_k, BM) box of K elements k0 .. of the block whose first row
  // is m_base.
  __device__ __forceinline__ void load_lhs(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           int k0, int kt, int m_base) const {
    tma_load(dst, map, bar, kt * TMA_T0 + k0, m_base);
  }
  __device__ __forceinline__ float* row(int gm, int n_base) const {
    return out + static_cast<size_t>(gm) * n + n_base;
  }
};

struct PackedRows {
  float* out;
  int rows;  // M1 * M0
  int m0;
  int n1;
  // K elements k0 .. of packed tile kt, for the block whose first row is
  // m_base (a multiple of BM): rows from row block m_base / M0, at m0 =
  // m_base % M0 (nonzero only when BM < M0).
  __device__ __forceinline__ void load_lhs(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           int k0, int kt, int m_base) const {
    const int b1 = m_base / m0;
    tma_load4(dst, map, bar, k0, m_base - b1 * m0, kt, b1);
  }
  __device__ __forceinline__ float* row(int gm, int n_base) const {
    const int b1 = gm / m0;
    return out + ((static_cast<size_t>(b1) * n1 + n_base / TMA_T0) * m0 + (gm - b1 * m0)) * TMA_T0 +
           n_base % TMA_T0;
  }
};

template <typename T, int BM, int BN, class P>
__global__ void __launch_bounds__(GemmGeo<BM, BN>::THREADS)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_lhs,
                  const __grid_constant__ CUtensorMap tm_rhs, const P p, int n1, int k1,
                  const Scales sc) {
  using G = GemmGeo<BM, BN>;
  using Acc = typename TmaElem<T>::Acc;
  constexpr int BOXES = tile_boxes<T>;          // K steps a packed tile: 2 bf16, 1 int8
  constexpr int SHIFT = BOXES == 2 ? 1 : 0;
  static_assert(BOXES == 1 << SHIFT, "one or two boxes a tile");
  extern __shared__ unsigned char smem_raw[];
  constexpr int STAGES = G::STAGES;
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sa = smem;                        // [STAGES][BM][128 bytes], swizzled
  unsigned char* sb = smem + STAGES * G::A_BYTES;  // [STAGES][BN][128 bytes], swizzled
  const int n_base = blockIdx.x * BN;
  const int m_base = blockIdx.y * BM;
  const int n_k = BOXES * k1;  // 128-byte K steps
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);             // the producer's arrive (+ the copies' bytes)
      mbar_init(&empty[s], G::CWG * 4);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == G::CWG * 4) {
    // ---- producer: one lane keeps the ring full
    if (lane == 0) {
      // packed tile (nt, 0), the block's N offset within it
      const int row0 = (n_base / TMA_T0) * k1 * TMA_T0 + n_base % TMA_T0;
      for (int it = 0; it < n_k; ++it) {
        const int s = it % STAGES;
        const int k0 = (it & (BOXES - 1)) * box_k<T>;
        const int kt = it >> SHIFT;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_arrive_tx(&full[s], G::STAGE_BYTES);
        p.load_lhs(sa + s * G::A_BYTES, &tm_lhs, &full[s], k0, kt, m_base);
        tma_load(sb + s * G::B_BYTES, &tm_rhs, &full[s], k0, row0 + kt * TMA_T0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns tile rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2;
  Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int it = 0; it < n_k; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint64_t da = sw128_desc(sa + s * G::A_BYTES + wg * 64 * 128);
    const uint64_t db = sw128_desc(sb + s * G::B_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk);  // 32 bytes of K each
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) pin(acc[i]);

  // ---- epilogue: every consumer is past its last product, so the stages
  // are free; each warpgroup stages its 64 rows and stores them row-wise.
  asm volatile("bar.sync 1, %0;\n" ::"n"(G::CWG * 128) : "memory");
  float* cs = reinterpret_cast<float*>(smem) + wg * 64 * G::LDC;
  const int wr = (warp & 3) * 16 + (lane >> 2);  // fragment row (and + 8)
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + 2 * (lane & 3);
    *reinterpret_cast<float2*>(cs + wr * G::LDC + c) =
        make_float2(static_cast<float>(acc[4 * j]), static_cast<float>(acc[4 * j + 1]));
    *reinterpret_cast<float2*>(cs + (wr + 8) * G::LDC + c) =
        make_float2(static_cast<float>(acc[4 * j + 2]), static_cast<float>(acc[4 * j + 3]));
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  constexpr int C4 = BN / 4;  // float4s a row
  const int t = threadIdx.x & 127;
  for (int e = t; e < 64 * C4; e += 128) {
    const int r = e / C4;
    const int c = (e % C4) * 4;
    const int gm = m_base + wg * 64 + r;
    if (gm < p.rows) {
      float4 v = *reinterpret_cast<const float4*>(cs + r * G::LDC + c);
      if constexpr (sizeof(T) == 1) v = scale4(v, sc.s_a[gm], sc.s_w + n_base + c);
      *reinterpret_cast<float4*>(p.row(gm, n_base) + c) = v;
    }
  }
}

// Launch the (BM, BN) kernel over `rows` rows: the weight's map comes from
// the cache, lhs's map from the caller.
template <typename T, int BM, int BN, class P>
cudaError_t launch_wgmma(const CUtensorMap& tm_lhs, const void* rhs4, const P& p, int n1, int k1,
                         const Scales& sc, cudaStream_t s) {
  using G = GemmGeo<BM, BN>;
  CUtensorMap tm_rhs;
  cudaError_t e = weight_map<T>(&tm_rhs, rhs4, n1, k1, BN);
  if (e != cudaSuccess) return e;
  auto kern = gemm_wgmma_kernel<T, BM, BN, P>;
  static unsigned long long opted = 0;  // devices whose shared-memory limit is raised
  e = opt_in_smem(kern, G::SMEM, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid(n1 * TMA_T0 / BN, (p.rows + BM - 1) / BM);
  kern<<<grid, G::THREADS, G::SMEM, s>>>(tm_lhs, tm_rhs, p, n1, k1, sc);
  return cudaGetLastError();
}

// The tile (bm, bn) of the host's plan: 128 x 128, 128 x 64 or 64 x 64.
template <typename T, class P>
cudaError_t launch_wgmma_tile(int bm, int bn, const CUtensorMap& tm_lhs, const void* rhs4,
                              const P& p, int n1, int k1, const Scales& sc, cudaStream_t s) {
  if (bm == 128 && bn == 128) return launch_wgmma<T, 128, 128>(tm_lhs, rhs4, p, n1, k1, sc, s);
  if (bm == 128 && bn == 64) return launch_wgmma<T, 128, 64>(tm_lhs, rhs4, p, n1, k1, sc, s);
  if (bm == 64 && bn == 64) return launch_wgmma<T, 64, 64>(tm_lhs, rhs4, p, n1, k1, sc, s);
  return cudaErrorInvalidValue;
}

}  // namespace
