// The bf16 TMA + wgmma GEMM pipeline shared by the prefill GEMM
// (fused_pack_mmt4d.cu, kernel 3) and the packed GEMM's wide windows
// (mmt4d.cu, kernel 4), templated on the block tile and on a policy P that
// says where lhs comes from and where the output goes.
//
//   out (rows, N1*128) f32 = lhs (rows, K1*128) x W^T,
//   W[n, k] = rhs4[n/128][k/128][n%128][k%128]  (the packed weight)
//
// Design (kernel 3's measurements: PERF.md, section 6):
//   - A warp-specialised block: one producer warp, BM/64 consumer
//     warpgroups.  Both operands are K-major (lhs rows are contiguous in K;
//     a packed 128 x 128 weight tile is [n][k] with k contiguous), the
//     layout wgmma takes untransposed.
//   - Loads: TMA copies 64-wide K slabs of lhs (the policy's map, a
//     (64, BM) slab of rows) and of the weight (a 2-D map over rhs4 viewed
//     as (N1*K1*128, 128), box (64, BN): the slab of packed tile (nt, kt) at
//     row (nt*K1 + kt)*128 + n_off, column 0 or 64), 128B-swizzled, into a
//     ring of 3-6 shared-memory stages (two blocks fit on an SM) with a full
//     and an empty mbarrier each.  TMA zero-fills rows past the edge.
//   - Products: each consumer warpgroup owns 64 rows of the BM x BN tile and
//     issues wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulate in
//     registers), four per stage; it commits a stage's group, retires the
//     previous one (wait_group 1) and only then releases that stage.
//   - Each block walks all of K in a fixed order: a repeat call gives the
//     same bits.
//   - Epilogue: the f32 tile goes through shared memory (the drained
//     stages) and leaves as 16-byte stores along each row's BN columns,
//     which the policy places (P::row); rows >= P::rows are never stored.
//
// Policies: PlainRows (kernel 3) reads lhs (M, K) through a 2-D map, box
// (64, BM), and stores plain (M, N) rows.  PackedRows (kernel 4) reads lhs4
// (M1, K1, M0, 128) through a rank-4 map whose box (64, min(M0, BM), 1,
// max(1, BM/M0)) lands the same swizzled (BM, 64) slab of flattened rows
// r = m1*M0 + m0 (M0 divides BM, or BM divides M0), and stores into the
// packed (M1, N1, M0, 128) output: a row's BN columns lie in one packed N
// tile, contiguous.  Internal linkage throughout (see tma.cuh).
#pragma once

#include "tma.cuh"

namespace {

template <int BM, int BN>
struct GemmGeo {
  static constexpr int CWG = BM / 64;             // consumer warpgroups
  static constexpr int THREADS = CWG * 128 + 32;  // and one producer warp
  static constexpr int A_BYTES = BM * TMA_BK * 2;  // one stage of lhs
  static constexpr int B_BYTES = BN * TMA_BK * 2;  // one stage of the weight
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
// Advancing K by 16 elements adds 32 bytes, i.e. 2, to the address field.
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


// ---- policies ----------------------------------------------------------------

struct PlainRows {
  float* out;
  int rows;  // M
  int n;     // N = N1 * 128
  __device__ __forceinline__ void load_lhs(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           int it, int m_base) const {
    tma_load(dst, map, bar, it * TMA_BK, m_base);
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
  // K step `it` of the block whose first row is m_base (a multiple of BM):
  // packed tile kt = it / 2, its K half it % 2; rows from row block
  // m_base / M0, at m0 = m_base % M0 (nonzero only when BM < M0).
  __device__ __forceinline__ void load_lhs(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           int it, int m_base) const {
    const int b1 = m_base / m0;
    tma_load4(dst, map, bar, (it & 1) * TMA_BK, m_base - b1 * m0, it >> 1, b1);
  }
  __device__ __forceinline__ float* row(int gm, int n_base) const {
    const int b1 = gm / m0;
    return out + ((static_cast<size_t>(b1) * n1 + n_base / TMA_T0) * m0 + (gm - b1 * m0)) * TMA_T0 +
           n_base % TMA_T0;
  }
};

template <int BM, int BN, class P>
__global__ void __launch_bounds__(GemmGeo<BM, BN>::THREADS)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap tm_lhs,
                 const __grid_constant__ CUtensorMap tm_rhs, const P p, int n1, int k1) {
  using G = GemmGeo<BM, BN>;
  extern __shared__ unsigned char smem_raw[];
  constexpr int STAGES = G::STAGES;
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sa = smem;                        // [STAGES][BM][64] bf16, swizzled
  unsigned char* sb = smem + STAGES * G::A_BYTES;  // [STAGES][BN][64] bf16, swizzled
  const int n_base = blockIdx.x * BN;
  const int m_base = blockIdx.y * BM;
  const int n_k = 2 * k1;  // 64-wide K steps
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
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_arrive_tx(&full[s], G::STAGE_BYTES);
        p.load_lhs(sa + s * G::A_BYTES, &tm_lhs, &full[s], it, m_base);
        tma_load(sb + s * G::B_BYTES, &tm_rhs, &full[s], (it & 1) * TMA_BK,
                 row0 + (it >> 1) * TMA_T0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns tile rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_k; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint64_t da = sw128_desc(sa + s * G::A_BYTES + wg * 64 * TMA_BK * 2);
    const uint64_t db = sw128_desc(sb + s * G::B_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TMA_BK / 16; ++kk) wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // ---- epilogue: every consumer is past its last product, so the stages
  // are free; each warpgroup stages its 64 rows and stores them row-wise.
  asm volatile("bar.sync 1, %0;\n" ::"n"(G::CWG * 128) : "memory");
  float* cs = reinterpret_cast<float*>(smem) + wg * 64 * G::LDC;
  const int wr = (warp & 3) * 16 + (lane >> 2);  // fragment row (and + 8)
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + 2 * (lane & 3);
    *reinterpret_cast<float2*>(cs + wr * G::LDC + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(cs + (wr + 8) * G::LDC + c) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  constexpr int C4 = BN / 4;  // float4s a row
  const int t = threadIdx.x & 127;
  for (int e = t; e < 64 * C4; e += 128) {
    const int r = e / C4;
    const int c = (e % C4) * 4;
    const int gm = m_base + wg * 64 + r;
    if (gm < p.rows) {
      *reinterpret_cast<float4*>(p.row(gm, n_base) + c) =
          *reinterpret_cast<const float4*>(cs + r * G::LDC + c);
    }
  }
}

// Launch the (BM, BN) kernel over `rows` rows: the weight's map comes from
// the cache, lhs's map from the caller.
template <int BM, int BN, class P>
cudaError_t launch_wgmma(const CUtensorMap& tm_lhs, const void* rhs4, const P& p, int n1, int k1,
                         cudaStream_t s) {
  using G = GemmGeo<BM, BN>;
  CUtensorMap tm_rhs;
  cudaError_t e = weight_map(&tm_rhs, rhs4, n1, k1, BN);
  if (e != cudaSuccess) return e;
  auto kern = gemm_bf16_kernel<BM, BN, P>;
  static unsigned long long opted = 0;  // devices whose shared-memory limit is raised
  e = opt_in_smem(kern, G::SMEM, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid(n1 * TMA_T0 / BN, (p.rows + BM - 1) / BM);
  kern<<<grid, G::THREADS, G::SMEM, s>>>(tm_lhs, tm_rhs, p, n1, k1);
  return cudaGetLastError();
}

}  // namespace
