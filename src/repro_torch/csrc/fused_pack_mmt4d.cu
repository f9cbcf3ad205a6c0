// Prefill projection: plain activation rows times the packed weight, GEMM-shaped.
//
// Replaces src/repro/kernels/fused_pack_mmt4d.py: fused_pack_mmt4d_pallas (TPU).
//   out (M, N1*128) f32 = lhs (M, K1*128) x W^T,  W[n, k] = rhs4[n/128][k/128][n%128][k%128]
//
// What bounds it on the H100: operations.  A prefill of B x 512 rows does
// ~M flops per weight element, above the card's ~295 flop/byte ridge, so
// the floor is 2*M*N*K / 989 TFLOP/s (bf16 tensor cores): 0.0695 ms at
// M = 2048, K = 2048, N = 8192.
//
// Design.  The TPU kernel carries an f32 accumulator across sequential K
// grid steps; on the card blocks run in parallel and in no order, so each
// block owns one output tile and loops over all of K itself, in a fixed
// order (a repeat call gives the same bits; no split of K).  The lhs pack
// and the output unpack stay inside the kernel: the block reads the plain
// 2-D rows and writes the plain 2-D output.
//   bf16: a warp-specialised wgmma pipeline.  Both operands are K-major
//     already (lhs rows are contiguous in K; a packed 128 x 128 weight tile
//     is [n][k] with k contiguous), the layout wgmma takes untransposed.
//     - Loads: TMA copies 64-wide K slabs of lhs (a 2-D map over (M, K),
//       box (64, BM)) and of the weight (a 2-D map over rhs4 viewed as
//       (N1*K1*128, 128), box (64, BN): the slab of packed tile (nt, kt) at
//       row (nt*K1 + kt)*128 + n_off, column 0 or 64), 128B-swizzled, into
//       a ring of 3-6 shared-memory stages (two blocks fit on an SM) with a
//       full and an empty mbarrier each.  One producer warp issues them; TMA zero-fills the
//       rows past M, so the ragged edge needs no masked loads.
//     - Products: each consumer warpgroup owns 64 rows of the BM x BN tile
//       and issues wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulate in
//       registers) on the swizzled stages, four per stage; it commits a
//       stage's group, retires the previous one (wait_group 1) and only then
//       releases that stage to the producer, so the tensor cores always
//       have the next stage's products queued while copies land.
//     - Tile: (BM, BN) of 128 x 128, 128 x 64 or 64 x 64 from the host's
//       plan (kernels/fused_pack_mmt4d.py: gemm_tile_plan): the largest tile
//       whose grid still fills the 132 SMs, so the k/v projections (N = 512)
//       and one-request prefills get smaller tiles, not 16-64 blocks.
//     - Epilogue: the f32 tile goes through shared memory (the drained
//       stages) and leaves as coalesced 16-byte row stores; rows >= M are
//       never stored.
//     Against the kernel it replaces (WMMA 16x16x16 on 128 x 128 tiles,
//     synchronous loads behind two barriers a 32-wide K step): the loads
//     overlap the products, wgmma reaches the full bf16 rate mma.sync
//     cannot, and the tile follows M and N.  The weight's tensor map is
//     encoded once per (pointer, shape, BN) and cached; lhs's per call.
//     cuTensorMapEncodeTiled comes from the runtime's driver entry point,
//     so the library links nothing beyond the runtime.
//   f32 : 64 x 64 x 16 block tiles, 256 threads with a 4 x 4 register tile
//         each, plain FMA (exact f32 products, no TF32: the f32 token
//         identity of the serving checks needs them).
#include <cuda.h>

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace {

constexpr int T0 = 128;  // pack tile (N0 = K0)

// ---- bf16: TMA + wgmma ------------------------------------------------------
constexpr int BK = 64;  // K a stage: 128 bytes of bf16, one 128B-swizzle row

template <int BM, int BN>
struct GemmGeo {
  static constexpr int CWG = BM / 64;             // consumer warpgroups
  static constexpr int THREADS = CWG * 128 + 32;  // and one producer warp
  static constexpr int A_BYTES = BM * BK * 2;     // one stage of lhs
  static constexpr int B_BYTES = BN * BK * 2;     // one stage of the weight
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive and expect `bytes` of TMA transactions on the barrier's phase.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.  A wait of more
// than 2^34 cycles (~9 s) can only be a lost copy: trap, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  const long long t0 = clock64();
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// TMA: the box of `map` at (c0 innermost, c1) into shared memory, completing
// its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

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

template <int BM, int BN>
__global__ void __launch_bounds__(GemmGeo<BM, BN>::THREADS)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap tm_lhs,
                 const __grid_constant__ CUtensorMap tm_rhs, float* __restrict__ out, int M,
                 int n1, int k1) {
  using G = GemmGeo<BM, BN>;
  extern __shared__ unsigned char smem_raw[];
  constexpr int STAGES = G::STAGES;
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sa = smem;                        // [STAGES][BM][64] bf16, swizzled
  unsigned char* sb = smem + STAGES * G::A_BYTES;  // [STAGES][BN][64] bf16, swizzled
  const int N = n1 * T0;
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
      const int row0 = (n_base / T0) * k1 * T0 + n_base % T0;  // packed tile (nt, 0), n_off
      for (int it = 0; it < n_k; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_arrive_tx(&full[s], G::STAGE_BYTES);
        tma_load(sa + s * G::A_BYTES, &tm_lhs, &full[s], it * BK, m_base);
        tma_load(sb + s * G::B_BYTES, &tm_rhs, &full[s], (it & 1) * BK, row0 + (it >> 1) * T0);
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
    const uint64_t da = sw128_desc(sa + s * G::A_BYTES + wg * 64 * BK * 2);
    const uint64_t db = sw128_desc(sb + s * G::B_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk);
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
    if (gm < M) {
      *reinterpret_cast<float4*>(out + static_cast<size_t>(gm) * N + n_base + c) =
          *reinterpret_cast<const float4*>(cs + r * G::LDC + c);
    }
  }
}

// ---- f32: CUDA cores ---------------------------------------------------------
constexpr int FB = 64, FBK = 16;

__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs4,
                float* __restrict__ out, int M, int n1, int k1) {
  __shared__ float As[FBK][FB + 4];
  __shared__ float Bs[FBK][FB + 4];
  const int K = k1 * T0;
  const int N = n1 * T0;
  const int n_base = blockIdx.x * FB;  // FB divides T0: one packed tile
  const int nt = n_base / T0;
  const int nb0 = n_base % T0;
  const int m_base = blockIdx.y * FB;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < K; kb += FBK) {
    const int kt = kb / T0;
    const int k0 = kb % T0;
    const float* tile = rhs4 + ((size_t)nt * k1 + kt) * T0 * T0;
    for (int i = threadIdx.x; i < FB * FBK; i += blockDim.x) {
      const int r = i / FBK;
      const int c = i % FBK;
      const int gm = m_base + r;
      As[c][r] = gm < M ? lhs[(size_t)gm * K + kb + c] : 0.f;
      Bs[c][r] = tile[(size_t)(nb0 + r) * T0 + k0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m_base + ty * 4 + i;
    if (gm < M) {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[(size_t)gm * N + n_base + tx * 4 + j] = acc[i][j];
    }
  }
}

// ---- host: tensor maps ------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 2-D bf16 map over `rows` rows of `cols` contiguous elements, box (64
// columns, box_rows rows), 128B-swizzled, rows past the end read as zeros.
cudaError_t encode_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                       uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {BK, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The weight's map, encoded once per (pointer, shape, BN): a map holds only
// these, so a cached one is right whatever tensor lives there now.
cudaError_t weight_map(CUtensorMap* map, const void* rhs4, int n1, int k1, int bn) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(rhs4, n1, k1, bn);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  const cudaError_t e =
      encode_map(map, rhs4, static_cast<uint64_t>(n1) * k1 * T0, T0, static_cast<uint32_t>(bn));
  if (e != cudaSuccess) return e;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

template <int BM, int BN>
cudaError_t launch_bf16(const void* lhs, const void* rhs4, float* out, int m, int n1, int k1,
                        cudaStream_t s) {
  using G = GemmGeo<BM, BN>;
  CUtensorMap tm_lhs, tm_rhs;
  cudaError_t e = encode_map(&tm_lhs, lhs, m, static_cast<uint64_t>(k1) * T0, BM);
  if (e == cudaSuccess) e = weight_map(&tm_rhs, rhs4, n1, k1, BN);
  if (e != cudaSuccess) return e;
  auto kern = gemm_bf16_kernel<BM, BN>;
  static unsigned long long opted = 0;  // devices whose shared-memory limit is raised
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !(opted >> dev & 1ull)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 64) opted |= 1ull << dev;
  }
  const dim3 grid(n1 * T0 / BN, (m + BM - 1) / BM);
  kern<<<grid, G::THREADS, G::SMEM, s>>>(tm_lhs, tm_rhs, out, m, n1, k1);
  return cudaGetLastError();
}

}  // namespace

// bm, bn: the bf16 kernel's block tile (128 x 128, 128 x 64 or 64 x 64),
// from the host's plan; the f32 kernel's tile is fixed.
extern "C" int fused_pack_mmt4d(const void* lhs, const void* rhs4, void* out, int m, int n1,
                                int k1, int bm, int bn, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n1 < 1 || k1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  if (dtype == DTYPE_BF16) {
    cudaError_t e = cudaErrorInvalidValue;
    if (bm == 128 && bn == 128) e = launch_bf16<128, 128>(lhs, rhs4, o, m, n1, k1, s);
    if (bm == 128 && bn == 64) e = launch_bf16<128, 64>(lhs, rhs4, o, m, n1, k1, s);
    if (bm == 64 && bn == 64) e = launch_bf16<64, 64>(lhs, rhs4, o, m, n1, k1, s);
    return static_cast<int>(e);
  }
  if (dtype == DTYPE_F32) {
    const dim3 grid(n1 * (T0 / FB), (m + FB - 1) / FB);
    gemm_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(lhs),
                                         static_cast<const float*>(rhs4), o, m, n1, k1);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
