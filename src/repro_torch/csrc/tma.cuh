// TMA copies, mbarriers and tensor maps: the pieces the TMA-fed GEMM
// bodies share (gemm_wgmma.cuh, packed_skinny.cuh), for bf16 and int8
// operands.  Every box row is 128 bytes, one 128B-swizzle row: 64 bf16 or
// 128 int8 K elements, so a packed 128 x 128 tile is two boxes wide in
// bf16 and one in int8, and the bodies' fragment and descriptor addressing
// is the same byte for byte.
//
// Everything here has internal linkage (an unnamed namespace): each kernel
// library gets its own copy of the function-local statics (the driver entry
// point, the weight maps' cache), never one merged process-wide with
// another library's.
#pragma once

#include <cuda.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace {

constexpr int TMA_T0 = 128;  // the packed weight tile (N0 = K0)

// Per operand type: the tensor map's data type, a box row's K elements, the
// boxes across one packed K tile, and the products' accumulator type.
template <typename T>
struct TmaElem;
template <>
struct TmaElem<bf16> {
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  using Acc = float;
};
template <>
struct TmaElem<int8_t> {
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // raw bytes
  using Acc = int;
};
template <typename T>
constexpr int box_k = 128 / static_cast<int>(sizeof(T));
template <typename T>
constexpr int tile_boxes = TMA_T0 / box_k<T>;

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

// A flat run of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from global to shared memory by the bulk copy engine, completing its
// bytes on `bar`: no tensor map, for runs too narrow for a box row.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// TMA: the box of a 2-D `map` at (c0 innermost, c1) into shared memory,
// completing its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The same for a rank-4 map, coordinates innermost first.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                          int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The operands of the int8 scale epilogue of both GEMM bodies: s_a per
// flattened row, s_w per output column, f32 (null in bf16).
struct Scales {
  const float* s_a;
  const float* s_w;
};

// (float(acc) * s_a) * s_w for four consecutive columns from n: each
// product rounded in turn, as the plain version computes it.
__device__ __forceinline__ float4 scale4(float4 v, float s_a, const float* s_w) {
  return make_float4((v.x * s_a) * s_w[0], (v.y * s_a) * s_w[1], (v.z * s_a) * s_w[2],
                     (v.w * s_a) * s_w[3]);
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

// A map of `rank` dims of T (sizes innermost first, byte strides of dims
// 1.. rank-1), box `box` (box[0] = box_k<T>: 128 bytes), 128B-swizzled
// (or `swizzle`, whose span a box row must fill); boxes reaching past an
// edge read zeros there.
template <typename T>
cudaError_t encode_tiled_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                             const cuuint64_t* strides, const cuuint32_t* box,
                             CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, TmaElem<T>::MAP, rank, const_cast<void*>(base), dims, strides, box,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 2-D map over `rows` rows of `cols` contiguous elements, box (box_k<T>
// columns, box_rows rows).
template <typename T>
cudaError_t encode_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                       uint32_t box_rows) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(T)};
  const cuuint32_t box[2] = {box_k<T>, box_rows};
  return encode_tiled_map<T>(map, base, 2, dims, strides, box);
}

// A rank-4 map over packed rows lhs4 (M1, K1, M0, 128), box (box_k<T>,
// box_m0, 1, box_m1): a box lands box_m1 * box_m0 packed rows r = m1 * M0
// + m0 (m0 inner) of one 128-byte K slab as consecutive 128-byte rows, the
// layout of the 2-D map's (box_k<T>, rows) box.  Row blocks past M1 read
// zeros.
template <typename T>
cudaError_t encode_packed_rows(CUtensorMap* map, const void* lhs4, int m1, int m0, int k1,
                               uint32_t box_m0, uint32_t box_m1) {
  const cuuint64_t dims[4] = {TMA_T0, static_cast<cuuint64_t>(m0), static_cast<cuuint64_t>(k1),
                              static_cast<cuuint64_t>(m1)};
  const cuuint64_t row = TMA_T0 * sizeof(T);
  const cuuint64_t strides[3] = {row, row * m0, row * m0 * k1};
  const cuuint32_t box[4] = {box_k<T>, box_m0, 1, box_m1};
  return encode_tiled_map<T>(map, lhs4, 4, dims, strides, box);
}

// The packed weight's map: rhs4 (N1, K1, 128, 128) viewed as (N1*K1*128,
// 128), box (box_k<T>, bn): packed tile (nt, kt) starts at row (nt*K1 +
// kt)*128.  With row_bytes = 64 (T = int8: int4 nibbles, two a byte) the
// rows are 64 bytes, boxed whole and 64B-swizzled.  Encoded once per
// (pointer, shape, bn, row_bytes), in a cache of its own per T: a map holds
// only these, so a cached one is right whatever tensor of T lives there now.
template <typename T>
cudaError_t weight_map(CUtensorMap* map, const void* rhs4, int n1, int k1, int bn,
                       int row_bytes = 128) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(rhs4, n1, k1, bn, row_bytes);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  const uint64_t rows = static_cast<uint64_t>(n1) * k1 * TMA_T0;
  cudaError_t e;
  if (row_bytes == 128) {
    e = encode_map<T>(map, rhs4, rows, TMA_T0, static_cast<uint32_t>(bn));
  } else {
    const cuuint64_t dims[2] = {row_bytes / sizeof(T), rows};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(row_bytes / sizeof(T)),
                               static_cast<cuuint32_t>(bn)};
    e = encode_tiled_map<T>(map, rhs4, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (e != cudaSuccess) return e;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

// Raise `kern`'s dynamic shared-memory limit to `bytes` once per device.
// `opted` is the caller's function-local static (one per kernel).
template <typename K>
cudaError_t opt_in_smem(K kern, int bytes, unsigned long long& opted) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && (opted >> dev & 1ull)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 64) opted |= 1ull << dev;
  return e;
}

}  // namespace
