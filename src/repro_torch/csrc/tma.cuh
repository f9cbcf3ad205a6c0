// TMA copies, mbarriers and tensor maps: the pieces the TMA-fed GEMM
// bodies share (gemm_wgmma.cuh, packed_skinny.cuh).
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
constexpr int TMA_BK = 64;   // a box's K width: 128 bytes of bf16, one 128B-swizzle row

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

// A bf16 map of `rank` dims (sizes innermost first, byte strides of dims
// 1.. rank-1), box `box` (box[0] = 64: 128 bytes), 128B-swizzled; boxes
// reaching past an edge read zeros there.
cudaError_t encode_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                        const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 2-D bf16 map over `rows` rows of `cols` contiguous elements, box (64
// columns, box_rows rows).
cudaError_t encode_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                       uint32_t box_rows) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {TMA_BK, box_rows};
  return encode_bf16(map, base, 2, dims, strides, box);
}

// A rank-4 map over packed rows lhs4 (M1, K1, M0, 128), box (64, box_m0, 1,
// box_m1): a box lands box_m1 * box_m0 packed rows r = m1 * M0 + m0 (m0
// inner) of one 64-wide K slab as consecutive 128-byte rows, the layout of
// the 2-D map's (64, rows) box.  Row blocks past M1 read zeros.
cudaError_t encode_packed_rows(CUtensorMap* map, const void* lhs4, int m1, int m0, int k1,
                               uint32_t box_m0, uint32_t box_m1) {
  const cuuint64_t dims[4] = {TMA_T0, static_cast<cuuint64_t>(m0), static_cast<cuuint64_t>(k1),
                              static_cast<cuuint64_t>(m1)};
  const cuuint64_t row = TMA_T0 * 2;
  const cuuint64_t strides[3] = {row, row * m0, row * m0 * k1};
  const cuuint32_t box[4] = {TMA_BK, box_m0, 1, box_m1};
  return encode_bf16(map, lhs4, 4, dims, strides, box);
}

// The packed weight's map: rhs4 (N1, K1, 128, 128) viewed as (N1*K1*128,
// 128), box (64, bn): packed tile (nt, kt) starts at row (nt*K1 + kt)*128.
// Encoded once per (pointer, shape, bn): a map holds only these, so a
// cached one is right whatever tensor lives there now.
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
  const cudaError_t e = encode_map(map, rhs4, static_cast<uint64_t>(n1) * k1 * TMA_T0, TMA_T0,
                                   static_cast<uint32_t>(bn));
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
