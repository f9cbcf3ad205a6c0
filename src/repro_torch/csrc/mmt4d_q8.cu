// w8a8 packed-layout GEMM: int8 mmt4d with an int32 sum and the factorized
// scale epilogue, packed result.
//
// Replaces src/repro/kernels/mmt4d_q8.py: mmt4d_q8_pallas (TPU).
//   lhs4 (M1, K1, M0, K0) int8 x rhs4 (N1, K1, N0, K0) int8 -> out4 (M1, N1, M0, N0) f32,
//   out4[m1, n1, m0, n0] = (float(sum_{k1, k0} lhs4[m1, k1, m0, k0] * rhs4[n1, k1, n0, k0])
//                           * s_a[m1, m0]) * s_w[n1, n0],
//   N0 = K0 = 128 (the stored weight tile); any M0 (1..8 at decode, 128 at prefill).
//
// What bounds it on the H100: bytes at decode (16-256 rows of a verify,
// mixed or many-slot dispatch do 2*M operations per weight byte, below the
// int8 ridge of ~590 operations per byte), operations at prefill (2048 rows
// at M0 = 128).
//
// Design: the tiling of the bf16 packed GEMM (csrc/mmt4d.cu).  Each block
// owns a 64-row x 64-column output tile and loops over all of K itself (the
// TPU carries a VMEM accumulator across sequential K grid steps; blocks on
// the card run in any order).  Packed rows r = m1 * M0 + m0 are flattened,
// so any M0 fills the same 64-row tile; rows past M1 * M0 load zeros and are
// never stored.  A K step stages one whole K0 = 128 tile: row r's 128 int8
// K elements are one contiguous 128-byte line in both operands.  Shared
// memory holds each operand as eight 16-element K slabs ([slab][row][16]),
// so every WMMA fragment pointer is 32-byte aligned.  4 warps each own a
// 32 x 32 quarter of the tile as 2 x 2 WMMA int8 16x16x16 fragments with
// int32 accumulators (tensor cores).  The int32 sum is exact, and the
// epilogue applies the JAX order (float(acc) * s_a) * s_w, so the result
// equals the plain version bit for bit.  Staging is synchronous; cp.async
// or TMA pipelining, wgmma and split-K for few-row tiles are later work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int T0 = 128;         // N0 = K0
constexpr int BR = 64;          // packed rows per block
constexpr int BN = 64;          // output columns per block (half a packed N tile)
constexpr int KS = 16;          // K elements of one WMMA step / one shared slab
constexpr int SLABS = T0 / KS;  // slabs per K0 tile
constexpr int LDC = BN + 4;

__global__ void __launch_bounds__(128)
mmt4d_q8_kernel(const int8_t* __restrict__ lhs4, const int8_t* __restrict__ rhs4,
                const float* __restrict__ s_a, const float* __restrict__ s_w,
                float* __restrict__ out4, int rows, int m0, int n1, int k1) {
  __shared__ __align__(128) int8_t As[SLABS][BR][KS];
  __shared__ __align__(128) int8_t Bs[SLABS][BN][KS];
  __shared__ __align__(32) int Cs[BR][LDC];
  const int n_base = blockIdx.x * BN;
  const int nt = n_base / T0;
  const int nb0 = n_base % T0;
  const int r_base = blockIdx.y * BR;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;  // 2 x 2 warps of 32 x 32
  const int wn = warp & 1;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int kt = 0; kt < k1; ++kt) {
    const int8_t* tile = rhs4 + ((size_t)nt * k1 + kt) * T0 * T0;
    // 64 rows x 8 slabs of 16 bytes per operand: 8 consecutive threads read
    // one row's 128-byte line.
    for (int i = threadIdx.x; i < BR * SLABS; i += blockDim.x) {
      const int r = i / SLABS;
      const int c = i % SLABS;
      const int gr = r_base + r;
      int4 v = make_int4(0, 0, 0, 0);
      if (gr < rows) {
        const int a1 = gr / m0;
        const int a0 = gr - a1 * m0;
        v = *reinterpret_cast<const int4*>(lhs4 + (((size_t)a1 * k1 + kt) * m0 + a0) * T0 + c * KS);
      }
      *reinterpret_cast<int4*>(&As[c][r][0]) = v;
      *reinterpret_cast<int4*>(&Bs[c][r][0]) =
          *reinterpret_cast<const int4*>(tile + (size_t)(nb0 + r) * T0 + c * KS);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < SLABS; ++c) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[c][wm * 32 + i * 16][0], KS);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[c][wn * 32 + j * 16][0], KS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16], acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BR * BN; i += blockDim.x) {
    const int r = i / BN;
    const int c = i % BN;
    const int gr = r_base + r;
    if (gr < rows) {
      const int a1 = gr / m0;
      const int a0 = gr - a1 * m0;
      const int n = n_base + c;
      out4[(((size_t)a1 * n1 + nt) * m0 + a0) * T0 + nb0 + c] =
          (static_cast<float>(Cs[r][c]) * s_a[gr]) * s_w[n];
    }
  }
}

}  // namespace

extern "C" int mmt4d_q8(const void* lhs4, const void* rhs4, const void* s_a, const void* s_w,
                        void* out4, int m1, int m0, int n1, int k1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m1 < 1 || m0 < 1 || n1 < 1 || k1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = m1 * m0;
  const dim3 grid(n1 * (T0 / BN), (rows + BR - 1) / BR);
  mmt4d_q8_kernel<<<grid, 128, 0, s>>>(
      static_cast<const int8_t*>(lhs4), static_cast<const int8_t*>(rhs4),
      static_cast<const float*>(s_a), static_cast<const float*>(s_w), static_cast<float*>(out4),
      rows, m0, n1, k1);
  return static_cast<int>(cudaGetLastError());
}
