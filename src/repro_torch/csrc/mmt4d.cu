// Packed-layout GEMM: linalg.mmt4d on packed operands, packed result.
//
// Replaces src/repro/kernels/mmt4d.py: mmt4d_pallas (TPU).
//   lhs4 (M1, K1, M0, K0) x rhs4 (N1, K1, N0, K0) -> out4 (M1, N1, M0, N0) f32,
//   out4[m1, n1, m0, n0] = sum_{k1, k0} lhs4[m1, k1, m0, k0] * rhs4[n1, k1, n0, k0],
//   N0 = K0 = 128 (the stored weight tile); any M0 (1..8 at decode, 128 at prefill).
//
// What bounds it on the H100: bytes at decode (M = slots x window rows of a
// verify or mixed dispatch: 16-20 rows do ~2*M flops per weight element,
// far below the ~295 flop/byte ridge), operations at prefill (M0 = 128 and
// thousands of rows).
//
// Design.  The TPU kernel walks a (BM1, BN1, BK1) grid of pack tiles and
// carries a VMEM accumulator across the sequential K steps.  On the card
// blocks run in parallel and in no order, so each block owns one output tile
// and loops over all of K itself.  The tile is 64 packed rows by 64 output
// columns: packed rows r = m1 * M0 + m0 are flattened, so a 64-row tile
// spans several M0 = 8 row blocks (or half of an M0 = 128 one) and M0 costs
// nothing; rows past M1 * M0 load zeros and are never stored.  A K step
// stages a (64, 32) lhs slab (row r's K segment is contiguous inside its
// (m1, k1) tile) and the matching (64, 32) slab of one packed N tile in
// shared memory.  The result is staged in shared memory and written back
// in the packed layout, 64 contiguous floats per row.  The 64 x 64 tile
// gives a decode projection of N columns N/64 blocks (32 to 128 on the
// model's widths), twice the 128-column tiles of the prefill GEMM.
//   bf16: 4 warps, each a 32 x 32 quarter of the tile as 2 x 2 WMMA
//         16x16x16 bf16 fragments with f32 accumulators (tensor cores).
//   f32 : 256 threads with a 4 x 4 register tile each, plain FMA (exact f32
//         products, no TF32).
// Staging is synchronous (load, barrier, compute); cp.async/TMA pipelining,
// wgmma and split-K for few-row decode tiles are later work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int T0 = 128;  // N0 = K0
constexpr int BR = 64;   // packed rows per block
constexpr int BN = 64;   // output columns per block (half a packed N tile)

// Element offset of packed row r, K element kt*T0 + k0 in lhs4 (M1, K1, M0, T0).
__device__ __forceinline__ size_t lhs_offset(int r, int m0, int k1, int kt, int k0) {
  const int a1 = r / m0;
  const int a0 = r - a1 * m0;
  return (((size_t)a1 * k1 + kt) * m0 + a0) * T0 + k0;
}

// Element offset of packed row r, output column n in out4 (M1, N1, M0, T0).
__device__ __forceinline__ size_t out_offset(int r, int m0, int n1, int n) {
  const int a1 = r / m0;
  const int a0 = r - a1 * m0;
  return (((size_t)a1 * n1 + n / T0) * m0 + a0) * T0 + (n % T0);
}

// ---- bf16: tensor cores -------------------------------------------------------
constexpr int BK = 32, LDS = BK + 8, LDC = BN + 4;

__global__ void __launch_bounds__(128)
mmt4d_bf16_kernel(const bf16* __restrict__ lhs4, const bf16* __restrict__ rhs4,
                  float* __restrict__ out4, int rows, int m0, int n1, int k1) {
  __shared__ __align__(32) bf16 As[BR][LDS];
  __shared__ __align__(32) bf16 Bs[BN][LDS];
  __shared__ __align__(32) float Cs[BR][LDC];
  const int n_base = blockIdx.x * BN;
  const int nt = n_base / T0;
  const int nb0 = n_base % T0;
  const int r_base = blockIdx.y * BR;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;  // 2 x 2 warps of 32 x 32
  const int wn = warp & 1;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int kt = 0; kt < k1; ++kt) {
    const bf16* tile = rhs4 + ((size_t)nt * k1 + kt) * T0 * T0;
    for (int k0 = 0; k0 < T0; k0 += BK) {
      for (int i = threadIdx.x; i < BR * (BK / 8); i += blockDim.x) {
        const int r = i / (BK / 8);
        const int c = (i % (BK / 8)) * 8;
        const int gr = r_base + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gr < rows)
          v = *reinterpret_cast<const uint4*>(lhs4 + lhs_offset(gr, m0, k1, kt, k0 + c));
        *reinterpret_cast<uint4*>(&As[r][c]) = v;
      }
      for (int i = threadIdx.x; i < BN * (BK / 8); i += blockDim.x) {
        const int r = i / (BK / 8);
        const int c = (i % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(&Bs[r][c]) =
            *reinterpret_cast<const uint4*>(tile + (size_t)(nb0 + r) * T0 + k0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], LDS);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[wn * 32 + j * 16][kk], LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
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
    if (gr < rows) out4[out_offset(gr, m0, n1, n_base + c)] = Cs[r][c];
  }
}

// ---- f32: CUDA cores ------------------------------------------------------------
constexpr int FBK = 16;

__global__ void __launch_bounds__(256)
mmt4d_f32_kernel(const float* __restrict__ lhs4, const float* __restrict__ rhs4,
                 float* __restrict__ out4, int rows, int m0, int n1, int k1) {
  __shared__ float As[FBK][BR + 4];
  __shared__ float Bs[FBK][BN + 4];
  const int n_base = blockIdx.x * BN;
  const int nt = n_base / T0;
  const int nb0 = n_base % T0;
  const int r_base = blockIdx.y * BR;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < k1; ++kt) {
    const float* tile = rhs4 + ((size_t)nt * k1 + kt) * T0 * T0;
    for (int k0 = 0; k0 < T0; k0 += FBK) {
      for (int i = threadIdx.x; i < BR * FBK; i += blockDim.x) {
        const int r = i / FBK;
        const int c = i % FBK;
        const int gr = r_base + r;
        As[c][r] = gr < rows ? lhs4[lhs_offset(gr, m0, k1, kt, k0 + c)] : 0.f;
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
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r_base + ty * 4 + i;
    if (gr < rows) {
      float* o = out4 + out_offset(gr, m0, n1, n_base + tx * 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int mmt4d(const void* lhs4, const void* rhs4, void* out4, int m1, int m0, int n1,
                     int k1, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m1 < 1 || m0 < 1 || n1 < 1 || k1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = m1 * m0;
  const dim3 grid(n1 * (T0 / BN), (rows + BR - 1) / BR);
  if (dtype == DTYPE_BF16) {
    mmt4d_bf16_kernel<<<grid, 128, 0, s>>>(static_cast<const bf16*>(lhs4),
                                           static_cast<const bf16*>(rhs4),
                                           static_cast<float*>(out4), rows, m0, n1, k1);
  } else if (dtype == DTYPE_F32) {
    mmt4d_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(lhs4),
                                          static_cast<const float*>(rhs4),
                                          static_cast<float*>(out4), rows, m0, n1, k1);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
