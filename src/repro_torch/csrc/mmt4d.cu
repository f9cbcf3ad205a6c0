// Packed-layout GEMM: linalg.mmt4d on packed operands, packed result.
//
// Replaces src/repro/kernels/mmt4d.py: mmt4d_pallas (TPU).
//   lhs4 (M1, K1, M0, K0) x rhs4 (N1, K1, N0, K0) -> out4 (M1, N1, M0, N0) f32,
//   out4[m1, n1, m0, n0] = sum_{k1, k0} lhs4[m1, k1, m0, k0] * rhs4[n1, k1, n0, k0],
//   N0 = K0 = 128 (the stored weight tile); M0 in 1..8 at decode, 128 at prefill.
//
// What bounds it on the H100: bytes at decode (M = slots x window rows of a
// verify or mixed dispatch: 16-20 rows do ~2*M flops per weight element,
// far below the ~295 flop/byte ridge), operations at prefill (M0 = 128 and
// thousands of rows) and at the widest mixed windows.
//
// Design.  The TPU kernel walks a (BM1, BN1, BK1) grid of pack tiles and
// carries a VMEM accumulator across the sequential K steps.  On the card
// the host picks one of two bodies (kernels/mmt4d.py: mmt4d_plan):
//   bf16, few rows ("skinny": up to SKINNY_MAX_ROWS packed rows, and any
//     row count at an M0 of 3, 5, 6 or 7): packed_skinny.cuh.  Blocks of 32
//     output columns x all rows (64-row groups beyond that) x one K range,
//     the K split chosen so that the grid fills the card, weight slices
//     and rows streamed by TMA into a 4-8-stage ring, mma.sync m16n8k16
//     with the weight as the wide side so rows pad to 8, the splits merged
//     in split order by the last block of each tile, in the one launch.
//   bf16, wide windows ("wide": mixed windows of 65-1040 rows at M0 = 8,
//     prefill slabs at M0 = 128): the TMA + wgmma pipeline of
//     gemm_wgmma.cuh that the prefill GEMM runs (fused_pack_mmt4d.cu), with
//     the PackedRows policy: lhs4 through a rank-4 map whose box lands a
//     (BM, 64) slab of flattened rows r = m1*M0 + m0 (M0 divides BM or BM
//     divides M0), the output stored in the packed layout.  The tile (BM,
//     BN) is the prefill GEMM's plan at the same rows and N.
//   f32: 64 x 64 output tiles over flattened (m1, m0) rows, 256 threads with
//     a 4 x 4 register tile each, plain FMA (exact f32 products, no TF32:
//     the f32 token identity of the serving checks needs them).
// Two entries.  `mmt4d` takes and gives the packed layouts (the Pallas
// kernel's contract).  `mmt4d_rows`, the one the ops path's packed route
// calls, takes plain rows (M, K) and gives plain (M, N): the same plan at M1
// = ceil(M / M0), its lhs boxes read from a 2-D map over the rows (the
// skinny body's SkPlainRows, the wide body's PlainRows) and its epilogue
// storing row r at out + r*N, so the activation pack and output unpack
// cost no launch and no pass over memory.  Each row's sums run in the same
// order, so it equals unpack(mmt4d(pack(x)))[:M] bit for bit.
#include "gemm_wgmma.cuh"
#include "packed_skinny.cuh"

namespace {

constexpr int T0 = 128;  // N0 = K0
constexpr int BR = 64;   // f32: packed rows per block
constexpr int BN = 64;   // f32: output columns per block (half a packed N tile)

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

// ---- f32: CUDA cores ------------------------------------------------------------
constexpr int FBK = 16;

// PLAIN: lhs (rows, K1*T0) and out (rows, N1*T0) plain rows, the same sums
// in the same order as the packed layout's (the plain-row entry).
template <bool PLAIN>
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
        const size_t off = PLAIN ? (size_t)gr * k1 * T0 + kt * T0 + k0 + c
                                 : lhs_offset(gr, m0, k1, kt, k0 + c);
        As[c][r] = gr < rows ? lhs4[off] : 0.f;
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
      float* o = out4 + (PLAIN ? (size_t)gr * n1 * T0 + n_base + tx * 4
                               : out_offset(gr, m0, n1, n_base + tx * 4));
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = acc[i][j];
    }
  }
}

template <bool PLAIN>
int launch_f32(const void* lhs, const void* rhs4, float* out, int rows, int m0, int n1, int k1,
               cudaStream_t s) {
  const dim3 grid(n1 * (T0 / BN), (rows + BR - 1) / BR);
  mmt4d_f32_kernel<PLAIN><<<grid, 256, 0, s>>>(static_cast<const float*>(lhs),
                                               static_cast<const float*>(rhs4), out, rows, m0, n1,
                                               k1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wide = 0: the skinny body with `splits` K ranges (part, cnt: the
// wrapper's scratch when splits > 1); wide = 1: the wgmma pipeline with the
// (bm, bn) tile.  The f32 kernel ignores the plan.
extern "C" int mmt4d(const void* lhs4, const void* rhs4, void* out4, int m1, int m0, int n1,
                     int k1, int dtype, int wide, int bm, int bn, int splits, void* part,
                     void* cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m1 < 1 || m0 < 1 || n1 < 1 || k1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = m1 * m0;
  float* o = static_cast<float*>(out4);
  if (dtype == DTYPE_BF16 && !wide) {
    return static_cast<int>(launch_skinny<bf16>(lhs4, rhs4, o, m1, m0, n1, k1, splits, part,
                                                static_cast<int*>(cnt), Scales{}, s));
  }
  if (dtype == DTYPE_BF16) {
    // The rank-4 box must land whole row blocks or whole slabs of one.
    if (bm % m0 != 0 && m0 % bm != 0) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap tm_lhs;
    cudaError_t e = encode_packed_rows<bf16>(&tm_lhs, lhs4, m1, m0, k1, std::min(m0, bm),
                                             std::max(1, bm / m0));
    if (e != cudaSuccess) return static_cast<int>(e);
    const PackedRows p{o, rows, m0, n1};
    return static_cast<int>(launch_wgmma_tile<bf16>(bm, bn, tm_lhs, rhs4, p, n1, k1, Scales{}, s));
  }
  if (dtype == DTYPE_F32) return launch_f32<false>(lhs4, rhs4, o, rows, m0, n1, k1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plain-row entry: lhs (m, K1*128) -> out (m, N1*128) f32 under the plan
// of the packed entry at lhs4 (ceil(m / m0), K1, m0, 128), whose result,
// unpacked, it equals bit for bit: the activation pack is the TMA boxes'
// addressing (the same rows land at the same shared-memory rows, zeros
// past m), the output unpack the epilogue's (each row stored at out + row *
// N; rows past m never stored).
extern "C" int mmt4d_rows(const void* lhs, const void* rhs4, void* out, int m, int m0, int n1,
                          int k1, int dtype, int wide, int bm, int bn, int splits, void* part,
                          void* cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || m0 < 1 || n1 < 1 || k1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  if (dtype == DTYPE_BF16 && !wide) {
    return static_cast<int>(launch_skinny_rows<bf16>(lhs, rhs4, o, m, m0, n1, k1, splits, part,
                                                     static_cast<int*>(cnt), Scales{}, s));
  }
  if (dtype == DTYPE_BF16) {
    CUtensorMap tm_lhs;
    const cudaError_t e = plain_rows_map<bf16>(&tm_lhs, lhs, m, k1, bm);
    if (e != cudaSuccess) return static_cast<int>(e);
    const PlainRows p{o, m, n1 * T0};
    return static_cast<int>(launch_wgmma_tile<bf16>(bm, bn, tm_lhs, rhs4, p, n1, k1, Scales{}, s));
  }
  if (dtype == DTYPE_F32) return launch_f32<true>(lhs, rhs4, o, m, m0, n1, k1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
