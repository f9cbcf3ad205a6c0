// Prefill projection: plain activation rows times the packed weight, GEMM-shaped.
//
// Replaces src/repro/kernels/fused_pack_mmt4d.py: fused_pack_mmt4d_pallas (TPU).
//   out (M, N1*128) f32 = lhs (M, K1*128) x W^T,  W[n, k] = rhs4[n/128][k/128][n%128][k%128]
//
// What bounds it on the H100: operations.  A prefill of B x 512 rows does
// ~M flops per weight element, above the card's ~295 flop/byte ridge, so
// the floor is 2*M*N*K / 989 TFLOP/s (bf16 tensor cores).
//
// Design.  The TPU kernel carries an f32 accumulator across sequential K
// grid steps; on the card blocks run in parallel and in no order, so each
// block owns one output tile and loops over all of K itself.  The lhs pack
// and the output unpack stay inside the kernel: the block reads (BM, BK)
// slabs of the plain 2-D rows and writes the plain 2-D output.  A block's
// N tile is exactly one packed N0 = 128 tile, so its weight slab for a K
// step is 128 contiguous packed rows.  M is masked in the kernel (rows past
// M load zeros and are never stored), never padded on the host.
//   bf16: 128 x 128 x 32 block tiles, 8 warps, WMMA 16x16x16 bf16 fragments
//         with f32 accumulators (tensor cores via mma.sync).
//   f32 : 64 x 64 x 16 block tiles, 256 threads with a 4 x 4 register tile
//         each, plain FMA (exact f32 products, no TF32).
// Staging is synchronous (load, barrier, compute); cp.async/TMA pipelining
// and wgmma are later work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int T0 = 128;  // pack tile (N0 = K0)

// ---- bf16: tensor cores ----------------------------------------------------
constexpr int BM = 128, BK = 32, LDS = BK + 8;  // BN == T0

__global__ void __launch_bounds__(256)
gemm_bf16_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs4,
                 float* __restrict__ out, int M, int n1, int k1) {
  __shared__ __align__(32) bf16 As[BM][LDS];
  __shared__ __align__(32) bf16 Bs[T0][LDS];
  __shared__ __align__(32) float Cs[8][16 * 16];
  const int K = k1 * T0;
  const int N = n1 * T0;
  const int nt = blockIdx.x;
  const int m_base = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 2;  // 2 warp rows of 64
  const int wn = warp & 3;   // 4 warp cols of 32

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int kb = 0; kb < K; kb += BK) {
    const int kt = kb / T0;
    const int k0 = kb % T0;
    for (int i = threadIdx.x; i < BM * (BK / 8); i += blockDim.x) {
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      const int gm = m_base + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M) v = *reinterpret_cast<const uint4*>(lhs + (size_t)gm * K + kb + c);
      *reinterpret_cast<uint4*>(&As[r][c]) = v;
    }
    const bf16* tile = rhs4 + ((size_t)nt * k1 + kt) * T0 * T0;
    for (int i = threadIdx.x; i < T0 * (BK / 8); i += blockDim.x) {
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[r][c]) =
          *reinterpret_cast<const uint4*>(tile + (size_t)r * T0 + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], &As[wm * 64 + i * 16][kk], LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[wn * 32 + j * 16][kk], LDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r0 = m_base + wm * 64 + i * 16;
      const int c0 = nt * T0 + wn * 32 + j * 16;
      if (r0 + 16 <= M) {
        wmma::store_matrix_sync(out + (size_t)r0 * N + c0, acc[i][j], N, wmma::mem_row_major);
      } else if (r0 < M) {
        // Ragged M edge: stage the fragment and store only the live rows.
        wmma::store_matrix_sync(Cs[warp], acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e >> 4;
          if (r0 + r < M) out[(size_t)(r0 + r) * N + c0 + (e & 15)] = Cs[warp][e];
        }
        __syncwarp();
      }
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

}  // namespace

extern "C" int fused_pack_mmt4d(const void* lhs, const void* rhs4, void* out, int m,
                                int n1, int k1, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_BF16) {
    const dim3 grid(n1, (m + BM - 1) / BM);
    gemm_bf16_kernel<<<grid, 256, 0, s>>>(static_cast<const bf16*>(lhs),
                                          static_cast<const bf16*>(rhs4),
                                          static_cast<float*>(out), m, n1, k1);
  } else if (dtype == DTYPE_F32) {
    const dim3 grid(n1 * (T0 / FB), (m + FB - 1) / FB);
    gemm_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(lhs),
                                         static_cast<const float*>(rhs4),
                                         static_cast<float*>(out), m, n1, k1);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
