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
//   bf16: the TMA + wgmma pipeline of gemm_wgmma.cuh (which the packed
//     GEMM's wide windows share, csrc/mmt4d.cu) with the PlainRows policy:
//     lhs through a 2-D map over (M, K), box (64, BM), TMA zero-filling the
//     rows past M; plain row stores, rows >= M never stored.  The tile
//     (BM, BN) of 128 x 128, 128 x 64 or 64 x 64 comes from the host's plan
//     (kernels/fused_pack_mmt4d.py: gemm_tile_plan): the largest tile whose
//     grid still fills the 132 SMs, so the k/v projections (N = 512) and
//     one-request prefills get smaller tiles, not 16-64 blocks.  The
//     weight's tensor map is encoded once per (pointer, shape, BN) and
//     cached; lhs's per call.  cuTensorMapEncodeTiled comes from the
//     runtime's driver entry point, so the library links nothing beyond
//     the runtime.
//   f32 : 64 x 64 x 16 block tiles, 256 threads with a 4 x 4 register tile
//         each, plain FMA (exact f32 products, no TF32: the f32 token
//         identity of the serving checks needs them).
#include "gemm_wgmma.cuh"

namespace {

constexpr int T0 = 128;  // pack tile (N0 = K0)

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

// bm, bn: the bf16 kernel's block tile (128 x 128, 128 x 64 or 64 x 64),
// from the host's plan; the f32 kernel's tile is fixed.
extern "C" int fused_pack_mmt4d(const void* lhs, const void* rhs4, void* out, int m, int n1,
                                int k1, int bm, int bn, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n1 < 1 || k1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  if (dtype == DTYPE_BF16) {
    CUtensorMap tm_lhs;
    const cudaError_t e = encode_map<bf16>(&tm_lhs, lhs, m, static_cast<uint64_t>(k1) * T0, bm);
    if (e != cudaSuccess) return static_cast<int>(e);
    const PlainRows p{o, m, n1 * T0};
    return static_cast<int>(launch_wgmma_tile<bf16>(bm, bn, tm_lhs, rhs4, p, n1, k1, Scales{}, s));
  }
  if (dtype == DTYPE_F32) {
    const dim3 grid(n1 * (T0 / FB), (m + FB - 1) / FB);
    gemm_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(lhs),
                                         static_cast<const float*>(rhs4), o, m, n1, k1);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
