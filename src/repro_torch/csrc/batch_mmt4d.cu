// Batched packed-layout GEMM: linalg.batch_mmt4d, f32 accumulation.
//
// Replaces src/repro/kernels/batch_mmt4d.py: batch_mmt4d_pallas (TPU).
//   lhs5 (B, M1, K1, M0, K0) x rhs5 (B, N1, K1, N0, K0) -> out5 (B, M1, N1, M0, N0) f32,
//   out5[z, m1, n1, m0, n0] = sum_{k1, k0} lhs5[z, m1, k1, m0, k0] * rhs5[z, n1, k1, n0, k0],
//   f32 or bf16 operands (bf16 products are exact in f32).
// IREE lowers short-sequence attention score and context products to it; no
// serving path of the JAX package or of the port calls it (the model's
// attention runs the flash and decode kernels), so it stands here as the
// library kernel it is in the JAX package, checked against its plain version.
//
// What bounds it on the H100: at the attention shapes (M0 = 16, K0 = 64,
// one or two K tiles) the f32 operations and the bytes are close: a
// (128, 8, 1, 16, 64) x (128, 8, 1, 16, 64) score product moves 16.8 MB
// (0.005 ms) for 0.27 GFLOP (0.004 ms at 67 TFLOP/s on CUDA cores).
//
// Design.  The TPU kernel walks a (B, M1, N1, K1) grid and carries a VMEM
// accumulator across the sequential K1 steps.  Here one block owns one
// (z, m1, n1) output tile of M0 x N0 and loops over K1 itself, so no block
// depends on another.  Each K1 step stages the (M0, K0) lhs tile and the
// (N0, K0) rhs tile in shared memory as f32 (rows padded by one word so the
// threads of a warp, which walk neighbouring n0, read different banks);
// each thread keeps up to four outputs in registers and sums their K0
// products with fmaf (CUDA cores, exact f32 products, no TF32).  Tiles up
// to M0 * N0 = 1024 outputs and (M0 + N0) * (K0 + 1) * 4 bytes of shared
// memory within 48 KB; tensor cores and register tiling are later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;  // outputs a thread keeps: M0 * N0 <= THREADS * PER_THREAD

template <typename T>
__global__ void __launch_bounds__(THREADS)
batch_mmt4d_kernel(const T* __restrict__ lhs5, const T* __restrict__ rhs5,
                   float* __restrict__ out5, int m1, int n1, int k1, int m0, int n0, int k0) {
  extern __shared__ float smem[];
  const int ld = k0 + 1;
  float* As = smem;            // (m0, ld)
  float* Bs = smem + m0 * ld;  // (n0, ld)
  const int tile = blockIdx.x;  // (z * m1 + a1) * n1 + b1
  const int b1 = tile % n1;
  const int za = tile / n1;     // z * m1 + a1
  const int a1 = za % m1;
  const int z = za / m1;
  const int outs = m0 * n0;

  float acc[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < k1; ++kt) {
    const T* a = lhs5 + (((size_t)za * k1 + kt) * m0) * k0;
    const T* b = rhs5 + ((((size_t)z * n1 + b1) * k1 + kt) * n0) * k0;
    for (int i = threadIdx.x; i < m0 * k0; i += THREADS)
      As[(i / k0) * ld + (i % k0)] = to_f32(a[i]);
    for (int i = threadIdx.x; i < n0 * k0; i += THREADS)
      Bs[(i / k0) * ld + (i % k0)] = to_f32(b[i]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int o = threadIdx.x + i * THREADS;
      if (o < outs) {
        const float* ar = As + (o / n0) * ld;
        const float* br = Bs + (o % n0) * ld;
        float s = acc[i];
        for (int k = 0; k < k0; ++k) s = fmaf(ar[k], br[k], s);
        acc[i] = s;
      }
    }
    __syncthreads();
  }
  float* o5 = out5 + (size_t)tile * outs;  // (z, a1, b1) tile, (m0, n0) row-major
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int o = threadIdx.x + i * THREADS;
    if (o < outs) o5[o] = acc[i];
  }
}

}  // namespace

extern "C" int batch_mmt4d(const void* lhs5, const void* rhs5, void* out5, int bsz, int m1,
                           int n1, int k1, int m0, int n0, int k0, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(m0 + n0) * (k0 + 1) * sizeof(float);
  if (bsz < 1 || m1 < 1 || n1 < 1 || k1 < 1 || m0 < 1 || n0 < 1 || k0 < 1 ||
      m0 * n0 > THREADS * PER_THREAD || smem > 48 * 1024 ||
      (long long)bsz * m1 * n1 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = bsz * m1 * n1;
  if (dtype == DTYPE_BF16) {
    batch_mmt4d_kernel<bf16><<<grid, THREADS, smem, s>>>(
        static_cast<const bf16*>(lhs5), static_cast<const bf16*>(rhs5),
        static_cast<float*>(out5), m1, n1, k1, m0, n0, k0);
  } else if (dtype == DTYPE_F32) {
    batch_mmt4d_kernel<float><<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(lhs5), static_cast<const float*>(rhs5),
        static_cast<float*>(out5), m1, n1, k1, m0, n0, k0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
