// Packed-layout decode GEMV: linalg.mmt4d with one packed row block.
//
// Replaces src/repro/kernels/mmt4d_gemv.py: mmt4d_gemv_pallas (TPU).
//   lhs4 (1, K1, M0, K0) x rhs4 (N1, K1, N0, K0) -> out4 (1, N1, M0, N0) f32,
//   M0 <= 8 live decode rows, N0 = K0 = 128.
//
// What bounds it on the H100: bytes.  M0 <= 8 rows do about 2*M0 flops per
// weight element, far below the ~295 flop/byte ridge, so the floor is the
// packed weight streamed once (N*K*itemsize / 3.35 TB/s).
//
// Design.  The TPU kernel keeps the whole packed row block resident in VMEM
// and walks N, one weight block per grid step.
//   bf16: the packed GEMM's skinny body (packed_skinny.cuh) at M1 = 1: 32
//     output columns a block, K split so that the grid fills the card (the
//     host's plan, kernels/mmt4d.py: mmt4d_plan), weight slices and the
//     row block streamed by TMA into a 4-8-stage ring, mma.sync m16n8k16
//     with the weight as the wide side (the M0 rows pad to 8), the splits
//     merged in split order in the one launch.
//   f32: one warp per output column n walks that column's K1 packed rows
//     (in tile (n/128, k1) the 128 K0 elements of row n%128 are 512
//     contiguous bytes: lane l reads elements 4l..4l+3); the row block is
//     staged in shared memory one K chunk at a time, read by every warp of
//     the block; exact f32 products on CUDA cores (no TF32: the f32 token
//     identity of the serving checks needs them).  M0 is a template
//     parameter from 1 to 8, never padded.
// `mmt4d_gemv_rows` is the plain-row entry the ops path's packed decode
// route calls: plain rows (M <= 8, K) in, plain (M, N) out, the same sums.
#include "packed_skinny.cuh"

namespace {

constexpr int T0 = 128;   // N0 = K0
constexpr int WARPS = 8;  // output columns per block
constexpr int KC = 1024;  // K elements of the rows staged per pass

// PLAIN: lhs (M, K1*T0) and out (M, N1*T0) plain rows, the same sums in the
// same order (the plain-row entry).
template <int M, bool PLAIN>
__global__ void __launch_bounds__(WARPS * 32)
mmt4d_gemv_f32_kernel(const float* __restrict__ lhs4, const float* __restrict__ rhs4,
                      float* __restrict__ out4, int n1, int k1) {
  __shared__ __align__(16) float xs[M][KC];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int K = k1 * T0;
  const int n = blockIdx.x * WARPS + warp;  // grid covers N exactly
  const int nt = n / T0;
  const int n0 = n % T0;

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;

  for (int kc = 0; kc < K; kc += KC) {
    const int kn = min(KC, K - kc);  // a multiple of T0
    __syncthreads();
    for (int i = threadIdx.x; i < M * kn; i += blockDim.x) {
      const int m = i / kn;
      const int k = kc + (i - m * kn);
      xs[m][k - kc] = lhs4[PLAIN ? (size_t)m * K + k : ((size_t)(k / T0) * M + m) * T0 + (k % T0)];
    }
    __syncthreads();
    const float* wrow = rhs4 + (((size_t)nt * k1 + kc / T0) * T0 + n0) * T0 + lane * 4;
    const int tiles = kn / T0;
#pragma unroll 4
    for (int t = 0; t < tiles; ++t) {
      float w[4];
      load4(wrow + (size_t)t * T0 * T0, w);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 x = *reinterpret_cast<const float4*>(&xs[m][t * T0 + lane * 4]);
        acc[m] += w[0] * x.x + w[1] * x.y + w[2] * x.z + w[3] * x.w;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float s = warp_sum(acc[m]);
    if (lane == 0) out4[PLAIN ? (size_t)m * n1 * T0 + n : ((size_t)nt * M + m) * T0 + n0] = s;
  }
}

template <bool PLAIN>
int launch_f32(const void* lhs4, const void* rhs4, void* out4, int m0, int n1, int k1,
               cudaStream_t stream) {
  const dim3 grid(n1 * T0 / WARPS);
  const dim3 block(WARPS * 32);
  const float* a = static_cast<const float*>(lhs4);
  const float* w = static_cast<const float*>(rhs4);
  float* o = static_cast<float*>(out4);
  switch (m0) {
#define CASE(MM) \
  case MM: mmt4d_gemv_f32_kernel<MM, PLAIN><<<grid, block, 0, stream>>>(a, w, o, n1, k1); break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// splits: the bf16 body's K ranges (part, cnt: the wrapper's scratch when
// splits > 1); the f32 kernel ignores them.
extern "C" int mmt4d_gemv(const void* lhs4, const void* rhs4, void* out4, int m0, int n1,
                          int k1, int dtype, int splits, void* part, void* cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n1 < 1 || k1 < 1 || m0 < 1 || m0 > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_BF16)
    return static_cast<int>(launch_skinny<bf16>(lhs4, rhs4, static_cast<float*>(out4), 1, m0, n1,
                                                k1, splits, part, static_cast<int*>(cnt),
                                                Scales{}, s));
  if (dtype == DTYPE_F32) return launch_f32<false>(lhs4, rhs4, out4, m0, n1, k1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plain-row entry: lhs (m, K1*128), m <= 8 -> out (m, N1*128) f32,
// equal to the packed entry's unpacked result at one row block of M0 = m
// bit for bit: in bf16 the same body, plan and order of sums entered with
// plain rows (packed_skinny.cuh: launch_skinny_plain, the decode GEMV's
// entry), in f32 the same kernel reading and storing plain rows.
extern "C" int mmt4d_gemv_rows(const void* lhs, const void* rhs4, void* out, int m, int n1,
                               int k1, int dtype, int splits, void* part, void* cnt,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n1 < 1 || k1 < 1 || m < 1 || m > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_BF16)
    return static_cast<int>(launch_skinny_plain<bf16>(lhs, rhs4, static_cast<float*>(out), m, n1,
                                                      k1, splits, part, static_cast<int*>(cnt), s));
  if (dtype == DTYPE_F32) return launch_f32<true>(lhs, rhs4, out, m, n1, k1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
