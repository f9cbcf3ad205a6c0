// Decode projection: plain activation rows times the packed weight.
//
// Replaces src/repro/kernels/fused_gemv.py: fused_gemv_pallas (TPU).
//   out (M, N1*128) f32 = lhs (M, K1*128) x W^T,  W[n, k] = rhs4[n/128][k/128][n%128][k%128]
//
// What bounds it on the H100: bytes.  M <= 8 rows means about 2*M flops per
// weight element, far below the ~295 flop/byte the card needs before the
// tensor cores become the limit, so the time floor is the packed weight
// streamed once from device memory (N*K*itemsize / 3.35 TB/s).
//
// Design.  The TPU kernel keeps the activation rows resident and walks N,
// one weight block per grid step; pack and unpack stay inside the kernel.
//   bf16: the skinny split-K body (packed_skinny.cuh) that the packed GEMV
//     runs, entered with plain rows (SkPlainRows): the rows come through a
//     2-D TMA map over lhs (M, K), box (64, 8) with the rows past M read as
//     zeros, and each row's 32 output columns leave as 16-byte stores at
//     out + m*N + n.  32 output columns a block, K split so that the grid
//     fills the card (the host's plan, kernels/mmt4d.py: mmt4d_plan at one
//     row block of M0 = M rows), weight slices streamed by TMA into a
//     4-8-stage ring, mma.sync m16n8k16 with the weight as the wide side
//     (the M rows pad to 8), the splits merged in split order in the one
//     launch.
//   f32: one warp owns one output column n and walks that column's K1
//     packed rows: within tile (n/128, k1) the 128 K0 elements of row n%128
//     are 512 contiguous bytes, so lane l reads elements 4l..4l+3.  The
//     M <= 8 activation rows are staged in shared memory one K chunk at a
//     time (at most 8 x 1024 floats) and read by every warp of the block.
//     Exact f32 products on CUDA cores (no TF32: the f32 token identity of
//     the serving checks needs them); M is a template parameter from 1 to
//     8, never padded.
#include "packed_skinny.cuh"

namespace {

constexpr int T0 = 128;     // pack tile (N0 = K0)
constexpr int WARPS = 8;    // f32: output columns per block
constexpr int KC = 1024;    // f32: K elements of the rows staged per pass

template <int M>
__global__ void __launch_bounds__(WARPS * 32)
fused_gemv_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs4,
                      float* __restrict__ out, int n1, int k1) {
  __shared__ __align__(16) float xs[M][KC];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int N = n1 * T0;
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
      const int kk = i - m * kn;
      xs[m][kk] = lhs[(size_t)m * K + kc + kk];
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
    if (lane == 0) out[(size_t)m * N + n] = s;
  }
}

int launch_f32(const void* lhs, const void* rhs4, void* out, int m, int n1, int k1,
               cudaStream_t stream) {
  const dim3 grid(n1 * T0 / WARPS);
  const dim3 block(WARPS * 32);
  const float* a = static_cast<const float*>(lhs);
  const float* w = static_cast<const float*>(rhs4);
  float* o = static_cast<float*>(out);
  switch (m) {
#define CASE(MM) \
  case MM: fused_gemv_f32_kernel<MM><<<grid, block, 0, stream>>>(a, w, o, n1, k1); break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// splits: the bf16 body's K ranges (part, cnt: the wrapper's scratch when
// splits > 1); the f32 kernel ignores them.
extern "C" int fused_gemv(const void* lhs, const void* rhs4, void* out, int m, int n1, int k1,
                          int dtype, int splits, void* part, void* cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || m > 8 || n1 < 1 || k1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_BF16)
    return static_cast<int>(launch_skinny_plain<bf16>(lhs, rhs4, static_cast<float*>(out), m, n1,
                                                      k1, splits, part, static_cast<int*>(cnt),
                                                      s));
  if (dtype == DTYPE_F32) return launch_f32(lhs, rhs4, out, m, n1, k1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
