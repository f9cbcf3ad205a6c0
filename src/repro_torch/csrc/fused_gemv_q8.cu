// w8a8 decode projection: int8 activation rows times the packed int8 weight,
// with the factorized scale epilogue.
//
// Replaces src/repro/kernels/fused_gemv.py: fused_gemv_q8_pallas (TPU).
//   out (M, N1*128) f32 = (float(sum_k lhs_q[m, k] * W_q[n, k]) * s_a[m]) * s_w[n],
//   W_q[n, k] = rhs4_q[n/128][k/128][n%128][k%128],  s_a (M, 1) f32,  s_w (N1, 128) f32.
//
// What bounds it on the H100: bytes.  M <= 8 rows do about 2*M operations
// per weight byte, far below the ridge of the int8 tensor-core rate, so the
// floor is the int8 weight streamed once (N*K bytes / 3.35 TB/s): half the
// bytes of the bf16 GEMV.
//
// Design (the fused bf16 GEMV's, csrc/fused_gemv.cu, on int8).  One warp
// owns one output column n and walks that column's K1 packed rows.  In tile
// (n/128, k1) the 128 int8 K elements of row n%128 are 128 contiguous bytes,
// so 8 lanes read one row with 16-byte loads and a warp covers 4 K tiles per
// load: four full 128-byte lines.  The weight is read exactly once over the
// grid.  The M <= 8 int8 rows are staged in shared memory one K chunk at a
// time and read by every warp of the block.  Each lane sums its 16 bytes per
// row with four __dp4a (4 x int8 products into an int32), the warp reduces
// the int32 partials, and lane 0 applies the epilogue in the JAX order,
// (float(acc) * s_a) * s_w.  The integer sum is exact in any order, so the
// result equals the plain version bit for bit.  M is a template parameter
// (1..8); rows are never padded.
#include "common.cuh"

namespace {

constexpr int T0 = 128;     // pack tile (N0 = K0)
constexpr int WARPS = 8;    // output columns per block
constexpr int KC = 4096;    // K elements of the rows staged per pass
constexpr int TPW = 4;      // K tiles a warp covers per load (8 lanes each)

__device__ __forceinline__ int dot16(const int4 w, const int4 x, int acc) {
  acc = __dp4a(w.x, x.x, acc);
  acc = __dp4a(w.y, x.y, acc);
  acc = __dp4a(w.z, x.z, acc);
  return __dp4a(w.w, x.w, acc);
}

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int M>
__global__ void __launch_bounds__(WARPS * 32)
fused_gemv_q8_kernel(const int8_t* __restrict__ lhs, const int8_t* __restrict__ rhs4,
                     const float* __restrict__ s_a, const float* __restrict__ s_w,
                     float* __restrict__ out, int n1, int k1) {
  __shared__ __align__(16) int8_t xs[M][KC];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int N = n1 * T0;
  const int K = k1 * T0;
  const int n = blockIdx.x * WARPS + warp;  // grid covers N exactly
  const int nt = n / T0;
  const int n0 = n % T0;
  const int sub = lane >> 3;          // which of the TPW tiles this lane reads
  const int byte = (lane & 7) * 16;   // its 16 bytes of the 128-byte tile row

  int acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0;

  for (int kc = 0; kc < K; kc += KC) {
    const int kn = min(KC, K - kc);  // a multiple of T0
    __syncthreads();
    for (int i = threadIdx.x; i < M * kn / 16; i += blockDim.x) {
      const int m = i / (kn / 16);
      const int kk = (i - m * (kn / 16)) * 16;
      *reinterpret_cast<int4*>(&xs[m][kk]) =
          *reinterpret_cast<const int4*>(lhs + (size_t)m * K + kc + kk);
    }
    __syncthreads();
    const int tiles = kn / T0;
    const int8_t* wbase = rhs4 + (((size_t)nt * k1 + kc / T0) * T0 + n0) * T0 + byte;
#pragma unroll 4
    for (int t0 = 0; t0 < tiles; t0 += TPW) {
      const int t = t0 + sub;
      if (t < tiles) {
        const int4 w = *reinterpret_cast<const int4*>(wbase + (size_t)t * T0 * T0);
#pragma unroll
        for (int m = 0; m < M; ++m)
          acc[m] = dot16(w, *reinterpret_cast<const int4*>(&xs[m][t * T0 + byte]), acc[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int s = warp_sum_int(acc[m]);
    if (lane == 0) out[(size_t)m * N + n] = (static_cast<float>(s) * s_a[m]) * s_w[n];
  }
}

}  // namespace

extern "C" int fused_gemv_q8(const void* lhs, const void* rhs4, const void* s_a,
                             const void* s_w, void* out, int m, int n1, int k1,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n1 * T0 / WARPS);
  const dim3 block(WARPS * 32);
  const int8_t* a = static_cast<const int8_t*>(lhs);
  const int8_t* w = static_cast<const int8_t*>(rhs4);
  const float* sa = static_cast<const float*>(s_a);
  const float* sw = static_cast<const float*>(s_w);
  float* o = static_cast<float*>(out);
  switch (m) {
#define CASE(MM) \
  case MM: fused_gemv_q8_kernel<MM><<<grid, block, 0, s>>>(a, w, sa, sw, o, n1, k1); break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
