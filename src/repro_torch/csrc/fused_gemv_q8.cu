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
// Design: the decode-GEMV body of gemv_warps.cuh (blocks of 16 columns over
// the whole of K, the block's warps splitting its K tiles, one launch, no
// merge through memory).  Lane (g, t) of a warp loads, for each K tile,
// bytes 16t.. and 64+16t.. of weight rows g and g+8 of its block's slice
// (four 16-byte loads) and the same bytes of row g of lhs (two; zeros past
// M).  Each 16 bytes are the A (weight) or B (rows) registers of two
// mma.sync m16n8k32 s8 steps as they stand: slots 4t..4t+3 and 16+4t..
// take K 16c+0..3 and 16c+4..7 of chunk c in one step and 16c+8.. and
// 16c+12.. in the next, on both sides alike.  The int32 fragment is exact;
// the warps' sums are added in warp order, then the epilogue in the JAX
// order, (float(acc) * s_a) * s_w: the result equals the plain version bit
// for bit.
#include "gemv_warps.cuh"

namespace {

constexpr int T0 = 128;  // pack tile (N0 = K0)

// W warps; block x owns output columns [16x, 16x + 16).
template <int W>
__global__ void __launch_bounds__(W * 32)
gemv_q8_warps(const int8_t* __restrict__ lhs, const int8_t* __restrict__ rhs4,
              const float* __restrict__ s_a, const float* __restrict__ s_w,
              float* __restrict__ out, int m, int n1, int k1) {
  __shared__ int red[W][GV_ROWS * GV_LDR];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_base = blockIdx.x * GV_BN;
  const int K = k1 * T0;
  // The epilogue's scales, fetched before the stream.
  const int e = threadIdx.x;
  float sa = 0.f, sw = 0.f;
  if (e < m * GV_BN) {
    sa = s_a[e / GV_BN];
    sw = s_w[n_base + e % GV_BN];
  }
  // Weight row g of the slice in tile (n_base / 128, 0), at byte 16t; a K
  // tile is T0 * T0 bytes on, row g + 8 is 8 * T0 on, the tile row's second
  // half 64 on.
  const int8_t* wp = rhs4 + ((size_t)(n_base / T0) * k1 * T0 + n_base % T0 + g) * T0 + 16 * t;
  const bool xr = g < m;
  const int8_t* xp = lhs + (size_t)(xr ? g : 0) * K + 16 * t;
  int lo, hi;
  gv_warp_tiles(warp, W, k1, lo, hi);
  int acc[4] = {0, 0, 0, 0};
  for (int kt = lo; kt < hi; ++kt) {
    const int8_t* p = wp + (size_t)kt * T0 * T0;
    const uint4 w[4] = {ld_once16(p), ld_once16(p + 64), ld_once16(p + 8 * T0),
                        ld_once16(p + 8 * T0 + 64)};
    const uint4* q = reinterpret_cast<const uint4*>(xp + kt * T0);
    const uint4 z = make_uint4(0, 0, 0, 0);
    const uint4 x[2] = {xr ? __ldg(q) : z, xr ? __ldg(q + 4) : z};
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // bytes 64h + 16t.. of rows g (w[h]) and g + 8 (w[2 + h])
      const unsigned fa0[4] = {w[h].x, w[2 + h].x, w[h].y, w[2 + h].y};
      const unsigned fb0[2] = {x[h].x, x[h].y};
      mma_16x8(acc, fa0, fb0);
      const unsigned fa1[4] = {w[h].z, w[2 + h].z, w[h].w, w[2 + h].w};
      const unsigned fb1[2] = {x[h].z, x[h].w};
      mma_16x8(acc, fa1, fb1);
    }
  }
  // acc: (column g, row 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
  int* rw = red[warp];
  rw[2 * t * GV_LDR + g] = acc[0];
  rw[(2 * t + 1) * GV_LDR + g] = acc[1];
  rw[2 * t * GV_LDR + g + 8] = acc[2];
  rw[(2 * t + 1) * GV_LDR + g + 8] = acc[3];
  const int n = n1 * T0;
  gv_store<W>(red, m, [&](int s, int r, int c) {
    out[(size_t)r * n + n_base + c] = (static_cast<float>(s) * sa) * sw;
  });
}

}  // namespace

// warps: the plan's warps a block (kernels/fused_gemv.py: gemv_q8_plan).
extern "C" int fused_gemv_q8(const void* lhs, const void* rhs4, const void* s_a,
                             const void* s_w, void* out, int m, int n1, int k1, int warps,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(lhs);
  const int8_t* w = static_cast<const int8_t*>(rhs4);
  const float* sa = static_cast<const float*>(s_a);
  const float* sw = static_cast<const float*>(s_w);
  float* o = static_cast<float*>(out);
  const dim3 grid(n1 * T0 / GV_BN);
  if (m < 1 || m > GV_ROWS || n1 < 1 || k1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (warps) {
    case 8: gemv_q8_warps<8><<<grid, 8 * 32, 0, s>>>(a, w, sa, sw, o, m, n1, k1); break;
    case 16: gemv_q8_warps<16><<<grid, 16 * 32, 0, s>>>(a, w, sa, sw, o, m, n1, k1); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
