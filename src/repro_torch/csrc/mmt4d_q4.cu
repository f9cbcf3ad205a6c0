// w4a8 group-quantized projections: int8 activations times nibble-packed int4
// weights with one bf16 scale per `group` K elements (16 or 32).
//
// Replaces src/repro/kernels/mmt4d_q4.py: fused_gemv_q4_pallas (decode, plain
// rows) and mmt4d_q4_pallas (packed rows) (TPU).
//   rhs4_p (N1, K1, 128, 64) uint8: byte j of a tile row holds K elements 2j
//          (low nibble) and 2j+1 (high nibble), two's complement in [-8, 7];
//   s_w4   (N1, K1, 128, 128/group) bf16: the scale of each K group of a row;
//   W[n, k] = nibble(n, k) * s_w4[n/128][k/128][n%128][(k%128)/group].
//   fused_gemv_q4: lhs_q (M, K) int8, s_a (M, 1) f32 -> out (M, N) f32;
//   mmt4d_q4:      lhs4_q (M1, K1, M0, 128) int8, s_a (M1, M0) f32
//                  -> out4 (M1, N1, M0, 128) f32;
//   out = (sum_k a_q[m, k] * W[n, k]) * s_a[m].
//
// What bounds it on the H100: bytes at decode (0.625 weight bytes per
// element at group 16: the nibbles and the bf16 scales, streamed once),
// operations at prefill.  The TPU kernels dequantize each tile to f32 and
// contract in f32.  Here the per-group integer sum comes first: __dp4a takes
// four int8 products into an int32, and the group's sum (|sum| < 2^15) times
// its bf16 scale (8 significant bits) is exact.  Those terms are summed in
// float64, where the sum is exact as long as a row's group scales span less
// than a factor 2^21 (far wider than any weight row's), and rounded to f32
// once before the s_a epilogue.  So the result does not depend on the order
// of summation: it equals the plain version (ref.mmt4d_q4, a float64
// contraction) bit for bit, and differs from the TPU's f32 sum only by that
// sum's rounding.  The float64 adds are one per group and row-column pair,
// off the byte-bound path of the decode GEMV.
//
// Nibbles to int8: a 32-bit word of packed bytes holds 8 K elements; its low
// nibbles (elements 0, 2, 4, 6) and high nibbles (1, 3, 5, 7) each become 4
// sign-extended bytes with one mask, one xor and one per-byte subtract
// (__vsub4).  The activations are staged in shared memory in the matching
// order: every 8 K elements a0..a7 are stored as a0 a2 a4 a6 a1 a3 a5 a7
// (__byte_perm), so each nibble word meets its 4 activations in one int.
//
// fused_gemv_q4 (decode, M <= 8 rows): one warp per output column n walks
// that column's K1 packed rows; a tile row is 64 bytes, so 4 lanes read it
// with 16-byte loads (32 K elements each) and a warp covers 8 K tiles per
// load.  The int8 rows are staged in shared memory one K chunk at a time.
// M is a template parameter; rows are never padded.
//
// mmt4d_q4 (packed rows, any M0 in 1..8 or 128): each block owns a 64-row x
// 64-column output tile over flattened packed rows (the bf16 GEMM's tiling,
// csrc/mmt4d.cu) and loops over all of K.  Per K0 tile it stages the 64 rows'
// activations, the 64 columns' nibbles and their scales (as f32) in shared
// memory; 256 threads each own 4 rows x 4 columns (columns tx + 16 j, so the
// column reads hit distinct banks) and keep an int32 sum per group and a
// float64 sum over groups.  This runs on the CUDA cores: a tensor-core version
// (mma.sync s8 with a per-group rescale of the accumulator fragment, or
// wgmma) is later work.
#include "common.cuh"

namespace {

constexpr int T0 = 128;   // N0 = K0
constexpr int T0P = 64;   // packed bytes of a K0 tile row

__device__ __forceinline__ void expand_nibbles(unsigned w, int& lo, int& hi) {
  const unsigned l = w & 0x0F0F0F0Fu;
  const unsigned h = (w >> 4) & 0x0F0F0F0Fu;
  lo = static_cast<int>(__vsub4(l ^ 0x08080808u, 0x08080808u));
  hi = static_cast<int>(__vsub4(h ^ 0x08080808u, 0x08080808u));
}

__device__ __forceinline__ double warp_sum_f64(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 8 int8 activations a0..a7 -> {a0 a2 a4 a6, a1 a3 a5 a7}.
__device__ __forceinline__ uint2 deinterleave8(uint2 v) {
  return make_uint2(__byte_perm(v.x, v.y, 0x6420), __byte_perm(v.x, v.y, 0x7531));
}

// ---- decode GEMV --------------------------------------------------------------------
constexpr int WARPS = 8;    // output columns per block
constexpr int KC = 4096;    // K elements of the rows staged per pass
constexpr int TPW = 8;      // K tiles a warp covers per load (4 lanes each)

template <int M, int G>
__global__ void __launch_bounds__(WARPS * 32)
fused_gemv_q4_kernel(const int8_t* __restrict__ lhs, const uint8_t* __restrict__ rhs4,
                     const float* __restrict__ s_a, const bf16* __restrict__ s_w4,
                     float* __restrict__ out, int n1, int k1) {
  constexpr int GPT = T0 / G;    // groups per tile row
  constexpr int GPL = 32 / G;    // groups per lane (32 K elements)
  constexpr int CPG = G / 8;     // 8-element chunks per group
  __shared__ __align__(16) int8_t xs[M][KC];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int N = n1 * T0;
  const int K = k1 * T0;
  const int n = blockIdx.x * WARPS + warp;  // grid covers N exactly
  const int nt = n / T0;
  const int n0 = n % T0;
  const int sub = lane >> 2;   // which of the TPW tiles this lane reads
  const int q = lane & 3;      // its 32 K elements: q*32 .. q*32+31 of the tile

  double acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.0;

  for (int kc = 0; kc < K; kc += KC) {
    const int kn = min(KC, K - kc);  // a multiple of T0
    __syncthreads();
    for (int i = threadIdx.x; i < M * kn / 8; i += blockDim.x) {
      const int m = i / (kn / 8);
      const int kk = (i - m * (kn / 8)) * 8;
      *reinterpret_cast<uint2*>(&xs[m][kk]) =
          deinterleave8(*reinterpret_cast<const uint2*>(lhs + (size_t)m * K + kc + kk));
    }
    __syncthreads();
    const int tiles = kn / T0;
    const size_t row0 = ((size_t)nt * k1 + kc / T0) * T0 + n0;  // tile row of the chunk's first tile
#pragma unroll 2
    for (int t0 = 0; t0 < tiles; t0 += TPW) {
      const int t = t0 + sub;
      if (t < tiles) {
        const size_t row = row0 + (size_t)t * T0;
        const uint4 w = *reinterpret_cast<const uint4*>(rhs4 + row * T0P + q * 16);
        double sc[GPL];
#pragma unroll
        for (int g = 0; g < GPL; ++g) sc[g] = __bfloat162float(s_w4[row * GPT + q * GPL + g]);
        int lo[4], hi[4];
        expand_nibbles(w.x, lo[0], hi[0]);
        expand_nibbles(w.y, lo[1], hi[1]);
        expand_nibbles(w.z, lo[2], hi[2]);
        expand_nibbles(w.w, lo[3], hi[3]);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int* x = reinterpret_cast<const int*>(&xs[m][t * T0 + q * 32]);
          const int4 xa = *reinterpret_cast<const int4*>(x);
          const int4 xb = *reinterpret_cast<const int4*>(x + 4);
          const int xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
          for (int g = 0; g < GPL; ++g) {
            int s = 0;
#pragma unroll
            for (int c = g * CPG; c < (g + 1) * CPG; ++c) {
              s = __dp4a(lo[c], xv[2 * c], s);
              s = __dp4a(hi[c], xv[2 * c + 1], s);
            }
            acc[m] += static_cast<double>(s) * sc[g];
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const double s = warp_sum_f64(acc[m]);
    if (lane == 0) out[(size_t)m * N + n] = static_cast<float>(s) * s_a[m];
  }
}

// ---- packed GEMM --------------------------------------------------------------------
constexpr int BR = 64;   // packed rows per block
constexpr int BN = 64;   // output columns per block (half a packed N tile)

template <int G>
__global__ void __launch_bounds__(256)
mmt4d_q4_kernel(const int8_t* __restrict__ lhs4, const uint8_t* __restrict__ rhs4,
                const float* __restrict__ s_a, const bf16* __restrict__ s_w4,
                float* __restrict__ out4, int rows, int m0, int n1, int k1) {
  constexpr int GPT = T0 / G;   // groups per tile row
  constexpr int CPG = G / 8;    // 8-element chunks per group
  __shared__ int As[BR][2 * (T0 / 8) + 1];   // 16 chunks x {even, odd} words per row
  __shared__ int Bs[BN][T0P / 4 + 1];        // 16 nibble words per column
  __shared__ float Ss[BN][GPT + 1];
  const int n_base = blockIdx.x * BN;
  const int nt = n_base / T0;
  const int nb0 = n_base % T0;
  const int r_base = blockIdx.y * BR;
  const int tx = threadIdx.x & 15;   // columns tx + 16 j
  const int ty = threadIdx.x >> 4;   // rows ty * 4 + i

  double acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;

  for (int kt = 0; kt < k1; ++kt) {
    for (int p = threadIdx.x; p < BR * (T0 / 8); p += blockDim.x) {
      const int r = p / (T0 / 8);
      const int c = p % (T0 / 8);
      const int gr = r_base + r;
      uint2 v = make_uint2(0u, 0u);
      if (gr < rows) {
        const int a1 = gr / m0;
        const int a0 = gr - a1 * m0;
        v = deinterleave8(*reinterpret_cast<const uint2*>(
            lhs4 + (((size_t)a1 * k1 + kt) * m0 + a0) * T0 + c * 8));
      }
      As[r][2 * c] = static_cast<int>(v.x);
      As[r][2 * c + 1] = static_cast<int>(v.y);
    }
    const size_t tile_row0 = ((size_t)nt * k1 + kt) * T0 + nb0;
    for (int p = threadIdx.x; p < BN * (T0P / 16); p += blockDim.x) {
      const int col = p / (T0P / 16);
      const int q = p % (T0P / 16);
      const uint4 w = *reinterpret_cast<const uint4*>(rhs4 + (tile_row0 + col) * T0P + q * 16);
      Bs[col][4 * q] = static_cast<int>(w.x);
      Bs[col][4 * q + 1] = static_cast<int>(w.y);
      Bs[col][4 * q + 2] = static_cast<int>(w.z);
      Bs[col][4 * q + 3] = static_cast<int>(w.w);
    }
    for (int p = threadIdx.x; p < BN * GPT; p += blockDim.x) {
      const int col = p / GPT;
      const int g = p % GPT;
      Ss[col][g] = __bfloat162float(s_w4[(tile_row0 + col) * GPT + g]);
    }
    __syncthreads();
#pragma unroll 1
    for (int g = 0; g < GPT; ++g) {
      int s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0;
#pragma unroll
      for (int c = g * CPG; c < (g + 1) * CPG; ++c) {
        int lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) expand_nibbles(static_cast<unsigned>(Bs[tx + 16 * j][c]), lo[j], hi[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ae = As[ty * 4 + i][2 * c];
          const int ao = As[ty * 4 + i][2 * c + 1];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = __dp4a(lo[j], ae, s[i][j]);
            s[i][j] = __dp4a(hi[j], ao, s[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const double sc = Ss[tx + 16 * j][g];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += static_cast<double>(s[i][j]) * sc;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r_base + ty * 4 + i;
    if (gr < rows) {
      const int a1 = gr / m0;
      const int a0 = gr - a1 * m0;
      float* o = out4 + (((size_t)a1 * n1 + nt) * m0 + a0) * T0 + nb0;
      const float sa = s_a[gr];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[tx + 16 * j] = static_cast<float>(acc[i][j]) * sa;
    }
  }
}

template <int G>
int launch_gemv(const void* lhs, const void* rhs4, const void* s_a, const void* s_w4, void* out,
                int m, int n1, int k1, cudaStream_t stream) {
  const dim3 grid(n1 * T0 / WARPS);
  const dim3 block(WARPS * 32);
  const int8_t* a = static_cast<const int8_t*>(lhs);
  const uint8_t* w = static_cast<const uint8_t*>(rhs4);
  const float* sa = static_cast<const float*>(s_a);
  const bf16* sw = static_cast<const bf16*>(s_w4);
  float* o = static_cast<float*>(out);
  switch (m) {
#define CASE(MM) \
  case MM: fused_gemv_q4_kernel<MM, G><<<grid, block, 0, stream>>>(a, w, sa, sw, o, n1, k1); break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_gemm(const void* lhs4, const void* rhs4, const void* s_a, const void* s_w4,
                void* out4, int m1, int m0, int n1, int k1, cudaStream_t stream) {
  const int rows = m1 * m0;
  const dim3 grid(n1 * (T0 / BN), (rows + BR - 1) / BR);
  mmt4d_q4_kernel<G><<<grid, 256, 0, stream>>>(
      static_cast<const int8_t*>(lhs4), static_cast<const uint8_t*>(rhs4),
      static_cast<const float*>(s_a), static_cast<const bf16*>(s_w4), static_cast<float*>(out4),
      rows, m0, n1, k1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_gemv_q4(const void* lhs, const void* rhs4, const void* s_a,
                             const void* s_w4, void* out, int m, int n1, int k1, int group,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group == 16) return launch_gemv<16>(lhs, rhs4, s_a, s_w4, out, m, n1, k1, s);
  if (group == 32) return launch_gemv<32>(lhs, rhs4, s_a, s_w4, out, m, n1, k1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mmt4d_q4(const void* lhs4, const void* rhs4, const void* s_a, const void* s_w4,
                        void* out4, int m1, int m0, int n1, int k1, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m1 < 1 || m0 < 1 || n1 < 1 || k1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (group == 16) return launch_gemm<16>(lhs4, rhs4, s_a, s_w4, out4, m1, m0, n1, k1, s);
  if (group == 32) return launch_gemm<32>(lhs4, rhs4, s_a, s_w4, out4, m1, m0, n1, k1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
