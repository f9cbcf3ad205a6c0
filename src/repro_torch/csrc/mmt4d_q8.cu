// w8a8 packed-layout GEMM: int8 mmt4d with an int32 sum and the factorized
// scale epilogue, packed result.
//
// Replaces src/repro/kernels/mmt4d_q8.py: mmt4d_q8_pallas (TPU).
//   lhs4 (M1, K1, M0, K0) int8 x rhs4 (N1, K1, N0, K0) int8 -> out4 (M1, N1, M0, N0) f32,
//   out4[m1, n1, m0, n0] = (float(sum_{k1, k0} lhs4[m1, k1, m0, k0] * rhs4[n1, k1, n0, k0])
//                           * s_a[m1, m0]) * s_w[n1, n0],
//   N0 = K0 = 128 (the stored weight tile); M0 in 1..8 at decode, 128 at prefill.
//
// What bounds it on the H100: bytes at decode (16-256 rows of a verify,
// mixed or many-slot dispatch do 2*M operations per weight byte, below the
// int8 ridge of ~590 operations per byte), operations at prefill (2048 rows
// at M0 = 128).
//
// Design: the bf16 packed GEMM's two bodies (mmt4d.cu), instantiated for
// int8, the body chosen by the host's plan (kernels/mmt4d.py: mmt4d_plan,
// whose crossover an int8 sweep confirmed: PERF.md, section 6).  A K0 =
// 128 int8 tile row is 128 bytes, one 128B-swizzle box row, and an s8
// tensor-core step (mma.sync m16n8k32, wgmma m64nNk32) consumes the same
// 32 bytes of K a row as the bf16 k16 step, so both bodies' addressing
// carries over byte for byte with one box a K tile.
//   few rows ("skinny": up to 64 packed rows, and any row count at an M0
//     of 3, 5, 6 or 7): packed_skinny.cuh.  Blocks of 32 output columns x
//     all rows x one K range, the K split chosen so that the grid fills
//     the card; mma.sync m16n8k32 s8 with int32 accumulators; warp sums
//     and split partials stay int32 (|sum| reaches 127 * 127 * 8192 ~
//     1.3e8 > 2^24, where f32 would round), merged in the launch by the
//     last block of each tile, which alone applies the scale epilogue.
//   wide windows ("wide": prefill slabs at M0 = 128, and mixed windows
//     past 64 rows whose wide grid fills a wave): gemm_wgmma.cuh's TMA +
//     wgmma pipeline with the PackedRows policy, wgmma m64n{64,128}k32 s8
//     with s32 register accumulators, the scale epilogue in the epilogue
//     pass.
// The integer sum is exact in either body, and the epilogue is the JAX
// order (float(acc) * s_a) * s_w, so the result equals the plain version
// bit for bit.  `mmt4d_q8_rows` is the plain-row entry (plain int8 rows and
// s_a (M,) in, plain (M, N) out, the same plan: mmt4d.cu's mmt4d_rows).
#include "gemm_wgmma.cuh"
#include "packed_skinny.cuh"

// wide = 0: the skinny body with `splits` K ranges (part, cnt: the
// wrapper's scratch when splits > 1); wide = 1: the wgmma pipeline with the
// (bm, bn) tile.
extern "C" int mmt4d_q8(const void* lhs4, const void* rhs4, const void* s_a, const void* s_w,
                        void* out4, int m1, int m0, int n1, int k1, int wide, int bm, int bn,
                        int splits, void* part, void* cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m1 < 1 || m0 < 1 || n1 < 1 || k1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out4);
  const Scales sc{static_cast<const float*>(s_a), static_cast<const float*>(s_w)};
  if (!wide) {
    return static_cast<int>(launch_skinny<int8_t>(lhs4, rhs4, o, m1, m0, n1, k1, splits, part,
                                                  static_cast<int*>(cnt), sc, s));
  }
  // The rank-4 box must land whole row blocks or whole slabs of one.
  if (bm % m0 != 0 && m0 % bm != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_lhs;
  const cudaError_t e = encode_packed_rows<int8_t>(&tm_lhs, lhs4, m1, m0, k1, std::min(m0, bm),
                                                   std::max(1, bm / m0));
  if (e != cudaSuccess) return static_cast<int>(e);
  const PackedRows p{o, m1 * m0, m0, n1};
  return static_cast<int>(launch_wgmma_tile<int8_t>(bm, bn, tm_lhs, rhs4, p, n1, k1, sc, s));
}

// The plain-row entry: int8 lhs (m, K1*128), s_a (m,) -> out (m, N1*128)
// f32 under the plan of the packed entry at lhs4 (ceil(m / m0), K1, m0,
// 128), equal to its unpacked result bit for bit (mmt4d.cu: mmt4d_rows); the
// scale epilogue reads s_a only for rows < m.
extern "C" int mmt4d_q8_rows(const void* lhs, const void* rhs4, const void* s_a, const void* s_w,
                             void* out, int m, int m0, int n1, int k1, int wide, int bm, int bn,
                             int splits, void* part, void* cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || m0 < 1 || n1 < 1 || k1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  const Scales sc{static_cast<const float*>(s_a), static_cast<const float*>(s_w)};
  if (!wide) {
    return static_cast<int>(launch_skinny_rows<int8_t>(lhs, rhs4, o, m, m0, n1, k1, splits, part,
                                                       static_cast<int*>(cnt), sc, s));
  }
  CUtensorMap tm_lhs;
  const cudaError_t e = plain_rows_map<int8_t>(&tm_lhs, lhs, m, k1, bm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const PlainRows p{o, m, n1 * TMA_T0};
  return static_cast<int>(launch_wgmma_tile<int8_t>(bm, bn, tm_lhs, rhs4, p, n1, k1, sc, s));
}
