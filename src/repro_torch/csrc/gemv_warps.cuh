// The decode-GEMV body of the w8a8 and w4a8 GEMVs (fused_gemv_q8.cu, the
// GEMV section of mmt4d_q4.cu): 1-8 plain int8 rows times a packed weight,
// one launch a call, no K split across blocks.
//
//   out (M, N1*128) f32 from lhs (M, K1*128) int8 and the packed weight,
//   int8 rhs4 (N1, K1, 128, 128) or nibbles rhs4_p (N1, K1, 128, 64) with
//   their bf16 group scales.
//
// What bounds it on the H100: bytes.  Eight rows do at most 16 operations
// a weight byte, far below the int8 ridge (~590), so the floor is the weight
// streamed once at 3.35 TB/s: 16.8 MB (int8) or 10.5 MB (nibbles and g16
// scales) at K x N = 2048 x 8192, 5.0 and 3.1 us; 1 MB at the k/v
// projections (2048 x 512), where the launch and one trip to memory are
// the whole budget.
//
// Design.
//   - Blocks.  A block owns GV_BN = 16 output columns (one m16 fragment of
//     the weight) over the whole of K: N/16 blocks, 32 / 128 / 512 / 128 at
//     Llama-3.2-1B's k-v / q-o / gate-up / down projections, so no shape
//     splits K across blocks and nothing is merged through memory.  The
//     block's W warps (the plan's: kernels/fused_gemv.py gemv_q8_plan,
//     kernels/mmt4d_q4.py gemv_q4_plan) split its K tiles into W
//     contiguous ranges, warp w taking [w*K1/W, (w+1)*K1/W).
//   - Loads.  Every lane loads its own fragments of a K tile from global
//     memory into registers, then multiplies them: no shared-memory
//     staging, no barrier before the last; the bytes in flight come from
//     the warps (W a block: 16, or 8 where the grid has more than two
//     blocks an SM, so that all of them are resident at once).  A weight
//     row's bytes of one K tile are contiguous (128 int8, 64 nibble
//     bytes), so lane (g, t) = (lane/4, lane%4) takes 16-byte loads of
//     rows g and g + 8 of the block's slice; the rows (x) come through L2,
//     each lane its own bytes; the epilogue's scales are fetched before
//     the stream.
//   - Products.  mma.sync m16n8k32 s8 with the weight as A (16 columns) and
//     the rows as B, padded to 8 (lanes of rows past M hold zeros).  Which
//     K element sits in which of the 32 slots of a step is free as long as
//     A and B agree, so each lane's 16 loaded bytes are its fragments as
//     they come (int8); nibbles are first exchanged within each quad of
//     lanes so that one step's slots hold one scale group (mmt4d_q4.cu).
//   - Sums.  int32 in the fragment (int8: exact while K < 2^17); each
//     nibble group's int32 sum rescaled into f64 by one DFMA
//     (packed_skinny.cuh, "the int4 products"), exact.  The W warps'
//     sums meet in shared memory and are added in warp order by the
//     threads that store, which apply the epilogue once.  Every sum is
//     exact, so the result equals the plain version bit for bit whatever
//     W is.
// Internal linkage throughout (see tma.cuh).
#pragma once

#include "packed_skinny.cuh"

namespace {

constexpr int GV_BN = 16;     // output columns a block owns
constexpr int GV_LDR = 20;    // a row of a warp's sums in shared memory (16 + 4: no bank conflicts)
constexpr int GV_ROWS = 8;    // rows at most (the B fragment's width)

// 16 or 8 bytes read once by the whole grid: not kept in L1.
__device__ __forceinline__ uint4 ld_once16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ld_once8(const void* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

// Warp `w` of `W` takes the block's K tiles [lo, hi).
__device__ __forceinline__ void gv_warp_tiles(int w, int W, int k1, int& lo, int& hi) {
  lo = w * k1 / W;
  hi = (w + 1) * k1 / W;
}

// The block's outputs: warp w's sums sit at red[w][row * GV_LDR + col];
// thread e < m * 16 adds output (e / 16, e % 16) over the warps in warp
// order and stores fin(sum, row, col).
template <int W, typename Acc, typename Fin>
__device__ __forceinline__ void gv_store(Acc (*red)[GV_ROWS * GV_LDR], int m, Fin fin) {
  __syncthreads();
  const int e = threadIdx.x;
  if (e >= m * GV_BN) return;
  const int r = e / GV_BN;
  const int c = e % GV_BN;
  Acc s = red[0][r * GV_LDR + c];
#pragma unroll
  for (int w = 1; w < W; ++w) s += red[w][r * GV_LDR + c];
  fin(s, r, c);
}

}  // namespace
