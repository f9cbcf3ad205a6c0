// Causal GQA prefill attention, through the body the decode kernels share.
//
// Replaces src/repro/kernels/attn.py: flash_prefill_attention (TPU).
//   q (B, Sq, H, D), k/v (B, Sk, KV, D) -> out (B, Sq, H, D) in q's dtype.
//   Query row i sits at absolute position q_offset + i; key j at position j.
//   Head h reads kv head h / G (G = H / KV): head = kv*G + j, the JAX
//   package's grouping (repeat_interleave, not repeat).  causal: keys j <=
//   q_offset + i (all Sk keys otherwise); window > 0: also j > q_offset + i
//   - window.  A row with no key writes 0.
//
// What bounds it on the H100: at the serving shapes (B = 4, Sq = Sk = 512,
// H = 32, KV = 8, D = 64, bf16) bytes, just: q, k, v and out are 21 MB,
// 6.3 us at 3.35 TB/s, against 4.3 GFLOP (4*Sq*Sk*H*D, half of it above the
// causal diagonal and skipped), 4.3 us at 989 TFLOP/s.  Both are far below
// a launch's latency chain, so what counts is how many SMs work and how
// long each one's chain of staged key tiles is.
//
// Design.  Prefill attention is decode attention over a dense cache with
// L = Sq query positions: the TPU kernel's (q chunk, kv chunk) grid with
// its diagonal clamp is what decode_attn.cuh already runs for a verify
// window.  This entry calls that body with the DenseAddr policy over K/V as
// they are (row (b * Sk + t) * KV + kv), one scalar position q_offset for
// every row (no position tensor), t_cap = Sk - 1, and the flags prefill
// adds: causal, and the sliding band at any L.  So bf16 runs on the tensor
// cores (mma.sync m16n8k16, online softmax in registers) over K/V tiles
// staged by cp.async a tile ahead; key tiles above a query tile's diagonal,
// or below its band, are never staged; the host's split plan
// (kernels/attn.py: decode_split_plan over the Sk keys, the dense kernel's
// bound) leaves the serving shapes unsplit (1024 blocks) and splits a short
// one-request prefill across the card.  f32 queries take the body's CUDA
// cores (exact f32 products).  Against the kernel it replaces (one thread
// per query row walking every key in f32 FMAs, K/V converted to f32 behind
// two barriers a chunk): the products move to the tensor cores, the copies
// overlap the compute, and one staged tile serves the 64 query rows (16
// positions x 4 heads at G = 4) of a block.  Identical keys give the dense
// decode kernel's bits: the same blocks run the same arithmetic.
#include "decode_attn.cuh"

extern "C" int flash_prefill_attention(const void* q, const void* k, const void* v, void* out,
                                       void* part, void* cnt, int b, int sq, int sk, int h,
                                       int kvh, int d, int q_offset, int causal, int window,
                                       int splits, int kps, float scale, int dtype,
                                       void* stream) {
  using namespace decode_attn;
  if (sk < 1 || q_offset < 0 || window < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, nullptr, nullptr, nullptr, out, static_cast<float*>(part),
         static_cast<int*>(cnt), b, sq, h, kvh, sk - 1, window, sk, splits, kps, scale};
  a.pos0 = q_offset;
  a.causal = causal ? 1 : 0;
  return launch_any<false>(dtype, KV_RAW, d, a, DenseAddr{sk, kvh}, stream);
}
