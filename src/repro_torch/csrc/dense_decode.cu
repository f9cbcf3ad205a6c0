// Decode attention over a dense KV cache.
//
// Replaces src/repro/kernels/attn.py: dense_decode_attention (TPU).
//   q (B, L, H, D), k/v caches (B, S_c, KV, Ds) (Ds = D, or D/2 for kv4),
//   scales (B, S_c, KV, 1) f32 (kv8/kv4), pos (B,) int32 position of q[:, 0]
//   (a scalar position is broadcast by the wrapper, as JAX's _norm_pos
//   does)  ->  out (B, L, H, D) in q's dtype.
//   window == 0: full attention, query l attends slots 0 .. min(pos+l,
//   S_c-1), any L (masked-causal verify and mixed windows).
//   window > 0: a ring cache of S_c slots (L = 1, unquantized): rows past
//   their first window visit every slot and keep those whose age
//   (qpos - t) mod S_c is below min(qpos + 1, window).
//
// The TPU kernel streams kv_chunk slabs of the cache through a BlockSpec
// and skips chunks past the newest written slot.  Here one body with the
// paged kernel (decode_attn.cuh, DenseAddr policy: row (b * S_c + t) * KV +
// kv): a block stages only its split of the live keys of its row.  Both
// kernels split keys across blocks identically (the split depends on key
// indices, never on pages), so a paged pool whose table is the identity
// gives the same bits as the matching dense cache.  part/cnt: the split
// partials' scratch and counters, as in paged_decode.cu.  Bound and
// design: decode_attn.cuh.
#include "decode_attn.cuh"

extern "C" int dense_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                      const void* k_scale, const void* v_scale,
                                      const void* pos, void* out, void* part, void* cnt,
                                      int b, int L, int h, int kvh, int d, int s_c, int window,
                                      int splits, int kps, float scale, int dtype, int kv,
                                      void* stream) {
  using namespace decode_attn;
  if (s_c < 1 || window < 0 || (window > 0 && L != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k_cache, v_cache, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), static_cast<const int*>(pos), out,
               static_cast<float*>(part), static_cast<int*>(cnt), b, L, h, kvh, s_c - 1, window,
               s_c, splits, kps, scale};
  const DenseAddr addr{s_c, kvh};
  return window > 0 ? launch_any<true>(dtype, kv, d, a, addr, stream)
                    : launch_any<false>(dtype, kv, d, a, addr, stream);
}
