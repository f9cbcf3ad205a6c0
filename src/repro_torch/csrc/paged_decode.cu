// Decode attention read straight from the paged KV pool.
//
// Replaces src/repro/kernels/attn.py: paged_decode_attention (TPU), every
// KV layout of it: bf16/f32 pools, int8 pools (kv8) and packed-nibble
// pools (kv4) with float32 scale pages.
//   q (B, L, H, D), k/v pools (P, bs, KV, Ds) (Ds = D, or D/2 for kv4),
//   scale pages (P, bs, KV, 1) f32 (quantized layouts), table (B, NB) int32
//   page ids, pos (B,) int32 position of q[:, 0]  ->  out (B, L, H, D) in
//   q's dtype.  Key t of row b lives in page table[b, t / bs] at offset
//   t % bs, its scale at the same place in the scale pages.
//
// The TPU kernel is driven by a scalar-prefetched block table whose index
// map streams one page per grid step.  Here each block reads its own table
// row and position and stages only its share of the live keys 0 .. pos+l
// (a key split of the host's plan, decode_split_plan), looking the pages
// up a tile ahead: the body, bound and design are in decode_attn.cuh,
// shared with the dense kernel (dense_decode.cu) through the PagedAddr
// policy.  part/cnt: the split partials' f32 scratch and the per-tile
// counters (zero on entry, left zero), unused when splits == 1.  Idle
// slots decode at pos 0 against the scratch page and stay finite.
#include "decode_attn.cuh"

extern "C" int paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                      const void* k_scale, const void* v_scale,
                                      const void* table, const void* pos, void* out,
                                      void* part, void* cnt, int b, int L, int h, int kvh,
                                      int d, int bs, int nb, int splits, int kps, float scale,
                                      int dtype, int kv, void* stream) {
  using namespace decode_attn;
  if (bs < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), static_cast<const int*>(pos), out,
               static_cast<float*>(part), static_cast<int*>(cnt), b, L, h, kvh, nb * bs - 1,
               0, 0, splits, kps, scale};
  return launch_any<false>(dtype, kv, d, a,
                           PagedAddr{static_cast<const int*>(table), nb, bs, kvh}, stream);
}
