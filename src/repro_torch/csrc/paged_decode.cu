// Decode attention read straight from the paged KV pool.
//
// Replaces src/repro/kernels/attn.py: paged_decode_attention (TPU).
//   q (B, L, H, D), k/v pools (P, bs, KV, D), table (B, NB) int32 page ids,
//   pos (B,) int32 position of q[:, 0]  ->  out (B, L, H, D) in q's dtype.
//   Query l of row b sits at pos[b] + l and attends every cached key t with
//   t <= pos[b] + l (masked-causal inside an L > 1 window); key t lives in
//   page table[b, t / bs] at offset t % bs.
//
// What bounds it on the H100: bytes (each live K/V row is read once per
// kv head; the math is ~2 flops per byte).
//
// Design.  One block per (query-row tile, kv head, batch row).  The G query
// heads of a kv head and the L window positions make L*G query rows (l, j),
// head = kv*G + j; a tile holds LT = min(L, 32/G) window positions, i.e. at
// most 32 rows, so any L runs as ceil(L/LT) tiles (the mixed step's
// prefill-sized windows included) and a block keeps the per-row split-key
// design.  The TPU kernel is driven by a scalar-prefetched block table; here
// each block reads its own table row and position, and walks only the live
// keys 0 .. pos+l: (pos+L-1)/bs + 1 pages at most.  A row's keys are split
// across W warps (W = 32 / (LT*G)), each warp takes 32 keys at a time, one
// key per lane: the lane reads its K row (contiguous D elements) and
// computes the full score, the warp shares max and sum by shuffles, then
// accumulates p * V row by row with lanes on neighbouring dims.  The W
// partial (m, l, acc) states of a query row are merged in shared memory at
// the end.  Rows of the last tile past L read no key and write nothing.
// Idle slots decode at pos 0 against the scratch page and stay finite.  The
// rows of a tile share its K/V rows, so they come from L1 after the first.
#include "common.cuh"

namespace {

constexpr int MAXW = 32;  // warps per block

template <typename T, int D>
__global__ void __launch_bounds__(1024)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ table,
                    const int* __restrict__ pos, T* __restrict__ out, int L, int lt, int h,
                    int kvh, int bs, int nb, int parts, float scale) {
  constexpr int DPL = (D + 31) / 32;  // accumulator dims per lane
  __shared__ float qs[MAXW][D];
  __shared__ float accs[MAXW][D];
  __shared__ float ms[MAXW];
  __shared__ float ls[MAXW];
  const int g = h / kvh;
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qrow = warp / parts;  // (l, j) query row of this warp, in the tile
  const int part = warp % parts;
  const int l = blockIdx.z * lt + qrow / g;
  const bool live = l < L;        // the last tile may hold fewer than lt positions
  const int head = kv * g + (qrow % g);
  const int qpos = pos[b] + l;
  const int t_end = live ? min(qpos, nb * bs - 1) : -1;  // last key this row attends
  const int* trow = table + (size_t)b * nb;

  if (part == 0 && live) {
    for (int d = lane; d < D; d += 32)
      qs[qrow][d] = to_f32(q[(((size_t)b * L + l) * h + head) * D + d]) * scale;
  }
  __syncthreads();

  // This warp's contiguous, 32-aligned share of keys 0 .. t_end.
  const int chunks = (t_end + 1 + 31) / 32;
  const int per = ((chunks + parts - 1) / parts) * 32;
  const int t_lo = part * per;
  const int t_hi = min(t_end + 1, t_lo + per);

  float m = __int_as_float(0xff800000);  // -inf
  float lsum = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int t0 = t_lo; t0 < t_hi; t0 += 32) {
    const int t = t0 + lane;
    const bool valid = t < t_hi;
    long long row_off = 0;  // element offset of key t's (page, slot, kv) row
    float s = __int_as_float(0xff800000);
    if (valid) {
      const int page = trow[t / bs];
      row_off = (((long long)page * bs + (t % bs)) * kvh + kv) * D;
      const T* kr = k_pool + row_off;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        float kx[4];
        load4(kr + d, kx);
        dot += qs[qrow][d] * kx[0] + qs[qrow][d + 1] * kx[1] + qs[qrow][d + 2] * kx[2] +
               qs[qrow][d + 3] * kx[3];
      }
      s = dot;
    }
    const float m_new = fmaxf(m, warp_max(s));  // finite: lane 0 is always valid
    const float corr = expf(m - m_new);
    const float p = valid ? expf(s - m_new) : 0.f;
    lsum = lsum * corr + warp_sum(p);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;
    const int n = min(32, t_hi - t0);
    for (int c = 0; c < n; ++c) {
      const float pc = __shfl_sync(0xffffffffu, p, c);
      const long long vo = __shfl_sync(0xffffffffu, row_off, c);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(pc, to_f32(v_pool[vo + d]), acc[i]);
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    ms[warp] = m;
    ls[warp] = lsum;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) accs[warp][d] = acc[i];
  }
  __syncthreads();
  if (part != 0 || !live) return;
  // Merge the `parts` partial states of this query row.
  const int w0 = qrow * parts;
  float mx = ms[w0];
  for (int p = 1; p < parts; ++p) mx = fmaxf(mx, ms[w0 + p]);
  float den = 0.f;
  for (int p = 0; p < parts; ++p) den += ls[w0 + p] * expf(ms[w0 + p] - mx);
  const float inv = den > 0.f ? 1.f / den : 0.f;
  T* o = out + (((size_t)b * L + l) * h + head) * D;
  for (int d = lane; d < D; d += 32) {
    float a = 0.f;
    for (int p = 0; p < parts; ++p) a += accs[w0 + p][d] * expf(ms[w0 + p] - mx);
    o[d] = from_f32<T>(a * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* table, const int* pos,
           void* out, int b, int L, int h, int kvh, int bs, int nb, float scale,
           cudaStream_t stream) {
  const int g = h / kvh;
  const int lt = min(L, MAXW / g);  // window positions per tile
  const int rows = lt * g;          // query rows per tile, at most MAXW
  const int parts = MAXW / rows;
  const dim3 grid(kvh, b, (L + lt - 1) / lt);
  const dim3 block(rows * parts * 32);
  paged_decode_kernel<T, D><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), table,
      pos, static_cast<T*>(out), L, lt, h, kvh, bs, nb, parts, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, const int* table,
             const int* pos, void* out, int b, int L, int h, int kvh, int bs, int nb,
             float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, table, pos, out, b, L, h, kvh, bs, nb, scale, s);
    case 32: return launch<T, 32>(q, k, v, table, pos, out, b, L, h, kvh, bs, nb, scale, s);
    case 64: return launch<T, 64>(q, k, v, table, pos, out, b, L, h, kvh, bs, nb, scale, s);
    case 128: return launch<T, 128>(q, k, v, table, pos, out, b, L, h, kvh, bs, nb, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                      const void* table, const void* pos, void* out, int b,
                                      int L, int h, int kvh, int d, int bs, int nb,
                                      float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kvh < 1 || h % kvh != 0 || L < 1 || h / kvh > MAXW || L > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(pos);
  if (dtype == DTYPE_BF16)
    return launch_d<bf16>(d, q, k_pool, v_pool, t, p, out, b, L, h, kvh, bs, nb, scale, s);
  if (dtype == DTYPE_F32)
    return launch_d<float>(d, q, k_pool, v_pool, t, p, out, b, L, h, kvh, bs, nb, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
