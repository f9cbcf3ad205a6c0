// Decode attention: the kernel body shared by the paged and the dense decode
// kernels (paged_decode.cu, dense_decode.cu), templated on the query dtype,
// the KV storage and an addressing policy.
//
//   q (B, L, H, D); pos (B,) int32, the position of q[:, 0]; out (B, L, H, D)
//   in q's dtype.  Query l of row b sits at qpos = pos[b] + l and attends
//   keys t <= qpos (masked-causal inside an L > 1 window).  A dense ring
//   cache (window > 0, L = 1) holds the last positions in S_c slots: a row
//   still inside its first window takes the prefix mask, a wrapped row
//   visits every slot and keeps those whose age (qpos - t) mod S_c is below
//   min(qpos + 1, window), as the JAX package's attention_decode does.
//
// Storage (Store<T, KVC>): KV_RAW pools in the query's dtype (bf16, f32);
// KV_INT8 int8 rows (kv8, 64 bytes at D = 64, read as 16-byte loads);
// KV_NIB packed nibbles (kv4, D/2 bytes a row, even dims in the low nibble,
// two's complement, read as 8-byte loads and sign-extended by shifts).
// Quantized rows carry one float32 scale per (token, kv head) at the row's
// index in a parallel scale array, and dequantize as float(q) * scale, the
// order of the JAX package's KVLayout.dequantize.  The score of a lane's
// key uses that key's K scale; the V pass broadcasts each key's V scale by
// shuffle beside its row index.
//
// Addressing (Addr::row(b, t, kv)): the row index of key t's (kv head) row,
// in rows of D/pack storage elements (and in scales).  PagedAddr reads the
// block table: ((table[b, t / bs] * bs + t % bs) * KV + kv).  DenseAddr is
// ((b * S_c + t) * KV + kv).
//
// What bounds it on the H100: bytes (each live K/V row is read once per kv
// head; ~2 flops per byte in bf16, ~4 per byte in kv8 and ~8 in kv4).
//
// Design.  One block per (query-row tile, kv head, batch row).  The G query
// heads of a kv head and the L window positions make L*G query rows (l, j),
// head = kv*G + j; a tile holds LT = min(L, 32/G) window positions, at most
// 32 rows, so any L runs as ceil(L/LT) tiles.  A row's keys 0 .. t_end are
// split across W = 32 / (LT*G) warps in contiguous 32-aligned shares; each
// warp takes 32 keys at a time, one key per lane: the lane reads its K row
// and computes the full score, the warp shares max and sum by shuffles,
// then accumulates p * V row by row with lanes on neighbouring dims.  The W
// partial (m, l, acc) states of a row merge in shared memory at the end.
// The arithmetic is pinned with explicit round-to-nearest intrinsics, so the
// two addressing policies, which split keys across warps identically, give
// bit-identical outputs on identical keys (a paged pool whose table is the
// identity against the matching dense cache).  A 32-key chunk in which no
// key is valid yet leaves the state untouched; a row with no valid key
// writes 0.  Rows of the last tile past L read no key and write nothing.
#pragma once

#include "common.cuh"

namespace decode_attn {

constexpr int MAXW = 32;  // warps per block
constexpr int KV_RAW = 0;
constexpr int KV_INT8 = 1;
constexpr int KV_NIB = 2;

// Byte i (0..3) of w, sign-extended.
__device__ __forceinline__ int sext8(unsigned w, int i) {
  return static_cast<int>(w << (24 - 8 * i)) >> 24;
}
// Nibble i (0..7) of w, sign-extended.
__device__ __forceinline__ int sext4(unsigned w, int i) {
  return static_cast<int>(w << (28 - 4 * i)) >> 28;
}

// q[0..3] . k[0..3] as a product and three fused multiply-adds, in a fixed
// order: the score adds one such group of 4 dims at a time.
__device__ __forceinline__ float dot4(const float* q, const float* k) {
  float g = __fmul_rn(q[0], k[0]);
  g = __fmaf_rn(q[1], k[1], g);
  g = __fmaf_rn(q[2], k[2], g);
  return __fmaf_rn(q[3], k[3], g);
}

template <typename T, int KVC>
struct Store;

template <typename T>
struct Store<T, KV_RAW> {
  using E = T;
  static constexpr bool kQuant = false;
  static constexpr int kPack = 1;
  template <int D>
  __device__ static float dot(const E* row, const float* qs, float) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float kx[4];
      load4(row + d, kx);
      acc = __fadd_rn(acc, dot4(qs + d, kx));
    }
    return acc;
  }
  __device__ static float val(const E* row, int d, float) { return to_f32(row[d]); }
};

template <typename T>
struct Store<T, KV_INT8> {
  using E = int8_t;
  static constexpr bool kQuant = true;
  static constexpr int kPack = 1;
  template <int D>
  __device__ static float dot(const E* row, const float* qs, float sc) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 16) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + d);
      const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        float kx[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          kx[i] = __fmul_rn(static_cast<float>(sext8(ws[j >> 2], i)), sc);
        acc = __fadd_rn(acc, dot4(qs + d + j, kx));
      }
    }
    return acc;
  }
  __device__ static float val(const E* row, int d, float sc) {
    return __fmul_rn(static_cast<float>(row[d]), sc);
  }
};

template <typename T>
struct Store<T, KV_NIB> {
  using E = uint8_t;
  static constexpr bool kQuant = true;
  static constexpr int kPack = 2;
  template <int D>
  __device__ static float dot(const E* row, const float* qs, float sc) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 16) {  // 16 dims = 8 bytes
      const uint2 w = *reinterpret_cast<const uint2*>(row + d / 2);
      const unsigned ws[2] = {w.x, w.y};
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        float kx[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          kx[i] = __fmul_rn(static_cast<float>(sext4(ws[j >> 3], (j & 7) + i)), sc);
        acc = __fadd_rn(acc, dot4(qs + d + j, kx));
      }
    }
    return acc;
  }
  __device__ static float val(const E* row, int d, float sc) {
    const unsigned byte = static_cast<unsigned>(row[d >> 1]);
    const int x = static_cast<int>(byte << (28 - 4 * (d & 1))) >> 28;
    return __fmul_rn(static_cast<float>(x), sc);
  }
};

struct PagedAddr {
  const int* table;
  int nb, bs, kvh;
  __device__ __forceinline__ long long row(int b, int t, int kv) const {
    const int page = table[static_cast<size_t>(b) * nb + t / bs];
    return (static_cast<long long>(page) * bs + t % bs) * kvh + kv;
  }
};

struct DenseAddr {
  int s_c, kvh;
  __device__ __forceinline__ long long row(int b, int t, int kv) const {
    return (static_cast<long long>(b) * s_c + t) * kvh + kv;
  }
};

// At most 32 registers a thread, so two 1024-thread blocks fit an SM: wide
// windows (many tiles) need the warps to hide the latency of the key walk.
// RING instantiates the ring-window mask (dense caches with window > 0
// only), so the full-attention kernels carry none of its state.
template <typename T, int KVC, int D, bool RING, typename Addr>
__global__ void __launch_bounds__(1024, 2)
decode_kernel(const T* __restrict__ q, const typename Store<T, KVC>::E* __restrict__ k,
              const typename Store<T, KVC>::E* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, Addr addr, const int* __restrict__ pos,
              T* __restrict__ out, int L, int lt, int h, int kvh, int parts, float scale,
              int t_cap, int window, int s_c) {
  using S = Store<T, KVC>;
  using E = typename S::E;
  constexpr int DS = D / S::kPack;    // storage elements per K/V row
  constexpr int DPL = (D + 31) / 32;  // accumulator dims per lane
  const float NEG_INF = __int_as_float(0xff800000);
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
  // A wrapped ring row visits every slot and masks by age; any other row
  // walks keys 0 .. qpos.
  const bool ring = RING && window > 0 && qpos >= window;
  const int ring_n = min(qpos + 1, window);
  const int t_end = !live ? -1 : ring ? t_cap : min(qpos, t_cap);

  if (part == 0 && live) {
    for (int d = lane; d < D; d += 32)
      qs[qrow][d] = __fmul_rn(to_f32(q[((static_cast<size_t>(b) * L + l) * h + head) * D + d]),
                              scale);
  }
  __syncthreads();

  // This warp's contiguous, 32-aligned share of keys 0 .. t_end.
  const int chunks = (t_end + 1 + 31) / 32;
  const int per = ((chunks + parts - 1) / parts) * 32;
  const int t_lo = part * per;
  const int t_hi = min(t_end + 1, t_lo + per);

  float m = NEG_INF;
  float lsum = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int t0 = t_lo; t0 < t_hi; t0 += 32) {
    const int t = t0 + lane;
    bool valid = t < t_hi;
    if (valid && ring) {
      int age = (qpos - t) % s_c;
      if (age < 0) age += s_c;
      valid = age < ring_n;
    }
    long long r = 0;  // row index of key t's (kv head) row
    float s = NEG_INF;
    float vsc = 1.f;
    if (valid) {
      r = addr.row(b, t, kv);
      float ksc = 1.f;
      if (S::kQuant) {
        ksc = ks[r];
        vsc = vs[r];
      }
      s = S::template dot<D>(k + r * DS, &qs[qrow][0], ksc);
    }
    const float m_new = fmaxf(m, warp_max(s));
    // A ring chunk with no valid key yet (warp-uniform) leaves the state
    // unchanged; without a ring, lane 0 of a chunk is always valid.
    if (RING && m_new == NEG_INF) continue;
    const float corr = expf(m - m_new);
    const float p = valid ? expf(s - m_new) : 0.f;
    lsum = __fmaf_rn(lsum, corr, warp_sum(p));
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = __fmul_rn(acc[i], corr);
    const int n = min(32, t_hi - t0);
    for (int c = 0; c < n; ++c) {
      // Only a wrapped ring row has masked keys inside its range (ring is
      // uniform over the warp: one warp serves one query row).
      if (ring && !__shfl_sync(0xffffffffu, static_cast<int>(valid), c)) continue;
      const float pc = __shfl_sync(0xffffffffu, p, c);
      const long long rc = __shfl_sync(0xffffffffu, r, c);
      const float vc = S::kQuant ? __shfl_sync(0xffffffffu, vsc, c) : 1.f;
      const E* vrow = v + rc * DS;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = __fmaf_rn(pc, S::val(vrow, d, vc), acc[i]);
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
  if (mx == NEG_INF) mx = 0.f;  // no valid key: every weight below is 0
  float den = 0.f;
  for (int p = 0; p < parts; ++p) den = __fmaf_rn(ls[w0 + p], expf(ms[w0 + p] - mx), den);
  const float inv = den > 0.f ? __frcp_rn(den) : 0.f;
  T* o = out + ((static_cast<size_t>(b) * L + l) * h + head) * D;
  for (int d = lane; d < D; d += 32) {
    float a = 0.f;
    for (int p = 0; p < parts; ++p) a = __fmaf_rn(accs[w0 + p][d], expf(ms[w0 + p] - mx), a);
    o[d] = from_f32<T>(__fmul_rn(a, inv));
  }
}

// Runtime arguments of one launch.  t_cap: the last key index a row may
// read (paged: NB*bs - 1, dense: S_c - 1).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pos;
  void* out;
  int b, L, h, kvh, t_cap, window, s_c;
  float scale;
};

template <typename T, int KVC, int D, bool RING, typename Addr>
int launch(const Args& a, const Addr& addr, cudaStream_t stream) {
  using E = typename Store<T, KVC>::E;
  const int g = a.h / a.kvh;
  const int lt = min(a.L, MAXW / g);  // window positions per tile
  const int rows = lt * g;            // query rows per tile, at most MAXW
  const int parts = MAXW / rows;
  const dim3 grid(a.kvh, a.b, (a.L + lt - 1) / lt);
  const dim3 block(rows * parts * 32);
  decode_kernel<T, KVC, D, RING, Addr><<<grid, block, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const E*>(a.k), static_cast<const E*>(a.v), a.ks,
      a.vs, addr, a.pos, static_cast<T*>(a.out), a.L, lt, a.h, a.kvh, parts, a.scale, a.t_cap,
      a.window, a.s_c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KVC, bool RING, typename Addr>
int launch_d(int d, const Args& a, const Addr& addr, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, KVC, 16, RING>(a, addr, s);
    case 32: return launch<T, KVC, 32, RING>(a, addr, s);
    case 64: return launch<T, KVC, 64, RING>(a, addr, s);
    case 128: return launch<T, KVC, 128, RING>(a, addr, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool RING, typename Addr>
int launch_kv(int kv, int d, const Args& a, const Addr& addr, cudaStream_t s) {
  if constexpr (RING) {  // ring windows take unquantized caches only
    return kv == KV_RAW ? launch_d<T, KV_RAW, true>(d, a, addr, s)
                        : static_cast<int>(cudaErrorInvalidValue);
  } else {
    switch (kv) {
      case KV_RAW: return launch_d<T, KV_RAW, false>(d, a, addr, s);
      case KV_INT8: return launch_d<T, KV_INT8, false>(d, a, addr, s);
      case KV_NIB: return launch_d<T, KV_NIB, false>(d, a, addr, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

// Validate and launch: dtype is the query's (DTYPE_F32 / DTYPE_BF16), kv the
// storage code (KV_RAW pools share the query's dtype); RING for a dense
// cache with window > 0.
template <bool RING, typename Addr>
int launch_any(int dtype, int kv, int d, const Args& a, const Addr& addr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.b < 1 || a.kvh < 1 || a.h % a.kvh != 0 || a.h / a.kvh > MAXW || a.L < 1 ||
      a.L > 65535 || a.t_cap < 0 || (kv != KV_RAW && (a.ks == nullptr || a.vs == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == DTYPE_BF16) return launch_kv<bf16, RING>(kv, d, a, addr, s);
  if (dtype == DTYPE_F32) return launch_kv<float, RING>(kv, d, a, addr, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace decode_attn
