// Attention over a KV cache: the kernel body shared by the paged and the
// dense decode kernels and by flash prefill (paged_decode.cu,
// dense_decode.cu, flash_prefill.cu), templated on the query dtype, the KV
// storage and an addressing policy.
//
//   q (B, L, H, D); pos (B,) int32, the position of q[:, 0] (or one scalar
//   position pos0 for every row: pos == nullptr); out (B, L, H, D) in q's
//   dtype.  Query l of row b sits at qpos = pos[b] + l and attends keys
//   t <= qpos (masked-causal inside an L > 1 window; every key up to the
//   cap when !causal).  A dense ring cache (RING: window > 0, L = 1) holds
//   the last positions in S_c slots: a row still inside its first window
//   takes the prefix mask, a wrapped row visits every slot and keeps those
//   whose age (qpos - t) mod S_c is below min(qpos + 1, window), as the JAX
//   package's attention_decode does.  Without RING, window > 0 is prefill's
//   sliding band at any L: keys t > qpos - window, and key tiles wholly
//   below the band of every row of a query tile are never staged.
//
// Storage (Store<T, KVC>): KV_RAW pools in the query's dtype (bf16, f32);
// KV_INT8 int8 rows (kv8); KV_NIB packed nibbles (kv4, D/2 bytes a row, even
// dims in the low nibble, two's complement, sign-extended by shifts).
// Quantized rows carry one float32 scale per (token, kv head) at the row's
// index in a parallel scale array, and dequantize as float(q) * scale, the
// order of the JAX package's KVLayout.dequantize.
//
// Addressing (Addr::row(b, t, kv)): the row index of key t's (kv head) row,
// in rows of D/pack storage elements (and in scales).  PagedAddr reads the
// block table: ((table[b, t / bs] * bs + t % bs) * KV + kv).  DenseAddr is
// ((b * S_c + t) * KV + kv).
//
// What bounds it on the H100: bytes.  Each live K/V row must be read once
// per kv head (~2 flops per byte in bf16, ~4 in kv8, ~8 in kv4, far below
// the card's ~295); at the serving shapes (B = 4, KV = 8, ~1750 live keys)
// that is 3.6 MB, ~1 us at 3.35 TB/s, so a launch is latency-bound: what
// counts is how many SMs work and how long each one's chain of loads is.
//
// Design.  The G query heads of a kv head and the L window positions make
// L*G query rows r = l*G + j (head kv*G + j); a tile holds QT = 64 of them.
// One block of 128 threads per (key split, row tile, batch row x kv head):
//   1. Split keys across blocks (flash-decoding).  The host's plan
//      (kernels/attn.py: decode_split_plan) gives the split count from
//      (B, KV, tiles, the key bound) so that the grid holds >= 264 blocks
//      (two per SM) where there are keys enough.  A block divides its
//      tile's live keys first .. t_end (first: 0, or the 64-aligned start
//      of a prefill band) evenly over the splits in 64-key-aligned
//      ranges (decode_split_range mirrors the arithmetic), so the split
//      depends on key indices and positions only, never on pages: the two
//      addressing policies run the same blocks on the same keys and, every
//      sum being pinned (round-to-nearest intrinsics, tensor-core products
//      in a fixed order), give bit-identical outputs on identical keys (a
//      paged pool whose table is the identity against the matching dense
//      cache).  With more than one split each block writes its partial
//      (m, l, acc) to f32 scratch; the last block of a (row, kv head, tile)
//      to finish -- an atomic counter after __threadfence() tells it --
//      merges all partials in split-index order (deterministic) and resets
//      the counter to 0, all in the one launch.
//   2. Stage K/V in shared memory, shared by every query row of the block.
//      64-key tiles of K and V rows (and their scales) arrive by 16-byte
//      cp.async into a double buffer; the table lookups and copies of the
//      next tile are issued before the current one is computed.  Rows are
//      padded by one copy chunk so that the row-per-lane reads below are
//      free of bank conflicts.  Keys no row of the tile attends are
//      zero-filled, never read.
//   3. Tensor cores for bf16 windows of L*G >= 16 rows (no ring; a bf16
//      prefill of Sq*G >= 16 rows takes this path too): each warp
//      owns 16 query rows; S = Q K^T and O = P V run as mma.sync m16n8k16
//      (bf16 in, f32 accumulate) on the staged tiles, a flash-attention
//      tile over the page table (online softmax in registers, P rounded to
//      bf16 for the second product, its row sums from the rounded values).
//      kv8/kv4 tiles enter the products as their integer codes, which bf16
//      holds exactly: each key's scale multiplies its f32 score after Q K^T,
//      and each value's scale its weight p before p is rounded to bf16 for
//      P V (the row sums then from the unrounded f32 p), so the only bf16
//      rounding is P's, as in the unquantized path.
//   4. CUDA cores otherwise (f32 queries, whose 1e-4 tolerance and token
//      identity need f32 products; L*G < 16, e.g. plain decode at G = 4;
//      ring windows; head dim 256): scores of (row, key) pairs from the
//      staged rows, one warp per row for the online softmax, then acc += p
//      * V with a thread per (row, dim), or at D = 256 two dims (d, d +
//      128) of every row per thread.
//   Head dim 256 (RecurrentGemma's local attention) takes the CUDA cores in
//   bf16 too: the tensor-core tile would hold 128 f32 accumulators and 64
//   Q fragment registers a thread.  Its staged tiles are 528-byte (bf16) or
//   1040-byte (f32) rows: double-buffered bf16 K/V tiles (132 KB) and the
//   f32 query, score and state rows of 64 query rows (81 KB) fit the 227 KB
//   of an SM; in f32 the K/V tiles take one buffer (130 KB), copied after
//   the tile before it is consumed (NBUF, below).
// What each part does about the limits of a key walk by one warp per query
// row: the split fills the card where one block per (tile, kv, b) would
// not (32 blocks at L = 1, B = 4, on 132 SMs; the split makes 512);
// staging replaces each lane's dependent table-then-row loads by coalesced
// copies issued a tile ahead; one staged tile serves all 64 rows of the
// block, so no row re-reads a key another row of its tile has read; and
// the tensor cores replace the per-key shuffle rounds of the V pass on
// the wide windows.  The merge reads the partials with the loads of a
// split in flight together (row weights first, then float4 sums).
//
// Numerics: a row with no valid key writes 0, never NaN; a key tile with
// no valid key for a row leaves that row's state untouched; rows of the
// last tile past L*G read no key and write nothing.
#pragma once

#include "common.cuh"

// Internal linkage: each entry's library keeps its own instantiations (and
// their function-local statics, such as the shared-memory opt-in flags),
// which would otherwise be merged process-wide as GNU-unique symbols when
// two libraries instantiate the same template.
namespace {
namespace decode_attn {

constexpr int NT = 128;    // threads a block (4 warps)
constexpr int QT = 64;     // query rows a tile (16 per warp on the tensor cores)
constexpr int KT = 64;     // keys a staged tile; split ranges are multiples of it
constexpr int MAXG = 32;   // query heads per kv head
constexpr int MAXS = 64;   // key splits (kernels/attn.py: DECODE_MAX_SPLITS)
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

// A staged row: dot(row, qs) of the dequantized row against D f32 query
// values, and the dequantized element d.
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

// ---------------------------------------------------------------------------
// Copies and tensor-core primitives

// N-byte asynchronous copy global -> shared; zero-fills the N bytes when
// !full (nothing is read then).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = full ? N : 0;
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(N),
                 "r"(n));
  }
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most one copy group (the newest) is in flight.
__device__ __forceinline__ void cp_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }
// Wait until no copy group is in flight.
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma16816(float* c, const unsigned* a, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory, transposed (B fragments of a
// row-major [key][dim] tile).
__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// ---------------------------------------------------------------------------
// Shared-memory geometry of one instantiation (host and device).

template <typename T, int KVC, int D, bool TC>
struct Geo {
  using S = Store<T, KVC>;
  using E = typename S::E;
  static constexpr int RB = D * static_cast<int>(sizeof(E)) / S::kPack;  // bytes a row
  static constexpr int CH = RB < 16 ? RB : 16;                         // copy chunk
  static constexpr int NCH = RB / CH;                                  // chunks a row
  static constexpr int SRB = RB + CH;       // padded staged row (bank-conflict free)
  static constexpr int SB = D + 8;          // bf16 elements a tensor-core row
  static constexpr int STAGE = KT * SRB;    // one K or V tile
  static constexpr bool DEQ = TC && S::kQuant;  // dequantized bf16 tiles
  // [K buf 0 (, K buf 1), V buf 0 (, V buf 1)] [K scales x NBUF, V scales x
  // NBUF] [TC kv8/kv4: Kb, Vb bf16] [CUDA cores: qs, scores, m, l, corr]
  static constexpr int BYTES_TC = DEQ ? 2 * KT * SB * 2 : 0;
  static constexpr int BUF = 2 * STAGE + (S::kQuant ? 2 * KT * 4 : 0);  // K, V + scales
  // Double-buffered K/V tiles where 64 query rows fit beside them in an
  // SM's 227 KB, else one buffer (f32 at D = 256).
  static constexpr int SMEM_MAX = 227 * 1024;
  static constexpr int NBUF =
      2 * BUF + BYTES_TC + (TC ? 0 : (QT * D + QT * (KT + 1) + 3 * QT) * 4) <= SMEM_MAX ? 2 : 1;
  static constexpr int OFF_SC = 2 * NBUF * STAGE;
  static constexpr int OFF_X = NBUF * BUF;
  // Sized by the launch's rows a tile (qt = min(64, L*G)): a decode step's
  // 4 rows leave room for more blocks on an SM.  The merge reuses it all.
  __host__ __device__ static constexpr int bytes(int qt) {
    const int run = OFF_X + BYTES_TC + (TC ? 0 : (qt * D + qt * (KT + 1) + 3 * qt) * 4);
    const int merge = (qt * MAXS + qt) * 4;
    return run > merge ? run : merge;
  }
};

// Runtime arguments of one launch.  t_cap: the last key index a row may
// read (paged: NB*bs - 1, dense: S_c - 1).  part/cnt: f32 scratch for the
// partial states and one int counter per (b, kv, tile), both unused when
// splits == 1.  pos0: every row's position when pos is null.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pos;
  void* out;
  float* part;
  int* cnt;
  int L, h, kvh, g, t_cap, window, s_c, splits, kps, tiles, qt;
  float scale;
  int pos0, causal;
};

// ---------------------------------------------------------------------------
// The kernel

template <typename T, int KVC, int D, bool RING, bool TC, typename Addr>
__global__ void __launch_bounds__(NT)
decode_kernel(const Params p, const Addr addr) {
  using S = Store<T, KVC>;
  using E = typename S::E;
  using Gm = Geo<T, KVC, D, TC>;
  static_assert(!TC || (sizeof(T) == 2 && !RING), "tensor cores take bf16 full attention");
  const float NEG_INF = __int_as_float(0xff800000);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last_block;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int split = blockIdx.x;
  const int tile = blockIdx.y;
  const int bk = blockIdx.z;
  const int b = bk / p.kvh;
  const int kv = bk % p.kvh;
  const int rows = p.L * p.g;
  const int r0 = tile * QT;                 // first query row of the tile
  const int R = min(QT, rows - r0);         // its live rows
  const int pos_b = p.pos ? p.pos[b] : p.pos0;
  // A wrapped ring row (L = 1: the tile's one position) visits every slot
  // and masks by age; a causal row walks keys 0 .. qpos (from qpos -
  // window + 1 in a prefill band), a non-causal one every key to the cap.
  const bool ring = RING && p.window > 0 && pos_b >= p.window;
  const bool band = !RING && p.window > 0;
  const int ring_n = min(pos_b + 1, p.window);
  auto ring_ok = [&](int t) {
    int age = (pos_b - t) % p.s_c;
    if (age < 0) age += p.s_c;
    return age < ring_n;
  };
  auto t_end_of = [&](int r) {  // last key of tile row r (r < R); rows rise with r
    return ring || !p.causal ? p.t_cap : min(pos_b + (r0 + r) / p.g, p.t_cap);
  };
  auto t_beg_of = [&](int r) {  // first key of tile row r (may be negative)
    return band ? pos_b + (r0 + r) / p.g - p.window + 1 : 0;
  };
  const int n_live = t_end_of(R - 1) + 1;
  const int first = band ? max(0, t_beg_of(0)) / KT * KT : 0;
  // This split's keys: the tile's live keys first .. n_live - 1 cut into
  // `splits` 64-aligned ranges (kernels/attn.py: decode_split_range).
  const int chunks = n_live > first ? (n_live - first + KT - 1) / KT : 0;
  const int per = min(p.kps, ((chunks + p.splits - 1) / p.splits) * KT);
  const int lo = first + split * per;
  const int hi = min(n_live, lo + per);
  const int ntile = lo < hi ? (hi - lo + KT - 1) / KT : 0;

  unsigned char* stage_k = smem;
  unsigned char* stage_v = smem + Gm::NBUF * Gm::STAGE;
  float* sc_k = reinterpret_cast<float*>(smem + Gm::OFF_SC);
  float* sc_v = sc_k + Gm::NBUF * KT;
  const unsigned char* kbase = static_cast<const unsigned char*>(p.k);
  const unsigned char* vbase = static_cast<const unsigned char*>(p.v);

  // Issue the copies of key tile i (keys lo + i*KT ..) into buffer i % NBUF.
  auto stage = [&](int i) {
    const int t0 = lo + i * KT;
    const int buf = i % Gm::NBUF;
    for (int c = tid; c < KT * Gm::NCH; c += NT) {
      const int kk = c / Gm::NCH;
      const int part = c % Gm::NCH;
      const int t = t0 + kk;
      const bool need = t < hi && (!ring || ring_ok(t));
      const long long row = need ? addr.row(b, t, kv) : 0;
      const size_t dst = static_cast<size_t>(buf) * Gm::STAGE + kk * Gm::SRB + part * Gm::CH;
      const long long src = row * Gm::RB + part * Gm::CH;
      cp_async<Gm::CH>(stage_k + dst, kbase + src, need);
      cp_async<Gm::CH>(stage_v + dst, vbase + src, need);
    }
    if constexpr (S::kQuant) {
      for (int kk = tid; kk < KT; kk += NT) {
        const int t = t0 + kk;
        const bool need = t < hi && (!ring || ring_ok(t));
        const long long row = need ? addr.row(b, t, kv) : 0;
        cp_async<4>(sc_k + buf * KT + kk, p.ks + row, need);
        cp_async<4>(sc_v + buf * KT + kk, p.vs + row, need);
      }
    }
  };

  // Partial states: ml[(pidx * 2 + 0/1) * qt + r] = m / l; acc after them.
  const size_t pbase = (static_cast<size_t>(bk) * p.tiles + tile) * p.splits;
  const size_t nparts = static_cast<size_t>(gridDim.z) * p.tiles * p.splits;
  float* part_ml = p.part;
  float* part_acc = p.part + nparts * 2 * p.qt;
  T* out = static_cast<T*>(p.out);
  const T* q = static_cast<const T*>(p.q);
  auto out_at = [&](int r) {  // output row of tile row r
    const int rg = r0 + r;
    const int l = rg / p.g;
    const int head = kv * p.g + rg % p.g;
    return out + ((static_cast<size_t>(b) * p.L + l) * p.h + head) * D;
  };
  auto q_at = [&](int r) {
    const int rg = r0 + r;
    const int l = rg / p.g;
    const int head = kv * p.g + rg % p.g;
    return q + ((static_cast<size_t>(b) * p.L + l) * p.h + head) * D;
  };

  if (ntile > 0) stage(0);
  cp_commit();
  // Tile i staged and visible to the block: with two buffers the copies of
  // tile i + 1 go out first; with one they wait for tile_done(i).
  auto tile_ready = [&](int i) {
    if constexpr (Gm::NBUF == 2) {
      if (i + 1 < ntile) stage(i + 1);
      cp_commit();
      cp_wait_prev();
    } else {
      cp_wait_all();
    }
    __syncthreads();
  };
  auto tile_done = [&](int i) {  // every thread is past tile i
    __syncthreads();
    if constexpr (Gm::NBUF == 1) {
      if (i + 1 < ntile) stage(i + 1);
      cp_commit();
    }
  };

  if constexpr (TC) {
    // ---------------- tensor cores: warp w owns tile rows 16w .. 16w+15
    const int g4 = lane >> 2;  // fragment row (and +8)
    const int q4 = lane & 3;   // fragment column pair
    const int ra = warp * 16 + g4;
    const int rb = ra + 8;
    const bool active = warp * 16 < R;
    const int te_a = ra < R ? t_end_of(ra) : -1;
    const int te_b = rb < R ? t_end_of(rb) : -1;
    const int tb_a = ra < R ? t_beg_of(ra) : 0;
    const int tb_b = rb < R ? t_beg_of(rb) : 0;
    unsigned qa[D / 16][4];
    {
      const T* qra = ra < R ? q_at(ra) : nullptr;
      const T* qrb = rb < R ? q_at(rb) : nullptr;
      auto ld = [](const T* row, int d) -> unsigned {
        return row ? *reinterpret_cast<const unsigned*>(row + d) : 0u;
      };
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qa[kk][0] = ld(qra, kk * 16 + 2 * q4);
        qa[kk][1] = ld(qrb, kk * 16 + 2 * q4);
        qa[kk][2] = ld(qra, kk * 16 + 8 + 2 * q4);
        qa[kk][3] = ld(qrb, kk * 16 + 8 + 2 * q4);
      }
    }
    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float lsum[2] = {0.f, 0.f};
    bf16* kb = reinterpret_cast<bf16*>(smem + Gm::OFF_X);
    bf16* vb = kb + KT * Gm::SB;

    for (int i = 0; i < ntile; ++i) {
      tile_ready(i);
      const int buf = i % Gm::NBUF;
      const int t0 = lo + i * KT;
      const bf16* kt;
      const bf16* vt;
      if constexpr (Gm::DEQ) {
        const E* sk = reinterpret_cast<const E*>(stage_k + buf * Gm::STAGE);
        const E* sv = reinterpret_cast<const E*>(stage_v + buf * Gm::STAGE);
        constexpr int ROW_E = Gm::SRB / static_cast<int>(sizeof(E));
        for (int e = tid; e < KT * (D / 2); e += NT) {  // the codes, exact in bf16
          const int kk = e / (D / 2);
          const int d = (e % (D / 2)) * 2;
          const E* rk = sk + kk * ROW_E;
          const E* rv = sv + kk * ROW_E;
          *reinterpret_cast<unsigned*>(kb + kk * Gm::SB + d) =
              pack_bf16(S::val(rk, d, 1.f), S::val(rk, d + 1, 1.f));
          *reinterpret_cast<unsigned*>(vb + kk * Gm::SB + d) =
              pack_bf16(S::val(rv, d, 1.f), S::val(rv, d + 1, 1.f));
        }
        __syncthreads();
        kt = kb;
        vt = vb;
      } else {
        kt = reinterpret_cast<const bf16*>(stage_k + buf * Gm::STAGE);
        vt = reinterpret_cast<const bf16*>(stage_v + buf * Gm::STAGE);
      }
      if (active) {
        float s[KT / 8][4];
#pragma unroll
        for (int n = 0; n < KT / 8; ++n) {
          s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
          const bf16* krow = kt + (n * 8 + g4) * Gm::SB + 2 * q4;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const unsigned b0 = *reinterpret_cast<const unsigned*>(krow + kk * 16);
            const unsigned b1 = *reinterpret_cast<const unsigned*>(krow + kk * 16 + 8);
            mma16816(s[n], qa[kk], b0, b1);
          }
        }
        // Scale and mask; the tile's row maxima (a row's 64 scores lie in
        // the 4 lanes of a quad).
        float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = t0 + n * 8 + 2 * q4 + (e & 1);
            const int te = e < 2 ? te_a : te_b;
            const int tb = e < 2 ? tb_a : tb_b;
            float qk = s[n][e];
            if constexpr (Gm::DEQ) qk = __fmul_rn(qk, sc_k[buf * KT + (t - t0)]);  // key's scale
            const float x = (t < hi && t <= te && t >= tb) ? __fmul_rn(qk, p.scale) : NEG_INF;
            s[n][e] = x;
            mt[e >> 1] = fmaxf(mt[e >> 1], x);
          }
        }
        float corr[2];
        float mu[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 1));
          mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 2));
          const float m_new = fmaxf(m[hh], mt[hh]);
          // No valid key yet: the state stays as it is (p = 0 below).
          corr[hh] = m_new == NEG_INF ? 1.f : expf(m[hh] - m_new);
          mu[hh] = m_new == NEG_INF ? 0.f : m_new;
          m[hh] = m_new;
        }
        // P in bf16 (A fragments of the second product) and its row sums;
        // kv8/kv4: p times its value's scale, the sums from the f32 p.
        unsigned pa[KT / 16][4];
        float ps[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < KT / 8; ++n) {
          const float p0 = expf(s[n][0] - mu[0]);
          const float p1 = expf(s[n][1] - mu[0]);
          const float p2 = expf(s[n][2] - mu[1]);
          const float p3 = expf(s[n][3] - mu[1]);
          unsigned w0, w1;
          if constexpr (Gm::DEQ) {
            const float v0 = sc_v[buf * KT + n * 8 + 2 * q4];
            const float v1 = sc_v[buf * KT + n * 8 + 2 * q4 + 1];
            w0 = pack_bf16(__fmul_rn(p0, v0), __fmul_rn(p1, v1));
            w1 = pack_bf16(__fmul_rn(p2, v0), __fmul_rn(p3, v1));
            ps[0] = __fadd_rn(ps[0], __fadd_rn(p0, p1));
            ps[1] = __fadd_rn(ps[1], __fadd_rn(p2, p3));
          } else {
            w0 = pack_bf16(p0, p1);
            w1 = pack_bf16(p2, p3);
            const float2 f0 = unpack_bf16(w0);
            const float2 f1 = unpack_bf16(w1);
            ps[0] = __fadd_rn(ps[0], __fadd_rn(f0.x, f0.y));
            ps[1] = __fadd_rn(ps[1], __fadd_rn(f1.x, f1.y));
          }
          pa[n >> 1][(n & 1) * 2 + 0] = w0;
          pa[n >> 1][(n & 1) * 2 + 1] = w1;
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) lsum[hh] = __fmaf_rn(lsum[hh], corr[hh], ps[hh]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[n][0] = __fmul_rn(o[n][0], corr[0]);
          o[n][1] = __fmul_rn(o[n][1], corr[0]);
          o[n][2] = __fmul_rn(o[n][2], corr[1]);
          o[n][3] = __fmul_rn(o[n][3], corr[1]);
        }
        // O += P V: B fragments by ldmatrix.trans, two dim tiles a load.
        const int vkey = (lane & 7) + ((lane >> 3) & 1) * 8;
        const int vdim = (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < KT / 16; ++j) {
#pragma unroll
          for (int n = 0; n < D / 8; n += 2) {
            unsigned vf[4];
            ldsm_x4_t(vf, vt + (j * 16 + vkey) * Gm::SB + n * 8 + vdim);
            mma16816(o[n], pa[j], vf[0], vf[1]);
            mma16816(o[n + 1], pa[j], vf[2], vf[3]);
          }
        }
      }
      tile_done(i);
    }

    // Each row's sum lies in the 4 lanes of its quad.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      lsum[hh] = __fadd_rn(lsum[hh], __shfl_xor_sync(0xffffffffu, lsum[hh], 1));
      lsum[hh] = __fadd_rn(lsum[hh], __shfl_xor_sync(0xffffffffu, lsum[hh], 2));
    }
    if (p.splits == 1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = hh ? rb : ra;
        if (r >= R) continue;
        const float inv = lsum[hh] > 0.f ? __frcp_rn(lsum[hh]) : 0.f;
        T* orow = out_at(r);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<unsigned*>(orow + n * 8 + 2 * q4) =
              pack_bf16(__fmul_rn(o[n][2 * hh], inv), __fmul_rn(o[n][2 * hh + 1], inv));
        }
      }
      return;
    }
    const size_t pidx = pbase + split;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = hh ? rb : ra;
      if (r >= R) continue;
      if (q4 == 0) {
        part_ml[(pidx * 2) * p.qt + r] = m[hh];
        part_ml[(pidx * 2 + 1) * p.qt + r] = lsum[hh];
      }
      if (m[hh] == NEG_INF) continue;  // the merge reads no acc of such a row
      float* arow = part_acc + (pidx * p.qt + r) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<float2*>(arow + n * 8 + 2 * q4) =
            make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
      }
    }
  } else {
    // ---------------- CUDA cores
    float* qs = reinterpret_cast<float*>(smem + Gm::OFF_X);  // [qt][D], scaled
    float* ss = qs + p.qt * D;                                // [qt][KT + 1]
    float* rm = ss + p.qt * (KT + 1);
    float* rl = rm + p.qt;
    float* rc = rl + p.qt;
    for (int e = tid; e < R * D; e += NT) {
      const int r = e / D;
      const int d = e % D;
      qs[r * D + d] = __fmul_rn(to_f32(q_at(r)[d]), p.scale);
    }
    for (int r = tid; r < R; r += NT) {
      rm[r] = NEG_INF;
      rl[r] = 0.f;
    }
    // acc: thread owns dims d_own + NT*j (j < DPT) of rows rb0 + STEP*i.
    constexpr int DPT = D > NT ? D / NT : 1;    // dims a thread (2 at D = 256)
    constexpr int STEP = D >= NT ? 1 : NT / D;  // threads a dim
    constexpr int NR = QT / STEP;
    const int d_own = tid % D;
    const int rb0 = D >= NT ? 0 : tid / D;
    float acc[NR][DPT];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
    }

    for (int it = 0; it < ntile; ++it) {
      tile_ready(it);
      const int buf = it % Gm::NBUF;
      const int t0 = lo + it * KT;
      const E* sk = reinterpret_cast<const E*>(stage_k + buf * Gm::STAGE);
      const E* sv = reinterpret_cast<const E*>(stage_v + buf * Gm::STAGE);
      constexpr int ROW_E = Gm::SRB / static_cast<int>(sizeof(E));
      // Scores of the tile's (row, key) pairs.
      for (int e = tid; e < R * KT; e += NT) {
        const int r = e / KT;
        const int kk = e % KT;
        const int t = t0 + kk;
        bool valid = t < hi && t <= t_end_of(r) && t >= t_beg_of(r);
        if (valid && ring) valid = ring_ok(t);
        float x = NEG_INF;
        if (valid) {
          x = S::template dot<D>(sk + kk * ROW_E, qs + r * D,
                                 S::kQuant ? sc_k[buf * KT + kk] : 1.f);
        }
        ss[r * (KT + 1) + kk] = x;
      }
      __syncthreads();
      // Online softmax, one warp a row; lanes take keys lane and lane + 32.
      for (int r = warp; r < R; r += NT / 32) {
        const float s0 = ss[r * (KT + 1) + lane];
        const float s1 = ss[r * (KT + 1) + lane + 32];
        const float m_old = rm[r];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
        float corr = 1.f, p0 = 0.f, p1 = 0.f;
        if (m_new != NEG_INF) {  // else no valid key yet: state untouched
          corr = expf(m_old - m_new);
          p0 = expf(s0 - m_new);
          p1 = expf(s1 - m_new);
        }
        const float psum = warp_sum(__fadd_rn(p0, p1));
        ss[r * (KT + 1) + lane] = p0;
        ss[r * (KT + 1) + lane + 32] = p1;
        __syncwarp();
        if (lane == 0) {
          rl[r] = __fmaf_rn(rl[r], corr, psum);
          rm[r] = m_new;
          rc[r] = corr;
        }
      }
      __syncthreads();
      // acc = acc * corr + p . V over the tile's keys (rows rise with i:
      // a thread's live rows end at the first past R, a warp-uniform exit).
      const int kn = min(KT, hi - t0);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = rb0 + STEP * i;
        if (r >= R) break;
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = __fmul_rn(acc[i][j], rc[r]);
      }
      auto vals = [&](int kk, float* vx) {
        const float sc = S::kQuant ? sc_v[buf * KT + kk] : 1.f;
#pragma unroll
        for (int j = 0; j < DPT; ++j) vx[j] = S::val(sv + kk * ROW_E, d_own + NT * j, sc);
      };
      if (rb0 + STEP * (NR - 1) < R) {  // all NR rows live: no exit tests
        for (int kk = 0; kk < kn; ++kk) {
          float vx[DPT];
          vals(kk, vx);
#pragma unroll
          for (int i = 0; i < NR; ++i) {
            const float pk = ss[(rb0 + STEP * i) * (KT + 1) + kk];
#pragma unroll
            for (int j = 0; j < DPT; ++j) acc[i][j] = __fmaf_rn(pk, vx[j], acc[i][j]);
          }
        }
      } else {
        for (int kk = 0; kk < kn; ++kk) {
          float vx[DPT];
          vals(kk, vx);
#pragma unroll
          for (int i = 0; i < NR; ++i) {
            const int r = rb0 + STEP * i;
            if (r >= R) break;
            const float pk = ss[r * (KT + 1) + kk];
#pragma unroll
            for (int j = 0; j < DPT; ++j) acc[i][j] = __fmaf_rn(pk, vx[j], acc[i][j]);
          }
        }
      }
      tile_done(it);
    }
    __syncthreads();  // rm / rl of a split with no tile

    if (p.splits == 1) {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = rb0 + STEP * i;
        if (r >= R) break;
        const float inv = rl[r] > 0.f ? __frcp_rn(rl[r]) : 0.f;
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          out_at(r)[d_own + NT * j] = from_f32<T>(__fmul_rn(acc[i][j], inv));
      }
      return;
    }
    const size_t pidx = pbase + split;
    for (int r = tid; r < R; r += NT) {
      part_ml[(pidx * 2) * p.qt + r] = rm[r];
      part_ml[(pidx * 2 + 1) * p.qt + r] = rl[r];
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = rb0 + STEP * i;
      if (r >= R || rm[r] == NEG_INF) continue;
#pragma unroll
      for (int j = 0; j < DPT; ++j) part_acc[(pidx * p.qt + r) * D + d_own + NT * j] = acc[i][j];
    }
  }

  // ---------------- merge: the last split of (b, kv, tile) to finish
  __threadfence();
  __syncthreads();
  int* counter = p.cnt + static_cast<size_t>(bk) * p.tiles + tile;
  if (tid == 0) last_block = atomicAdd(counter, 1) == p.splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // Row weights first (one thread a row): w[s] = exp(m_s - max m), 0 for a
  // split with no valid key of the row, and 1 / sum_s l_s w_s (0 for a row
  // with no valid key at all, which then writes 0).  The staging buffers
  // are free now; they hold the weights.
  float* ws = reinterpret_cast<float*>(smem);  // [qt][MAXS]
  float* inv = ws + p.qt * MAXS;               // [qt]
  for (int r = tid; r < R; r += NT) {
    const float* mr = part_ml + (pbase * 2) * p.qt + r;  // m of split s: mr[2 s qt]
    float mx = NEG_INF;
#pragma unroll 8
    for (int sp = 0; sp < p.splits; ++sp) mx = fmaxf(mx, __ldcg(mr + 2 * sp * p.qt));
    float den = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < p.splits; ++sp) {
      const float ms = __ldcg(mr + 2 * sp * p.qt);
      const float ls = __ldcg(mr + (2 * sp + 1) * p.qt);
      const float w = ms == NEG_INF ? 0.f : expf(ms - mx);
      den = __fmaf_rn(w != 0.f ? ls : 0.f, w, den);
      ws[r * MAXS + sp] = w;
    }
    inv[r] = den > 0.f ? __frcp_rn(den) : 0.f;
  }
  __syncthreads();
  // Then acc = sum_s w_s acc_s in split order, four dims (one float4) an
  // output and up to MJ outputs a thread at a time (MJ_ALL in passes of 16
  // at D = 256), whose loads of one split are all in flight together (an
  // acc a split left unwritten is masked by its zero weight).
  constexpr int MJ_ALL = QT * D / (4 * NT);
  constexpr int MJ = MJ_ALL < 16 ? MJ_ALL : 16;
  const int n4 = R * D / 4;
  for (int j0 = 0; j0 < MJ_ALL; j0 += MJ) {
    const int e0 = tid + NT * j0;
    if (e0 >= n4) break;
    float4 a[MJ];
#pragma unroll
    for (int j = 0; j < MJ; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < p.splits; ++sp) {
      const float4* src = reinterpret_cast<const float4*>(part_acc + (pbase + sp) * p.qt * D);
      float4 x[MJ];
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        if (e0 + NT * j < n4) x[j] = __ldcg(src + e0 + NT * j);
      }
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const int e4 = e0 + NT * j;
        if (e4 >= n4) break;
        const float w = ws[(e4 * 4 / D) * MAXS + sp];
        const bool on = w != 0.f;
        a[j].x = __fmaf_rn(on ? x[j].x : 0.f, w, a[j].x);
        a[j].y = __fmaf_rn(on ? x[j].y : 0.f, w, a[j].y);
        a[j].z = __fmaf_rn(on ? x[j].z : 0.f, w, a[j].z);
        a[j].w = __fmaf_rn(on ? x[j].w : 0.f, w, a[j].w);
      }
    }
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int e4 = e0 + NT * j;
      if (e4 >= n4) break;
      const int r = e4 * 4 / D;
      const float sc = inv[r];
      T* o = out_at(r) + (e4 * 4) % D;
      o[0] = from_f32<T>(__fmul_rn(a[j].x, sc));
      o[1] = from_f32<T>(__fmul_rn(a[j].y, sc));
      o[2] = from_f32<T>(__fmul_rn(a[j].z, sc));
      o[3] = from_f32<T>(__fmul_rn(a[j].w, sc));
    }
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

// Runtime arguments of one call.  t_cap: the last key index a row may read
// (paged: NB*bs - 1, dense: S_c - 1, prefill: Sk - 1).  splits/kps: the
// host's split plan.  pos0: every row's position when pos is null
// (prefill's q_offset); causal 0: every key to t_cap (prefill only).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pos;
  void* out;
  float* part;
  int* cnt;
  int b, L, h, kvh, t_cap, window, s_c, splits, kps;
  float scale;
  int pos0 = 0;
  int causal = 1;
};

template <typename T, int KVC, int D, bool RING, bool TC, typename Addr>
int launch(const Args& a, const Addr& addr, cudaStream_t stream) {
  using Gm = Geo<T, KVC, D, TC>;
  const int g = a.h / a.kvh;
  const int rows = a.L * g;
  const int tiles = (rows + QT - 1) / QT;
  const Params p{a.q,     a.k,     a.v,      a.ks,     a.vs,     a.pos,   a.out,
                 a.part,  a.cnt,   a.L,      a.h,      a.kvh,    g,       a.t_cap,
                 a.window, a.s_c,  a.splits, a.kps,    tiles,    min(QT, rows), a.scale,
                 a.pos0,  a.causal};
  auto kern = decode_kernel<T, KVC, D, RING, TC, Addr>;
  const int bytes = Gm::bytes(min(QT, rows));
  if (Gm::bytes(QT) > 48 * 1024) {  // opt in once per device, for any qt
    static unsigned long long opted = 0;
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 64 || !(opted >> dev & 1ull)) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::bytes(QT));
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < 64) opted |= 1ull << dev;
    }
  }
  const dim3 grid(a.splits, tiles, a.b * a.kvh);
  kern<<<grid, NT, bytes, stream>>>(p, addr);
  return static_cast<int>(cudaGetLastError());
}

// bf16 windows (full attention or a prefill band) of at least 16 query
// rows take the tensor cores up to D = 128; everything else the CUDA cores.
template <typename T, int KVC, int D, bool RING, typename Addr>
int launch_path(const Args& a, const Addr& addr, cudaStream_t s) {
  if constexpr (sizeof(T) == 2 && !RING && D <= 128) {
    if (a.L * (a.h / a.kvh) >= 16) return launch<T, KVC, D, RING, true>(a, addr, s);
  }
  return launch<T, KVC, D, RING, false>(a, addr, s);
}

template <typename T, int KVC, bool RING, typename Addr>
int launch_d(int d, const Args& a, const Addr& addr, cudaStream_t s) {
  switch (d) {
    case 16: return launch_path<T, KVC, 16, RING>(a, addr, s);
    case 32: return launch_path<T, KVC, 32, RING>(a, addr, s);
    case 64: return launch_path<T, KVC, 64, RING>(a, addr, s);
    case 128: return launch_path<T, KVC, 128, RING>(a, addr, s);
    case 256:  // unquantized caches only (the dense/ring decode and prefill)
      if constexpr (KVC == KV_RAW) return launch_path<T, KVC, 256, RING>(a, addr, s);
      return static_cast<int>(cudaErrorInvalidValue);
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
  const long long rows = static_cast<long long>(a.L) * (a.kvh > 0 ? a.h / a.kvh : 0);
  if (a.b < 1 || a.kvh < 1 || a.h % a.kvh != 0 || a.h / a.kvh > MAXG || a.L < 1 ||
      a.L > 65535 || a.t_cap < 0 || static_cast<long long>(a.b) * a.kvh > 65535 ||
      (rows + QT - 1) / QT > 65535 || a.splits < 1 || a.splits > MAXS || a.kps < KT ||
      a.kps % KT != 0 ||
      (a.splits > 1 && (a.part == nullptr || a.cnt == nullptr)) ||
      (kv != KV_RAW && (a.ks == nullptr || a.vs == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == DTYPE_BF16) return launch_kv<bf16, RING>(kv, d, a, addr, s);
  if (dtype == DTYPE_F32) return launch_kv<float, RING>(kv, d, a, addr, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace decode_attn
}  // namespace
