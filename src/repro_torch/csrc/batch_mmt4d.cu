// Batched packed-layout GEMM: linalg.batch_mmt4d, f32 accumulation.
//
// Replaces src/repro/kernels/batch_mmt4d.py: batch_mmt4d_pallas (TPU).
//   lhs5 (B, M1, K1, M0, K0) x rhs5 (B, N1, K1, N0, K0) -> out5 (B, M1, N1, M0, N0) f32,
//   out5[z, m1, n1, m0, n0] = sum_{k1, k0} lhs5[z, m1, k1, m0, k0] * rhs5[z, n1, k1, n0, k0],
//   f32 or bf16 operands (bf16 products are exact in f32).
// IREE lowers short-sequence attention score and context products to it; no
// serving path of the JAX package or of the port calls it (the model's
// attention runs the flash and decode kernels), so it stands here as the
// library kernel it is in the JAX package, checked against its plain version.
//
// What bounds it on the H100: at the attention shapes (M0 = 16, K0 = 64,
// one or two K tiles) the bytes and the f32 operations are close: a
// (128, 8, 1, 16, 64) x (128, 8, 1, 16, 64) score product moves 16.8 MB
// (0.005 ms) for 0.27 GFLOP (0.004 ms at 67 TFLOP/s on CUDA cores).  So
// every operand byte should come from device memory about once, and the
// products should keep the CUDA cores (f32) or the tensor cores (bf16) busy.
//
// Design.  The TPU kernel walks a (B, M1, N1, K1) grid of (M0, N0) output
// tiles with a VMEM accumulator.  Here each batch entry z is one GEMM of
// M = M1*M0 rows, N = N1*N0 columns and K = K1*K0, cut into BM x BN output
// tiles (BM, BN in {32, 64}: the host's plan, kernels/batch_mmt4d.py:
// batch_mmt4d_plan, takes the largest tile of which there are at least 132,
// a wave of SMs).  The packed addresses are computed in the staging: row m
// is (m / M0, m % M0), column k is (k / K0, k % K0), and a row's K0
// elements of one K tile are contiguous.
//   - Blocks.  One a tile: the attention shapes' 512 tiles of 64 x 64 in
//     one wave (four or five blocks an SM).
//   - Loads.  BK = 32 K elements of the tile's BM rows and BN columns at a
//     time, in a double-buffered shared-memory ring filled by cp.async:
//     16-byte copies (4 f32 or 8 bf16 of one row) where K0 and the bases
//     allow, one element at a time otherwise; rows, columns and K past the
//     edges are zeros.  Each operand byte is read from device memory once
//     per block row or column of output tiles, not once per (M0, N0) tile.
//   - Products.  f32: CUDA cores, 8 x 4 outputs a thread (rows 8 ty + i,
//     columns tx + BN/4 j: the B rows a warp reads sit in distinct banks),
//     exact fmaf in K order; no TF32, which would round the operands to 11
//     bits.  bf16: mma.sync m16n8k16 with f32 accumulation, a warp per 16
//     x 32 outputs, fragments by ldmatrix from rows padded to 80 bytes.
//     wgmma is not needed at K = 64-128: a tile is done in 2-4 steps, and
//     the bytes bound it, not the tensor cores' issue rate.
//   - Output.  The tile goes through shared memory and out to the packed
//     (B, M1, N1, M0, N0) layout in 16-byte stores along N0 (4-byte ones
//     where N0 is not a multiple of 4), neighbouring threads on
//     neighbouring columns.  The packed addresses divide by M0, N0 and K0
//     with a multiply-high and a shift (host-computed multipliers).
// Any tile shape the JAX kernel takes: M0, N0, K0 >= 1, no limit on M0 * N0.
#include "common.cuh"

namespace {

constexpr int BK = 32;  // K elements a stage

template <typename T>
struct Pad;  // a staged row's length in elements (rows 16-byte aligned, banks spread)
template <>
struct Pad<float> { static constexpr int LD = BK + 4; };
template <>
struct Pad<bf16> { static constexpr int LD = BK + 8; };

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(const void* p, unsigned* r) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(const void* p, unsigned* r) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// d (16 x 8 f32) += a (16 x 16 bf16, row-major) b (16 x 8 bf16, col-major).
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (the host computes
// the multiplier: make_div): the packed addresses divide by M0, N0 and K0
// at every staged chunk and stored vector.
struct Div {
  int d;
  unsigned mul, shr;
};

Div make_div(int d) {
  Div v{d, 0u, 0u};
  if (d > 1) {
    int l = 0;
    while ((1u << l) < static_cast<unsigned>(d)) ++l;  // ceil(log2 d)
    const unsigned p = 31 + l;
    v.mul = static_cast<unsigned>(((1ull << p) + d - 1) / d);
    v.shr = p - 32;
  }
  return v;
}

__device__ __forceinline__ int quo(const Div& v, int n) {
  return v.d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), v.mul) >> v.shr);
}

// The packed shapes: lhs5 (B, M1, K1, M0, K0), rhs5 (B, N1, K1, N0, K0),
// out5 (B, M1, N1, M0, N0).
struct Dims {
  int m1, n1, k1;
  Div m0, n0, k0;
};

// One operand of one batch entry, (X1, K1, X0, K0) packed: row x, column k
// at row_at(x) + col_at(k).
template <typename T>
struct Operand {
  const T* base;
  int rows;  // X1 * X0
  Div x0;
  int k1;
  Div k0;
  __device__ __forceinline__ size_t row_at(int x) const {
    const int a1 = quo(x0, x);
    return (static_cast<size_t>(a1) * k1 * x0.d + (x - a1 * x0.d)) * k0.d;
  }
  __device__ __forceinline__ size_t col_at(int k) const {
    const int c1 = quo(k0, k);
    return (static_cast<size_t>(c1) * x0.d) * k0.d + (k - c1 * k0.d);
  }
};

// Stage K elements kc .. kc + BK of rows base .. base + R - 1 of `op` into
// dst (R rows of LD elements); zeros past the edges.
template <typename T, int R, int THREADS>
__device__ __forceinline__ void stage(T* dst, const Operand<T>& op, int base, int kc, int kk_all,
                                      bool vec) {
  constexpr int LD = Pad<T>::LD;
  if (vec) {  // K0 a multiple of V: a V-run never straddles a K tile
    constexpr int V = 16 / sizeof(T);
    for (int i = threadIdx.x; i < R * (BK / V); i += THREADS) {
      const int r = i / (BK / V);
      const int kk = (i - r * (BK / V)) * V;
      const int x = base + r;
      const int k = kc + kk;
      const bool live = x < op.rows && k < kk_all;
      cp_async16(dst + r * LD + kk, live ? op.base + op.row_at(x) + op.col_at(k) : op.base, live);
    }
  } else {
    for (int i = threadIdx.x; i < R * BK; i += THREADS) {
      const int r = i / BK;
      const int kk = i - r * BK;
      const int x = base + r;
      const int k = kc + kk;
      dst[r * LD + kk] = (x < op.rows && k < kk_all) ? op.base[op.row_at(x) + op.col_at(k)]
                                                      : from_f32<T>(0.f);
    }
  }
}

template <typename T, int BM, int BN>
struct Smem {
  static constexpr int LD = Pad<T>::LD;
  static constexpr int STAGES = 2 * (BM + BN) * LD * static_cast<int>(sizeof(T));
  static constexpr int LDC = BN + 4;  // the output tile's rows, f32
  static constexpr int OUT = BM * LDC * 4;
  static constexpr int BYTES = STAGES > OUT ? STAGES : OUT;
};

// Threads a BM x BN tile takes: f32 8 x 4 outputs a thread, bf16 a warp per
// 16 x 32.
template <typename T, int BM, int BN>
constexpr int threads_of = BM * BN / (sizeof(T) == 4 ? 32 : 16);

// bf16 64 x 64 tiles: four blocks an SM (at most 64 registers a thread), so
// the attention shapes' 512 tiles run in one wave of 132 SMs.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(threads_of<T, BM, BN>, sizeof(T) == 2 && BM == 64 ? 4 : 1)
batch_mmt4d_kernel(const T* __restrict__ lhs5, const T* __restrict__ rhs5,
                   float* __restrict__ out5, const Dims dims, int vec) {
  constexpr int THREADS = threads_of<T, BM, BN>;
  constexpr int TM = sizeof(T) == 4 ? 8 : 4;  // f32: rows a thread; bf16: n8 fragments
  constexpr int LD = Pad<T>::LD;
  using S = Smem<T, BM, BN>;
  __shared__ __align__(16) unsigned char smem[S::BYTES];
  T* As = reinterpret_cast<T*>(smem);          // [2][BM * LD]
  T* Bs = As + 2 * BM * LD;                    // [2][BN * LD]
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][LDC], after the K loop
  const int m0 = dims.m0.d, n0 = dims.n0.d;
  const int M = dims.m1 * m0;
  const int N = dims.n1 * n0;
  const int K = dims.k1 * dims.k0.d;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  const int z = blockIdx.x / tiles;
  const int tile = blockIdx.x - z * tiles;
  const int m_base = (tile / tiles_n) * BM;
  const int n_base = (tile % tiles_n) * BN;
  const Operand<T> a{lhs5 + static_cast<size_t>(z) * M * K, M, dims.m0, dims.k1, dims.k0};
  const Operand<T> b{rhs5 + static_cast<size_t>(z) * N * K, N, dims.n0, dims.k1, dims.k0};
  const int chunks = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  stage<T, BM, THREADS>(As, a, m_base, 0, K, vec);
  stage<T, BN, THREADS>(Bs, b, n_base, 0, K, vec);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage<T, BM, THREADS>(As + ((c + 1) & 1) * BM * LD, a, m_base, (c + 1) * BK, K, vec);
      stage<T, BN, THREADS>(Bs + ((c + 1) & 1) * BN * LD, b, n_base, (c + 1) * BK, K, vec);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);  // chunk c has landed
    __syncthreads();
    const T* as = As + (c & 1) * BM * LD;
    const T* bs = Bs + (c & 1) * BN * LD;
    if constexpr (sizeof(T) == 4) {
      const int tx = threadIdx.x % (BN / 4);
      const int ty = threadIdx.x / (BN / 4);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4) {
        float4 av[TM], bv[4];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          av[i] = *reinterpret_cast<const float4*>(as + (ty * TM + i) * LD + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(bs + (tx + (BN / 4) * j) * LD + kk);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float s = acc[i][j];
            s = fmaf(av[i].x, bv[j].x, s);
            s = fmaf(av[i].y, bv[j].y, s);
            s = fmaf(av[i].z, bv[j].z, s);
            s = fmaf(av[i].w, bv[j].w, s);
            acc[i][j] = s;
          }
      }
    } else {
      const int wm = warp % (BM / 16);  // rows 16 wm .., columns 32 wn ..
      const int wn = warp / (BM / 16);
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        unsigned fa[4];
        ldsm_x4(as + (wm * 16 + (lane & 15)) * LD + ks + (lane >> 4) * 8, fa);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned fb[2];
          ldsm_x2(bs + (wn * 32 + j * 8 + (lane & 7)) * LD + ks + ((lane >> 3) & 1) * 8, fb);
          mma_bf16(acc[j], fa, fb);
        }
      }
    }
    __syncthreads();
  }

  // The tile through shared memory (the drained ring), then out to the
  // packed (M1, N1, M0, N0) layout: (m, n) at row_at(m) + col_at(n).
  if constexpr (sizeof(T) == 4) {
    const int tx = threadIdx.x % (BN / 4);
    const int ty = threadIdx.x / (BN / 4);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(ty * TM + i) * S::LDC + tx + (BN / 4) * j] = acc[i][j];
  } else {
    const int wm = warp % (BM / 16);
    const int wn = warp / (BM / 16);
    const int r = wm * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn * 32 + j * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(Cs + r * S::LDC + c) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(Cs + (r + 8) * S::LDC + c) = make_float2(acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();
  float* oz = out5 + static_cast<size_t>(z) * M * N;
  const bool vec_out = n0 % 4 == 0;  // 4 columns from a multiple of 4 share an N0 tile
  for (int e = threadIdx.x; e < BM * (BN / 4); e += THREADS) {
    const int r = e / (BN / 4);
    const int c = (e - r * (BN / 4)) * 4;
    const int m = m_base + r;
    if (m >= M) continue;
    const int a1 = quo(dims.m0, m);
    float* row = oz + (static_cast<size_t>(a1) * dims.n1 * m0 + (m - a1 * m0)) * n0;
    const float4 v = *reinterpret_cast<const float4*>(Cs + r * S::LDC + c);
    const int n = n_base + c;
    if (vec_out && n + 3 < N) {
      const int b1 = quo(dims.n0, n);
      *reinterpret_cast<float4*>(row + static_cast<size_t>(b1) * m0 * n0 + (n - b1 * n0)) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (n + u < N) {
          const int b1 = quo(dims.n0, n + u);
          row[static_cast<size_t>(b1) * m0 * n0 + (n + u - b1 * n0)] = vs[u];
        }
      }
    }
  }
}

template <typename T, int BM, int BN>
cudaError_t launch(const void* lhs5, const void* rhs5, void* out5, int bsz, const Dims& dims,
                   cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const long long tiles = static_cast<long long>((dims.m1 * dims.m0.d + BM - 1) / BM) *
                          ((dims.n1 * dims.n0.d + BN - 1) / BN);
  if (tiles * bsz > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = dims.k0.d % V == 0 && reinterpret_cast<uintptr_t>(lhs5) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rhs5) % 16 == 0;
  batch_mmt4d_kernel<T, BM, BN><<<static_cast<unsigned>(tiles * bsz), threads_of<T, BM, BN>, 0, s>>>(
      static_cast<const T*>(lhs5), static_cast<const T*>(rhs5), static_cast<float*>(out5), dims,
      vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(int bm, int bn, const void* lhs5, const void* rhs5, void* out5, int bsz,
                        const Dims& dims, cudaStream_t s) {
  if (bm == 64 && bn == 64) return launch<T, 64, 64>(lhs5, rhs5, out5, bsz, dims, s);
  if (bm == 32 && bn == 64) return launch<T, 32, 64>(lhs5, rhs5, out5, bsz, dims, s);
  if (bm == 32 && bn == 32) return launch<T, 32, 32>(lhs5, rhs5, out5, bsz, dims, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// (bm, bn): the plan's output tile, (64, 64), (32, 64) or (32, 32).
extern "C" int batch_mmt4d(const void* lhs5, const void* rhs5, void* out5, int bsz, int m1,
                           int n1, int k1, int m0, int n0, int k0, int dtype, int bm, int bn,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bsz < 1 || m1 < 1 || n1 < 1 || k1 < 1 || m0 < 1 || n0 < 1 || k0 < 1 ||
      static_cast<long long>(m1) * m0 > 0x7fffffffLL / 2 ||
      static_cast<long long>(n1) * n0 > 0x7fffffffLL / 2 ||
      static_cast<long long>(k1) * k0 > 0x7fffffffLL / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims dims{m1, n1, k1, make_div(m0), make_div(n0), make_div(k0)};
  if (dtype == DTYPE_BF16)
    return static_cast<int>(launch_tile<bf16>(bm, bn, lhs5, rhs5, out5, bsz, dims, s));
  if (dtype == DTYPE_F32)
    return static_cast<int>(launch_tile<float>(bm, bn, lhs5, rhs5, out5, bsz, dims, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
