// Causal GQA prefill attention with an online softmax.
//
// Replaces src/repro/kernels/attn.py: flash_prefill_attention (TPU).
//   q (B, Sq, H, D), k/v (B, Sk, KV, D) -> out (B, Sq, H, D) in q's dtype.
//   Query row i sits at absolute position q_offset + i; key j at position j.
//   Head h reads kv head h / G (G = H / KV): head = kv*G + j, the JAX
//   package's grouping (repeat_interleave, not repeat).
//
// What bounds it on the H100: operations (4*Sq*Sk*H*D flops, about half of
// them above the causal diagonal and skipped).  This first kernel runs them
// on the CUDA cores in f32, so its floor is the f32 rate, not the tensor cores'.
//
// Design.  One block per (query tile of 32 rows, kv head, batch row): the K/V
// chunks of that kv head are staged once in shared memory (converted to f32,
// rows past Sk zero-filled so the V tail is zero) and serve all G query heads
// of the group, one thread per (head, query row).  Each thread keeps its
// scaled query and its (m, l, acc) state in registers.  Chunks wholly above
// the diagonal are never loaded (the loop stops at the tile's last query
// position, q_offset included), masked keys are skipped, and a row that saw
// no valid key writes 0, not NaN.  The K loop lives inside the block; no
// state crosses blocks.
#include "common.cuh"

namespace {

constexpr int QT = 32;  // query rows per block (per head of the group)

template <typename T, int D>
__global__ void flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                     const T* __restrict__ v, T* __restrict__ out,
                                     int sq, int sk, int h, int kvh, int q_offset,
                                     int causal, int window, float scale) {
  constexpr int KC = 4096 / D;  // keys per staged chunk: 2 * KC * D * 4 B = 32 KB
  __shared__ float Ks[KC][D];
  __shared__ float Vs[KC][D];
  const int g = h / kvh;
  const int q0 = blockIdx.x * QT;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int j = threadIdx.x / QT;  // head within the group
  const int r = threadIdx.x % QT;  // query row within the tile
  const int head = kv * g + j;
  const int row = q0 + r;
  const bool live = row < sq;
  const int qpos = q_offset + row;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? to_f32(q[(((size_t)b * sq + row) * h + head) * D + d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = __int_as_float(0xff800000);  // -inf
  float l = 0.f;

  const int q_last = q_offset + min(q0 + QT, sq) - 1;  // last query position of the tile
  const int kend = (causal && window == 0) ? min(sk, q_last + 1) : sk;
  for (int kb = 0; kb < kend; kb += KC) {
    __syncthreads();
    for (int i = threadIdx.x; i < KC * D; i += blockDim.x) {
      const int c = i / D;
      const int d = i - c * D;
      const int kp = kb + c;
      float kx = 0.f, vx = 0.f;
      if (kp < sk) {
        const size_t off = (((size_t)b * sk + kp) * kvh + kv) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[c][d] = kx;
      Vs[c][d] = vx;
    }
    __syncthreads();
    if (!live) continue;
    const int nk = min(KC, kend - kb);
    for (int c = 0; c < nk; ++c) {
      const int kp = kb + c;
      if (causal && kp > qpos) break;  // keys only grow within a chunk
      if (window > 0 && kp <= qpos - window) continue;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], Ks[c][d], s);
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * corr + p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[c][d], acc[d] * corr);
      m = m_new;
    }
  }
  if (!live) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* o = out + (((size_t)b * sq + row) * h + head) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = from_f32<T>(acc[d] * inv);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq,
           int sk, int h, int kvh, int q_offset, int causal, int window, float scale,
           cudaStream_t stream) {
  const dim3 grid((sq + QT - 1) / QT, kvh, b);
  const dim3 block((h / kvh) * QT);
  flash_prefill_kernel<T, D><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, h, kvh, q_offset, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* out, int b,
             int sq, int sk, int h, int kvh, int q_offset, int causal, int window,
             float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, b, sq, sk, h, kvh, q_offset, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, b, sq, sk, h, kvh, q_offset, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, b, sq, sk, h, kvh, q_offset, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, b, sq, sk, h, kvh, q_offset, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_prefill_attention(const void* q, const void* k, const void* v,
                                       void* out, int b, int sq, int sk, int h, int kvh,
                                       int d, int q_offset, int causal, int window,
                                       float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kvh < 1 || h % kvh != 0 || (h / kvh) * QT > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == DTYPE_BF16)
    return launch_d<bf16>(d, q, k, v, out, b, sq, sk, h, kvh, q_offset, causal, window, scale, s);
  if (dtype == DTYPE_F32)
    return launch_d<float>(d, q, k, v, out, b, sq, sk, h, kvh, q_offset, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
