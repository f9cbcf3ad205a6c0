// tensor.pack and tensor.unpack: the pure relayouts around the packed GEMMs.
//
// Replaces src/repro/kernels/pack.py: pack_pallas and unpack_pallas (TPU).
//   pack   x (R, C) -> out (R1, C1, T0, T1),
//          out[r1, c1, t0, t1] = x[r1*T0 + t0, c1*T1 + t1], zero past R or C;
//   unpack y (R1, C1, T0, T1) -> out (R, C), the same map read backwards,
//          cropped to R <= R1*T0 rows and C <= C1*T1 columns, contiguous.
// Elements are copied as raw bytes (1, 2 or 4 a value: int8/uint8, bf16,
// f32), so both are exact for every type and never round.
//
// What bounds it on the H100: bytes.  Each input byte is read once and each
// output byte written once, with no arithmetic but addressing: a (8192, 2048)
// bf16 weight moves 64 MiB, 0.020 ms at 3.35 TB/s.
//
// Design.  The TPU kernels copy slabs of whole tiles through VMEM and take
// only tile-aligned operands (ops pads first).  Here a tile row of T1
// elements is one contiguous run on both sides (at (r, c1*T1) in x and at
// ((r1*C1 + c1)*T0 + t0)*T1 in the packed tensor), so the relayout is a copy
// of runs: every thread moves 16-byte chunks, walking the side written
// contiguously (the packed tensor for pack, the 2-D one for unpack), and
// reads the matching chunk of the other side.  A warp then writes 512
// contiguous bytes and reads runs of T1*E bytes (16-512 at the port's tiles).
// The ragged edge is masked in the kernel: a pack chunk past R or C is
// written as zeros, so no pad launch precedes it.  Where a run is not a
// whole number of aligned 16-byte chunks (T1*E or C*E not a multiple of 16,
// or a base not 16-byte aligned), a per-element path of the same map runs
// instead.  A grid-stride loop over at most 32 blocks per SM covers any size.
// On the serving path only the weight packs at load run here: the packed
// GEMMs' plain-row entries pack the activation rows in their TMA loads and
// unpack the output in their epilogue stores (mmt4d.cu: mmt4d_rows).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// Chunks of 16 bytes.  cols16 = C*E/16, run16 = T1*E/16 (both whole).
__global__ void __launch_bounds__(THREADS)
pack_vec_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, long long rows,
                long long cols16, int t0, int run16, long long c1, long long total) {
  for (long long q = blockIdx.x * (long long)THREADS + threadIdx.x; q < total;
       q += (long long)gridDim.x * THREADS) {
    const long long seg = q / run16;          // ((r1*C1 + c1)*T0 + t0)
    const int j = (int)(q - seg * run16);     // chunk within the tile row
    const long long tile = seg / t0;          // r1*C1 + c1
    const int a0 = (int)(seg - tile * t0);
    const long long b1 = tile / c1;           // r1
    const long long cc = tile - b1 * c1;      // c1
    const long long r = b1 * t0 + a0;
    const long long col = cc * run16 + j;     // 16-byte column chunk in x
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && col < cols16) v = x[r * cols16 + col];
    out[q] = v;
  }
}

__global__ void __launch_bounds__(THREADS)
unpack_vec_kernel(const uint4* __restrict__ y, uint4* __restrict__ out, long long cols16,
                  int t0, int run16, long long c1, long long total) {
  for (long long q = blockIdx.x * (long long)THREADS + threadIdx.x; q < total;
       q += (long long)gridDim.x * THREADS) {
    const long long r = q / cols16;
    const long long col = q - r * cols16;     // 16-byte column chunk of the output
    const long long b1 = r / t0;
    const long long a0 = r - b1 * t0;
    const long long cc = col / run16;
    const long long j = col - cc * run16;
    out[q] = y[(((b1 * c1 + cc) * t0 + a0) * run16) + j];
  }
}

// One element of E bytes per step (T = uint8_t, uint16_t or uint32_t).
template <typename T>
__global__ void __launch_bounds__(THREADS)
pack_elem_kernel(const T* __restrict__ x, T* __restrict__ out, long long rows, long long cols,
                 int t0, int t1, long long c1, long long total) {
  for (long long q = blockIdx.x * (long long)THREADS + threadIdx.x; q < total;
       q += (long long)gridDim.x * THREADS) {
    const long long seg = q / t1;
    const int j = (int)(q - seg * t1);
    const long long tile = seg / t0;
    const int a0 = (int)(seg - tile * t0);
    const long long b1 = tile / c1;
    const long long cc = tile - b1 * c1;
    const long long r = b1 * t0 + a0;
    const long long c = cc * t1 + j;
    out[q] = (r < rows && c < cols) ? x[r * cols + c] : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
unpack_elem_kernel(const T* __restrict__ y, T* __restrict__ out, long long cols, int t0, int t1,
                   long long c1, long long total) {
  for (long long q = blockIdx.x * (long long)THREADS + threadIdx.x; q < total;
       q += (long long)gridDim.x * THREADS) {
    const long long r = q / cols;
    const long long c = q - r * cols;
    const long long b1 = r / t0;
    const long long a0 = r - b1 * t0;
    const long long cc = c / t1;
    const long long j = c - cc * t1;
    out[q] = y[((b1 * c1 + cc) * t0 + a0) * t1 + j];
  }
}

int grid_for(long long total) {
  static int sms_of[64] = {0};  // SM count per device, read once
  int dev = 0;
  cudaGetDevice(&dev);
  int sms = dev < 64 ? sms_of[dev] : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (dev < 64) sms_of[dev] = sms;
  }
  const long long want = (total + THREADS - 1) / THREADS;
  const long long cap = 32LL * sms;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

bool vec_ok(const void* a, const void* b, long long cols_bytes, long long run_bytes) {
  return cols_bytes % 16 == 0 && run_bytes % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace

// x (rows, cols) -> out (r1, c1, t0, t1), elements of elem_bytes bytes.
extern "C" int pack_tiles(const void* x, void* out, long long rows, long long cols, int t0,
                          int t1, long long r1, long long c1, int elem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || cols < 1 || t0 < 1 || t1 < 1 || r1 * t0 < rows || c1 * t1 < cols)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long elems = r1 * c1 * t0 * t1;
  const long long e = elem_bytes;
  if (vec_ok(x, out, cols * e, t1 * e)) {
    const long long total = elems * e / 16;
    pack_vec_kernel<<<grid_for(total), THREADS, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out), rows, cols * e / 16, t0,
        (int)(t1 * e / 16), c1, total);
  } else if (elem_bytes == 1) {
    pack_elem_kernel<uint8_t><<<grid_for(elems), THREADS, 0, s>>>(
        static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), rows, cols, t0, t1, c1, elems);
  } else if (elem_bytes == 2) {
    pack_elem_kernel<uint16_t><<<grid_for(elems), THREADS, 0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), rows, cols, t0, t1, c1,
        elems);
  } else if (elem_bytes == 4) {
    pack_elem_kernel<uint32_t><<<grid_for(elems), THREADS, 0, s>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), rows, cols, t0, t1, c1,
        elems);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// y (r1, c1, t0, t1) -> out (rows, cols), rows <= r1*t0, cols <= c1*t1.
extern "C" int unpack_tiles(const void* y, void* out, long long rows, long long cols, int t0,
                            int t1, long long r1, long long c1, int elem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || cols < 1 || t0 < 1 || t1 < 1 || r1 * t0 < rows || c1 * t1 < cols)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long elems = rows * cols;
  const long long e = elem_bytes;
  if (vec_ok(y, out, cols * e, t1 * e)) {
    const long long total = elems * e / 16;
    unpack_vec_kernel<<<grid_for(total), THREADS, 0, s>>>(
        static_cast<const uint4*>(y), static_cast<uint4*>(out), cols * e / 16, t0,
        (int)(t1 * e / 16), c1, total);
  } else if (elem_bytes == 1) {
    unpack_elem_kernel<uint8_t><<<grid_for(elems), THREADS, 0, s>>>(
        static_cast<const uint8_t*>(y), static_cast<uint8_t*>(out), cols, t0, t1, c1, elems);
  } else if (elem_bytes == 2) {
    unpack_elem_kernel<uint16_t><<<grid_for(elems), THREADS, 0, s>>>(
        static_cast<const uint16_t*>(y), static_cast<uint16_t*>(out), cols, t0, t1, c1, elems);
  } else if (elem_bytes == 4) {
    unpack_elem_kernel<uint32_t><<<grid_for(elems), THREADS, 0, s>>>(
        static_cast<const uint32_t*>(y), static_cast<uint32_t*>(out), cols, t0, t1, c1, elems);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
