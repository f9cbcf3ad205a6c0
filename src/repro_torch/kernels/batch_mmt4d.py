"""Batched packed-layout GEMM (counterpart of repro/kernels/batch_mmt4d.py:
batch_mmt4d_pallas).

    lhs5 : (B, M1, K1, M0, K0)   f32 or bf16
    rhs5 : (B, N1, K1, N0, K0)   the same dtype
    out5 : (B, M1, N1, M0, N0)   f32, accumulated in f32

As in the JAX package, no serving path calls it: it completes the
microkernel library (IREE lowers short-sequence attention products to it).
CUDA source: csrc/batch_mmt4d.cu.  `batch_mmt4d` launches the kernel for
CUDA tensors and takes the plain version `batch_mmt4d_plain`
(= ref.batch_mmt4d) only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

batch_mmt4d_plain = ref.batch_mmt4d

# The kernel's limits (csrc/batch_mmt4d.cu): outputs per tile, and the f32
# staging of one (M0, K0) and one (N0, K0) tile in 48 KB of shared memory.
MAX_TILE_OUTPUTS = 1024
MAX_SMEM_BYTES = 48 * 1024


@functools.cache
def _kernel():
    return build.entry(
        "batch_mmt4d", "batch_mmt4d",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    )


def batch_mmt4d(lhs5: torch.Tensor, rhs5: torch.Tensor) -> torch.Tensor:
    """lhs5 x rhs5 -> (B, M1, N1, M0, N0) f32.  Plain version on the CPU; on
    a CUDA tensor the kernel runs or this raises."""
    if lhs5.device.type == "cpu":
        return batch_mmt4d_plain(lhs5, rhs5)
    if lhs5.device.type != "cuda":
        raise RuntimeError(f"batch_mmt4d runs on cuda (or cpu: plain), not {lhs5.device}")
    if lhs5.dim() != 5 or rhs5.dim() != 5:
        raise ValueError(f"want lhs5 (B, M1, K1, M0, K0) and rhs5 (B, N1, K1, N0, K0), got "
                         f"{tuple(lhs5.shape)} and {tuple(rhs5.shape)}")
    bsz, m1, k1, m0, k0 = lhs5.shape
    bsz_r, n1, k1_r, n0, k0_r = rhs5.shape
    if (bsz, k1, k0) != (bsz_r, k1_r, k0_r):
        raise ValueError(f"batch or K tiles differ: lhs5 {tuple(lhs5.shape)}, "
                         f"rhs5 {tuple(rhs5.shape)}")
    if lhs5.dtype != rhs5.dtype or lhs5.device != rhs5.device:
        raise ValueError(f"operands differ: {lhs5.dtype}@{lhs5.device} vs "
                         f"{rhs5.dtype}@{rhs5.device}")
    if m0 * n0 > MAX_TILE_OUTPUTS or (m0 + n0) * (k0 + 1) * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"batch_mmt4d takes M0*N0 <= {MAX_TILE_OUTPUTS} and "
                         f"(M0+N0)*(K0+1)*4 <= {MAX_SMEM_BYTES}, got M0={m0} N0={n0} K0={k0}")
    lhs5, rhs5 = lhs5.contiguous(), rhs5.contiguous()
    out5 = torch.empty((bsz, m1, n1, m0, n0), dtype=torch.float32, device=lhs5.device)
    err = _kernel()(lhs5.data_ptr(), rhs5.data_ptr(), out5.data_ptr(), bsz, m1, n1, k1,
                    m0, n0, k0, build.dtype_code(lhs5.dtype), build.stream_ptr(lhs5.device))
    build.check(err, "batch_mmt4d", "batch_mmt4d launch")
    batch_mmt4d.launches += 1
    return out5


batch_mmt4d.launches = 0
