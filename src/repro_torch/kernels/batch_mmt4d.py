"""Batched packed-layout GEMM (counterpart of repro/kernels/batch_mmt4d.py:
batch_mmt4d_pallas).

    lhs5 : (B, M1, K1, M0, K0)   f32 or bf16
    rhs5 : (B, N1, K1, N0, K0)   the same dtype
    out5 : (B, M1, N1, M0, N0)   f32, accumulated in f32

As in the JAX package, no serving path calls it: it completes the
microkernel library (IREE lowers short-sequence attention products to it).
CUDA source: csrc/batch_mmt4d.cu.  `batch_mmt4d` launches the kernel for
CUDA tensors and takes the plain version `batch_mmt4d_plain`
(= ref.batch_mmt4d) only for tensors on the CPU.  The kernel treats each
batch entry as one GEMM of M1*M0 rows and N1*N0 columns and tiles it by
`batch_mmt4d_plan`; it takes every tile shape the JAX kernel takes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.fused_pack_mmt4d import GEMM_WAVE

batch_mmt4d_plain = ref.batch_mmt4d

# The kernel's output tiles (BM, BN), largest first, and the K elements a
# stage holds (csrc/batch_mmt4d.cu).
TILES = ((64, 64), (32, 64), (32, 32))
STAGE_K = 32


def batch_mmt4d_plan(bsz: int, m: int, n: int) -> tuple[int, int, int]:
    """(BM, BN, BK) for bsz GEMMs of m x n outputs: the largest tile whose
    grid, bsz * ceil(m / BM) * ceil(n / BN) blocks, fills a wave of the
    H100's SMs; the smallest where none does."""
    for bm, bn in TILES:
        if bsz * -(-m // bm) * -(-n // bn) >= GEMM_WAVE:
            return bm, bn, STAGE_K
    return TILES[-1] + (STAGE_K,)


@functools.cache
def _kernel():
    return build.entry(
        "batch_mmt4d", "batch_mmt4d",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
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
    lhs5, rhs5 = build.aligned(lhs5), build.aligned(rhs5)
    out5 = torch.empty((bsz, m1, n1, m0, n0), dtype=torch.float32, device=lhs5.device)
    bm, bn, _ = batch_mmt4d_plan(bsz, m1 * m0, n1 * n0)
    err = _kernel()(lhs5.data_ptr(), rhs5.data_ptr(), out5.data_ptr(), bsz, m1, n1, k1,
                    m0, n0, k0, build.dtype_code(lhs5.dtype), bm, bn,
                    build.stream_ptr(lhs5.device))
    build.check(err, "batch_mmt4d", "batch_mmt4d launch")
    batch_mmt4d.launches += 1
    return out5


batch_mmt4d.launches = 0
