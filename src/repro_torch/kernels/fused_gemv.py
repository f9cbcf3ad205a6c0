"""Decode GEMV: plain activation rows x packed weight, pack and unpack inside
the kernel (counterpart of repro/kernels/fused_gemv.py: fused_gemv_pallas).

    lhs  : (M, K1*K0)         plain rows, M <= GEMV_MAX_ROWS live decode slots
    rhs4 : (N1, K1, N0, K0)   packed weight, streamed once
    out  : (M, N1*N0) f32     plain

CUDA source: csrc/fused_gemv.cu (what bounds it and how it is laid out is
noted there).  `fused_gemv` launches the kernel for CUDA tensors and takes
the plain version `fused_gemv_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.encoding import GEMV_MAX_ROWS
from repro_torch.kernels import build
from repro_torch.kernels import ref


def check_operands(lhs: torch.Tensor, rhs4: torch.Tensor) -> None:
    """Shape/type contract shared by the GEMV and GEMM wrappers."""
    if lhs.dim() != 2 or rhs4.dim() != 4:
        raise ValueError(f"want lhs (M, K) and rhs4 (N1, K1, N0, K0), got "
                         f"{tuple(lhs.shape)} and {tuple(rhs4.shape)}")
    n1, k1, n0, k0 = rhs4.shape
    if lhs.shape[1] != k1 * k0:
        raise ValueError(f"lhs K {lhs.shape[1]} != packed K {k1 * k0}")
    if lhs.dtype != rhs4.dtype or lhs.device != rhs4.device:
        raise ValueError(f"operands differ: {lhs.dtype}@{lhs.device} vs "
                         f"{rhs4.dtype}@{rhs4.device}")


def fused_gemv_plain(lhs: torch.Tensor, rhs4: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: f32 products and sums."""
    n1, k1, n0, k0 = rhs4.shape
    return ref.matmul_reference(lhs, ref.unpack(rhs4, (n1 * n0, k1 * k0)))


@functools.cache
def _kernel():
    return build.entry(
        "fused_gemv", "fused_gemv",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )


def fused_gemv(lhs: torch.Tensor, rhs4: torch.Tensor) -> torch.Tensor:
    """lhs (M, K) x packed rhs4 -> (M, N1*N0) f32.  Plain version on the CPU;
    on a CUDA tensor the kernel runs or this raises."""
    check_operands(lhs, rhs4)
    if lhs.device.type == "cpu":
        return fused_gemv_plain(lhs, rhs4)
    if lhs.device.type != "cuda":
        raise RuntimeError(f"fused_gemv runs on cuda (or cpu: plain), not {lhs.device}")
    n1, k1, n0, k0 = rhs4.shape
    m = lhs.shape[0]
    if not 1 <= m <= GEMV_MAX_ROWS or (n0, k0) != (128, 128):
        raise ValueError(f"fused_gemv takes 1..{GEMV_MAX_ROWS} rows and 128x128 "
                         f"pack tiles, got M={m}, tile=({n0}, {k0})")
    lhs, rhs4 = build.aligned(lhs), build.aligned(rhs4)
    out = torch.empty((m, n1 * n0), dtype=torch.float32, device=lhs.device)
    err = _kernel()(lhs.data_ptr(), rhs4.data_ptr(), out.data_ptr(), m, n1, k1,
                    build.dtype_code(lhs.dtype), build.stream_ptr(lhs.device))
    build.check(err, "fused_gemv", "fused_gemv launch")
    fused_gemv.launches += 1
    return out


fused_gemv.launches = 0
