"""Prefill GEMM: plain activation rows x packed weight, pack and unpack inside
the kernel (counterpart of repro/kernels/fused_pack_mmt4d.py:
fused_pack_mmt4d_pallas).

    lhs  : (M, K1*K0)         plain rows, any M (ragged rows masked in-kernel)
    rhs4 : (N1, K1, N0, K0)   packed weight
    out  : (M, N1*N0) f32     plain

CUDA source: csrc/fused_pack_mmt4d.cu.  `fused_pack_mmt4d` launches the
kernel for CUDA tensors and takes the plain version only on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.fused_gemv import check_operands


def fused_pack_mmt4d_plain(lhs: torch.Tensor, rhs4: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: the paper's pack -> mmt4d
    -> unpack with f32 accumulation."""
    n1, k1, n0, k0 = rhs4.shape
    m = lhs.shape[0]
    out4 = ref.mmt4d(ref.pack(lhs, (n0, k0)), rhs4)
    return ref.unpack(out4, (m, n1 * n0))


@functools.cache
def _kernel():
    return build.entry(
        "fused_pack_mmt4d", "fused_pack_mmt4d",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )


def fused_pack_mmt4d(lhs: torch.Tensor, rhs4: torch.Tensor) -> torch.Tensor:
    """lhs (M, K) x packed rhs4 -> (M, N1*N0) f32.  Plain version on the CPU;
    on a CUDA tensor the kernel runs or this raises."""
    check_operands(lhs, rhs4)
    if lhs.device.type == "cpu":
        return fused_pack_mmt4d_plain(lhs, rhs4)
    if lhs.device.type != "cuda":
        raise RuntimeError(f"fused_pack_mmt4d runs on cuda (or cpu: plain), not {lhs.device}")
    n1, k1, n0, k0 = rhs4.shape
    m = lhs.shape[0]
    if m < 1 or (n0, k0) != (128, 128):
        raise ValueError(f"fused_pack_mmt4d takes M >= 1 and 128x128 pack tiles, "
                         f"got M={m}, tile=({n0}, {k0})")
    lhs, rhs4 = build.aligned(lhs), build.aligned(rhs4)
    out = torch.empty((m, n1 * n0), dtype=torch.float32, device=lhs.device)
    err = _kernel()(lhs.data_ptr(), rhs4.data_ptr(), out.data_ptr(), m, n1, k1,
                    build.dtype_code(lhs.dtype), build.stream_ptr(lhs.device))
    build.check(err, "fused_pack_mmt4d", "fused_pack_mmt4d launch")
    fused_pack_mmt4d.launches += 1
    return out


fused_pack_mmt4d.launches = 0
