"""Packed-layout decode GEMV (counterpart of repro/kernels/mmt4d_gemv.py:
mmt4d_gemv_pallas).

    lhs4 : (1, K1, M0, K0)    one packed row block, M0 <= GEMV_MAX_ROWS
    rhs4 : (N1, K1, N0, K0)   packed weight, streamed once
    out4 : (1, N1, M0, N0)    f32, packed

CUDA source: csrc/mmt4d_gemv.cu.  `mmt4d_gemv` launches the kernel for CUDA
tensors and takes the plain version `mmt4d_gemv_plain` only on the CPU.  In
bf16 it is the packed GEMM's skinny body at M1 = 1 (csrc/packed_skinny.cuh),
with the K split of `mmt4d.mmt4d_plan`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.encoding import GEMV_MAX_ROWS
from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.mmt4d import check_packed, launch_args, mmt4d_plan


def mmt4d_gemv_plain(lhs4: torch.Tensor, rhs4: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: ref.mmt4d on one row block."""
    assert lhs4.shape[0] == 1, f"decode GEMV takes one packed row block, got M1={lhs4.shape[0]}"
    return ref.mmt4d(lhs4, rhs4)


@functools.cache
def _kernel():
    return build.entry(
        "mmt4d_gemv", "mmt4d_gemv",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3,
    )


def mmt4d_gemv(lhs4: torch.Tensor, rhs4: torch.Tensor) -> torch.Tensor:
    """(1, K1, M0, K0) x packed rhs4 -> (1, N1, M0, N0) f32.  Plain version on
    the CPU; on a CUDA tensor the kernel runs or this raises."""
    assert lhs4.shape[0] == 1, f"decode GEMV takes one packed row block, got M1={lhs4.shape[0]}"
    if lhs4.device.type == "cpu":
        return mmt4d_gemv_plain(lhs4, rhs4)
    if lhs4.device.type != "cuda":
        raise RuntimeError(f"mmt4d_gemv runs on cuda (or cpu: plain), not {lhs4.device}")
    check_packed(lhs4, rhs4, lambda m0: 1 <= m0 <= GEMV_MAX_ROWS)
    _, k1, m0, _ = lhs4.shape
    n1, _, n0, _ = rhs4.shape
    lhs4, rhs4 = build.aligned(lhs4), build.aligned(rhs4)
    out4 = torch.empty((1, n1, m0, n0), dtype=torch.float32, device=lhs4.device)
    splits, part, cnt = 1, None, None
    if lhs4.dtype == torch.bfloat16:
        _, _, _, splits, part, cnt = launch_args(lhs4.device, 1, m0, n1, k1,
                                                 mmt4d_plan(1, m0, n1, k1))
    err = _kernel()(lhs4.data_ptr(), rhs4.data_ptr(), out4.data_ptr(), m0, n1, k1,
                    build.dtype_code(lhs4.dtype), splits, part, cnt,
                    build.stream_ptr(lhs4.device))
    build.check(err, "mmt4d_gemv", "mmt4d_gemv launch")
    mmt4d_gemv.launches += 1
    return out4


mmt4d_gemv.launches = 0
