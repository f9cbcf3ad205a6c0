"""Packed-layout GEMM (counterpart of repro/kernels/mmt4d.py: mmt4d_pallas).

    lhs4 : (M1, K1, M0, K0)   packed rows: M0 in 1..8 at decode, 128 at prefill
    rhs4 : (N1, K1, N0, K0)   packed weight, N0 = K0 = 128
    out4 : (M1, N1, M0, N0)   f32, packed

CUDA source: csrc/mmt4d.cu (what bounds it and how it is laid out is noted
there).  `mmt4d` launches the kernel for CUDA tensors and takes the plain
version `mmt4d_plain` (= ref.mmt4d) only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.encoding import GEMV_MAX_ROWS, PACK_TILE
from repro_torch.kernels import build
from repro_torch.kernels import ref

mmt4d_plain = ref.mmt4d


def check_packed(lhs4: torch.Tensor, rhs4: torch.Tensor, m0_ok) -> None:
    """Shape/type contract shared by the packed GEMM and GEMV wrappers;
    `m0_ok(m0)` says which row tile the kernel takes."""
    if lhs4.dim() != 4 or rhs4.dim() != 4:
        raise ValueError(f"want lhs4 (M1, K1, M0, K0) and rhs4 (N1, K1, N0, K0), got "
                         f"{tuple(lhs4.shape)} and {tuple(rhs4.shape)}")
    m1, k1, m0, k0 = lhs4.shape
    n1, k1r, n0, k0r = rhs4.shape
    if (k1, k0) != (k1r, k0r):
        raise ValueError(f"K tiles differ: lhs4 {tuple(lhs4.shape)}, rhs4 {tuple(rhs4.shape)}")
    if lhs4.dtype != rhs4.dtype or lhs4.device != rhs4.device:
        raise ValueError(f"operands differ: {lhs4.dtype}@{lhs4.device} vs "
                         f"{rhs4.dtype}@{rhs4.device}")
    if (n0, k0) != (PACK_TILE, PACK_TILE) or not m0_ok(m0):
        raise ValueError(f"packed kernels take N0 = K0 = {PACK_TILE} and the ops path's "
                         f"M0, got M0={m0}, N0={n0}, K0={k0}")


def gemm_m0(m0: int) -> bool:
    return 1 <= m0 <= GEMV_MAX_ROWS or m0 == PACK_TILE


@functools.cache
def _kernel():
    return build.entry(
        "mmt4d", "mmt4d",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )


def mmt4d(lhs4: torch.Tensor, rhs4: torch.Tensor) -> torch.Tensor:
    """Packed lhs4 x packed rhs4 -> packed (M1, N1, M0, N0) f32.  Plain
    version on the CPU; on a CUDA tensor the kernel runs or this raises."""
    if lhs4.device.type == "cpu":
        return mmt4d_plain(lhs4, rhs4)
    if lhs4.device.type != "cuda":
        raise RuntimeError(f"mmt4d runs on cuda (or cpu: plain), not {lhs4.device}")
    check_packed(lhs4, rhs4, gemm_m0)
    m1, k1, m0, _ = lhs4.shape
    n1, _, n0, _ = rhs4.shape
    lhs4, rhs4 = build.aligned(lhs4), build.aligned(rhs4)
    out4 = torch.empty((m1, n1, m0, n0), dtype=torch.float32, device=lhs4.device)
    err = _kernel()(lhs4.data_ptr(), rhs4.data_ptr(), out4.data_ptr(), m1, m0, n1, k1,
                    build.dtype_code(lhs4.dtype), build.stream_ptr(lhs4.device))
    build.check(err, "mmt4d", "mmt4d launch")
    mmt4d.launches += 1
    return out4


mmt4d.launches = 0
