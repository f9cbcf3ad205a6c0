"""Packed-layout decode GEMV (counterpart of repro/kernels/mmt4d_gemv.py:
mmt4d_gemv_pallas).

    lhs4 : (1, K1, M0, K0)    one packed row block, M0 <= GEMV_MAX_ROWS
    rhs4 : (N1, K1, N0, K0)   packed weight, streamed once
    out4 : (1, N1, M0, N0)    f32, packed

CUDA source: csrc/mmt4d_gemv.cu.  `mmt4d_gemv` launches the kernel for CUDA
tensors and takes the plain version `mmt4d_gemv_plain` only on the CPU.  In
bf16 it is the packed GEMM's skinny body at M1 = 1 (csrc/packed_skinny.cuh),
with the K split of `mmt4d.mmt4d_plan`.

`mmt4d_gemv_rows` is its plain-row entry, the one the ops path's packed
decode route calls: rows x (M <= 8, K1*128) in, (M, N1*128) f32 out, equal
to unpack(mmt4d_gemv(pack(x, (M, 128)))) bit for bit in one launch (bf16:
the same body, plan and sums entered with plain rows, as the decode GEMV
of kernels/fused_gemv.py is; f32: the same kernel on plain rows).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.encoding import GEMV_MAX_ROWS, PACK_TILE
from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.mmt4d import (check_packed, check_rows, launch_args, mmt4d_plan,
                                       mmt4d_rows_plain)


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


def mmt4d_gemv_rows_plain(x: torch.Tensor, rhs4: torch.Tensor) -> torch.Tensor:
    """What the plain-row entry computes, in plain PyTorch: the packed
    route at one row block of M0 = M rows, unpacked."""
    return mmt4d_rows_plain(x, rhs4, x.shape[0])


@functools.cache
def _rows_kernel():
    return build.entry(
        "mmt4d_gemv", "mmt4d_gemv_rows",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3,
    )


def mmt4d_gemv_rows(x: torch.Tensor, rhs4: torch.Tensor) -> torch.Tensor:
    """Plain rows x (M <= 8, K1*128) x packed rhs4 -> (M, N1*N0) f32, the
    packed GEMV's result unpacked, bit for bit.  Plain version on the CPU;
    on a CUDA tensor the kernel runs or this raises.  Counts its launches as
    `mmt4d_gemv`'s."""
    n1, k1, n0, k0 = rhs4.shape
    m = x.shape[0] if x.dim() == 2 else 0
    if not 1 <= m <= GEMV_MAX_ROWS:
        raise ValueError(f"mmt4d_gemv_rows takes 1..{GEMV_MAX_ROWS} rows, got {tuple(x.shape)}")
    check_rows(x, rhs4, m, k1 * k0)
    if x.device.type == "cpu":
        return mmt4d_gemv_rows_plain(x, rhs4)
    if x.device.type != "cuda":
        raise RuntimeError(f"mmt4d_gemv_rows runs on cuda (or cpu: plain), not {x.device}")
    if x.dtype != rhs4.dtype or (n0, k0) != (PACK_TILE, PACK_TILE):
        raise ValueError(f"want {rhs4.dtype} rows and {PACK_TILE}x{PACK_TILE} pack tiles, got "
                         f"{x.dtype} and {tuple(rhs4.shape)}")
    x, rhs4 = build.aligned(x), build.aligned(rhs4)
    out = torch.empty((m, n1 * n0), dtype=torch.float32, device=x.device)
    splits, part, cnt = 1, None, None
    if x.dtype == torch.bfloat16:
        _, _, _, splits, part, cnt = launch_args(x.device, 1, m, n1, k1, mmt4d_plan(1, m, n1, k1))
    err = _rows_kernel()(x.data_ptr(), rhs4.data_ptr(), out.data_ptr(), m, n1, k1,
                         build.dtype_code(x.dtype), splits, part, cnt, build.stream_ptr(x.device))
    build.check(err, "mmt4d_gemv", "mmt4d_gemv_rows launch")
    mmt4d_gemv.launches += 1
    return out
