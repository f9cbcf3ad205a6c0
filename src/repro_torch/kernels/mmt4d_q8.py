"""w8a8 packed-layout GEMM (counterpart of repro/kernels/mmt4d_q8.py:
mmt4d_q8_pallas).

    lhs4_q : (M1, K1, M0, K0) int8   packed activation rows: M0 in 1..8 at
                                     decode, 128 at prefill
    rhs4_q : (N1, K1, N0, K0) int8   packed weight, N0 = K0 = 128
    s_a    : (M1, M0) f32            per-row activation scales
    s_w    : (N1, N0) f32            per-output-channel weight scales
    out4   : (M1, N1, M0, N0) f32    (float(int32 sum) * s_a) * s_w, packed

CUDA source: csrc/mmt4d_q8.cu (what bounds it and how it is laid out is
noted there).  `mmt4d_q8` launches the kernel for CUDA tensors and takes the
plain version `mmt4d_q8_plain` (= ref.mmt4d_q8) only for tensors on the CPU.
The kernel runs the bf16 packed GEMM's two bodies in int8 (the skinny
split-K body for few rows, the TMA + wgmma pipeline for wide windows), by
`mmt4d.mmt4d_plan`.

`mmt4d_q8_rows` is the same kernel's plain-row entry, the one the ops
path's packed route calls: int8 rows (M, K1*128) and their scales s_a (M,)
in, (M, N1*128) f32 out, equal to the packed route (pack the rows at M0,
pad s_a with zeros, mmt4d_q8, unpack) bit for bit in one launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import mmt4d as mmt4d_lib
from repro_torch.kernels import ref

mmt4d_q8_plain = ref.mmt4d_q8


def check_packed_scales(lhs4: torch.Tensor, rhs4: torch.Tensor, s_a: torch.Tensor,
                        s_w: torch.Tensor, *, s_w_shape: tuple[int, ...],
                        s_w_dtype: torch.dtype) -> None:
    """Scale contract shared by the quantized packed GEMMs: s_a (M1, M0) f32,
    s_w of `s_w_shape` and `s_w_dtype`, all on the operands' device."""
    m1, _, m0, _ = lhs4.shape
    if tuple(s_a.shape) != (m1, m0) or s_a.dtype != torch.float32:
        raise ValueError(f"want s_a ({m1}, {m0}) float32, got {tuple(s_a.shape)} {s_a.dtype}")
    if tuple(s_w.shape) != s_w_shape or s_w.dtype != s_w_dtype:
        raise ValueError(f"want weight scales {s_w_shape} {s_w_dtype}, got "
                         f"{tuple(s_w.shape)} {s_w.dtype}")
    if lhs4.dtype != torch.int8:
        raise TypeError(f"quantized GEMM rows are int8, got {lhs4.dtype}")
    if len({t.device for t in (lhs4, rhs4, s_a, s_w)}) != 1:
        raise ValueError("quantized GEMM operands lie on different devices")


@functools.cache
def _kernel():
    return build.entry(
        "mmt4d_q8", "mmt4d_q8",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3,
    )


def mmt4d_q8(lhs4_q: torch.Tensor, rhs4_q: torch.Tensor, s_a: torch.Tensor,
             s_w: torch.Tensor, plan=None) -> torch.Tensor:
    """Packed int8 lhs4_q x packed int8 rhs4_q -> packed (M1, N1, M0, N0)
    f32 with the scale epilogue.  Plain version on the CPU; on a CUDA tensor
    the kernel runs or this raises.  `plan` overrides `mmt4d_plan`, for
    measuring either body."""
    n1, _, n0, _ = rhs4_q.shape
    check_packed_scales(lhs4_q, rhs4_q, s_a, s_w, s_w_shape=(n1, n0), s_w_dtype=torch.float32)
    if lhs4_q.device.type == "cpu":
        return mmt4d_q8_plain(lhs4_q, rhs4_q, s_a, s_w)
    if lhs4_q.device.type != "cuda":
        raise RuntimeError(f"mmt4d_q8 runs on cuda (or cpu: plain), not {lhs4_q.device}")
    mmt4d_lib.check_packed(lhs4_q, rhs4_q, mmt4d_lib.gemm_m0)
    m1, k1, m0, _ = lhs4_q.shape
    lhs4_q, rhs4_q = build.aligned(lhs4_q), build.aligned(rhs4_q)
    s_a, s_w = s_a.contiguous(), s_w.contiguous()
    out4 = torch.empty((m1, n1, m0, n0), dtype=torch.float32, device=lhs4_q.device)
    wide, bm, bn, splits, part, cnt = mmt4d_lib.launch_args(
        lhs4_q.device, m1, m0, n1, k1, plan or mmt4d_lib.mmt4d_plan(m1, m0, n1, k1))
    err = _kernel()(lhs4_q.data_ptr(), rhs4_q.data_ptr(), s_a.data_ptr(), s_w.data_ptr(),
                    out4.data_ptr(), m1, m0, n1, k1, wide, bm, bn, splits, part, cnt,
                    build.stream_ptr(lhs4_q.device))
    build.check(err, "mmt4d_q8", "mmt4d_q8 launch")
    mmt4d_q8.launches += 1
    return out4


mmt4d_q8.launches = 0


# ---- the plain-row entry -----------------------------------------------------------


def packed_scales(s_a: torch.Tensor, m0: int) -> torch.Tensor:
    """Plain s_a (M,) as the packed route gives it: (ceil(M / M0), M0), pad
    rows 0."""
    m1 = -(-s_a.shape[0] // m0)
    return F.pad(s_a, (0, m1 * m0 - s_a.shape[0])).reshape(m1, m0)


def check_row_scales(x: torch.Tensor, s_a: torch.Tensor) -> None:
    """The plain-row entries' scale contract: int8 rows, s_a (M,) f32 on
    their device."""
    if x.dtype != torch.int8:
        raise TypeError(f"quantized GEMM rows are int8, got {x.dtype}")
    if tuple(s_a.shape) != (x.shape[0],) or s_a.dtype != torch.float32 or s_a.device != x.device:
        raise ValueError(f"want s_a ({x.shape[0]},) float32 on {x.device}, got "
                         f"{tuple(s_a.shape)} {s_a.dtype} on {s_a.device}")


def mmt4d_q8_rows_plain(xq: torch.Tensor, rhs4_q: torch.Tensor, s_a: torch.Tensor,
                        s_w: torch.Tensor, m0: int) -> torch.Tensor:
    """What the plain-row entry computes, in plain PyTorch: the packed
    route ref.unpack(ref.mmt4d_q8(ref.pack(xq, (M0, 128)), ...)), cropped."""
    n1, _, n0, k0 = rhs4_q.shape
    out4 = ref.mmt4d_q8(ref.pack(xq, (m0, k0)), rhs4_q, packed_scales(s_a, m0), s_w)
    return ref.unpack(out4, (xq.shape[0], n1 * n0))


@functools.cache
def _rows_kernel():
    return build.entry(
        "mmt4d_q8", "mmt4d_q8_rows",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3,
    )


def mmt4d_q8_rows(xq: torch.Tensor, rhs4_q: torch.Tensor, s_a: torch.Tensor,
                  s_w: torch.Tensor, m0: int, plan=None) -> torch.Tensor:
    """int8 rows xq (M, K1*128), s_a (M,) x packed int8 rhs4_q -> (M,
    N1*N0) f32 with the scale epilogue, under `mmt4d_plan` at M1 = ceil(M /
    M0) (or `plan`).  Plain version on the CPU; on a CUDA tensor the kernel
    runs or this raises.  Counts its launches as `mmt4d_q8`'s."""
    n1, k1, n0, k0 = rhs4_q.shape
    mmt4d_lib.check_rows(xq, rhs4_q, m0, k1 * k0)
    check_row_scales(xq, s_a)
    if tuple(s_w.shape) != (n1, n0) or s_w.dtype != torch.float32 or s_w.device != xq.device:
        raise ValueError(f"want s_w ({n1}, {n0}) float32 on {xq.device}, got "
                         f"{tuple(s_w.shape)} {s_w.dtype} on {s_w.device}")
    if xq.device.type == "cpu":
        return mmt4d_q8_rows_plain(xq, rhs4_q, s_a, s_w, m0)
    if xq.device.type != "cuda":
        raise RuntimeError(f"mmt4d_q8_rows runs on cuda (or cpu: plain), not {xq.device}")
    if rhs4_q.dtype != torch.int8 or (n0, k0) != (128, 128):
        raise ValueError(f"want a packed int8 weight of 128x128 tiles, got "
                         f"{tuple(rhs4_q.shape)} {rhs4_q.dtype}")
    m = xq.shape[0]
    m1 = -(-m // m0)
    xq, rhs4_q = build.aligned(xq), build.aligned(rhs4_q)
    s_a, s_w = s_a.contiguous(), s_w.contiguous()
    out = torch.empty((m, n1 * n0), dtype=torch.float32, device=xq.device)
    wide, bm, bn, splits, part, cnt = mmt4d_lib.launch_args(
        xq.device, m1, m0, n1, k1, plan or mmt4d_lib.mmt4d_plan(m1, m0, n1, k1))
    err = _rows_kernel()(xq.data_ptr(), rhs4_q.data_ptr(), s_a.data_ptr(), s_w.data_ptr(),
                         out.data_ptr(), m, m0, n1, k1, wide, bm, bn, splits, part, cnt,
                         build.stream_ptr(xq.device))
    build.check(err, "mmt4d_q8", "mmt4d_q8_rows launch")
    mmt4d_q8.launches += 1
    return out
