"""Prefill GEMM: plain activation rows x packed weight, pack and unpack inside
the kernel (counterpart of repro/kernels/fused_pack_mmt4d.py:
fused_pack_mmt4d_pallas).

    lhs  : (M, K1*K0)         plain rows, any M (ragged rows masked in-kernel)
    rhs4 : (N1, K1, N0, K0)   packed weight
    out  : (M, N1*N0) f32     plain

CUDA source: csrc/fused_pack_mmt4d.cu (its bf16 pipeline is
csrc/gemm_wgmma.cuh, which the packed GEMM's wide windows share).
`fused_pack_mmt4d` launches the kernel for CUDA tensors and takes the plain
version only on the CPU.  The
bf16 kernel's block tile comes from `gemm_tile_plan`, and
`gemm_block_loads` mirrors where each block's TMA copies read, so the CPU
tests hold both.
"""

from __future__ import annotations

import ctypes
import functools

import torch

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


def fused_pack_mmt4d_plain(lhs: torch.Tensor, rhs4: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: the paper's pack -> mmt4d
    -> unpack with f32 accumulation."""
    n1, k1, n0, k0 = rhs4.shape
    m = lhs.shape[0]
    out4 = ref.mmt4d(ref.pack(lhs, (n0, k0)), rhs4)
    return ref.unpack(out4, (m, n1 * n0))


# The bf16 kernel's block tiles (BM, BN), largest first, and the blocks of
# one full wave: one per SM of the H100.  (64 x 128 would never be chosen: a
# 128 x 64 grid has at least as many blocks.)
GEMM_TILES = ((128, 128), (128, 64), (64, 64))
GEMM_WAVE = 132
GEMM_K_STEP = 64  # K a pipeline stage


def gemm_grid(m: int, n1: int, bm: int, bn: int) -> tuple[int, int]:
    """The bf16 kernel's grid (x: N tiles, y: M tiles) for tile (bm, bn)."""
    return n1 * 128 // bn, -(-m // bm)


def gemm_tile_plan(m: int, n1: int) -> tuple[int, int]:
    """(BM, BN) of the bf16 kernel at M rows and N = n1 * 128: the largest
    tile of GEMM_TILES whose grid still fills one wave of GEMM_WAVE blocks,
    else the smallest (the most blocks the shape allows).  K does not enter:
    every block walks all of it."""
    for bm, bn in GEMM_TILES:
        gx, gy = gemm_grid(m, n1, bm, bn)
        if gx * gy >= GEMM_WAVE:
            return bm, bn
    return GEMM_TILES[-1]


def gemm_block_loads(bx: int, by: int, step: int, bm: int, bn: int,
                     k1: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """The (column, row) origins of the two TMA boxes block (bx, by) loads at
    K step `step` (0 .. 2*k1 - 1), as the kernel computes them: lhs's
    (64, bm) box in its (M, K) map, and the weight's (64, bn) box in rhs4
    viewed as (N1*K1*128, 128) -- packed tile (nt, kt) at rows
    (nt*K1 + kt)*128 .., the block's N offset within it added."""
    n_base = bx * bn
    row0 = (n_base // 128) * k1 * 128 + n_base % 128
    return ((step * GEMM_K_STEP, by * bm),
            ((step & 1) * GEMM_K_STEP, row0 + (step >> 1) * 128))


@functools.cache
def _kernel():
    return build.entry(
        "fused_pack_mmt4d", "fused_pack_mmt4d",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
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
    bm, bn = gemm_tile_plan(m, n1)
    err = _kernel()(lhs.data_ptr(), rhs4.data_ptr(), out.data_ptr(), m, n1, k1, bm, bn,
                    build.dtype_code(lhs.dtype), build.stream_ptr(lhs.device))
    build.check(err, "fused_pack_mmt4d", "fused_pack_mmt4d launch")
    fused_pack_mmt4d.launches += 1
    return out


fused_pack_mmt4d.launches = 0
