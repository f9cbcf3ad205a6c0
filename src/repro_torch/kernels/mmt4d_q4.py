"""w4a8 group-quantized projections (counterpart of repro/kernels/mmt4d_q4.py:
fused_gemv_q4_pallas and mmt4d_q4_pallas).

Weights are stored in the packed layout with two's-complement nibbles two
per byte along K0 (byte j of a tile row holds elements 2j low, 2j+1 high)
and one bf16 scale per `group` consecutive K elements:

    rhs4_p (N1, K1, N0, K0/2) uint8      s_w4 (N1, K1, N0, K0/group) bf16

(what the JAX package's code ships: bf16 scales, group ref.Q4_GROUP = 16 by
default and passed by the caller; the kernels take group 16 and 32).

    fused_gemv_q4 : decode -- int8 rows lhs_q (M, K), s_a (M, 1) f32
                    -> (M, N1*N0) f32, M <= GEMV_MAX_ROWS, rows never padded
    mmt4d_q4      : packed int8 rows lhs4_q (M1, K1, M0, K0), s_a (M1, M0)
                    -> (M1, N1, M0, N0) f32; M0 in 1..8 or 128

Both compute (sum_k a_q * w_q * s_group) * s_a, the sum exact in float64
and rounded to f32 once, so kernel and plain version agree bit for bit and
differ from the JAX kernels' f32 sums only by their rounding.  CUDA source:
csrc/mmt4d_q4.cu (what bounds it and how it is laid out is noted there).
The wrappers launch the kernels for CUDA tensors and take the plain versions
(`fused_gemv_q4_plain`, `mmt4d_q4_plain` = ref.mmt4d_q4) only for tensors
on the CPU.

`mmt4d_q4` runs the packed GEMMs' skinny split-K body
(csrc/packed_skinny.cuh) on the nibble weight, for every row count, by
`q4_plan`; the plan and the addresses its TMA and bulk copies read are
mirrored here (`q4_groups`, `q4_grid`, `q4_block_loads`, with `plain=True`
for the plain-row entry) so the CPU tests can hold them.

    mmt4d_q4_rows : int8 rows lhs_q (M, K1*K0), s_a (M,) f32 -> (M, N1*N0)
                    f32, the packed route (pack at M0, mmt4d_q4, unpack) in
                    one launch, bit for bit: the same kernel's plain-row
                    entry, under `q4_plan` at M1 = ceil(M / M0); the ops
                    path's packed route calls it
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.encoding import GEMV_MAX_ROWS, PACK_TILE
from repro_torch.kernels import build
from repro_torch.kernels import fused_gemv as fused_gemv_lib
from repro_torch.kernels import mmt4d as mmt4d_lib
from repro_torch.kernels import ref
from repro_torch.kernels.fused_pack_mmt4d import GEMM_WAVE
from repro_torch.kernels.mmt4d_q8 import check_packed_scales, check_row_scales, packed_scales

KERNEL_GROUPS = (16, 32)

mmt4d_q4_plain = ref.mmt4d_q4


def _check_weight(rhs4_p: torch.Tensor, group: int) -> None:
    if rhs4_p.dim() != 4 or rhs4_p.dtype != torch.uint8:
        raise ValueError(f"want nibble-packed rhs4_p (N1, K1, N0, K0/2) uint8, got "
                         f"{tuple(rhs4_p.shape)} {rhs4_p.dtype}")
    k0 = 2 * rhs4_p.shape[3]
    if k0 % group:
        raise ValueError(f"group {group} does not tile K0 = {k0}")


def _check_kernel(rhs4_p: torch.Tensor, group: int, name: str) -> None:
    """What the CUDA kernels take beyond the plain versions' contract."""
    _, _, n0, k0p = rhs4_p.shape
    if (n0, 2 * k0p) != (PACK_TILE, PACK_TILE) or group not in KERNEL_GROUPS:
        raise ValueError(f"{name} takes {PACK_TILE}x{PACK_TILE} pack tiles and groups "
                         f"{KERNEL_GROUPS}, got tile ({n0}, {2 * k0p}), group {group}")


def _on_card(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{name} runs on cuda (or cpu: plain), not {t.device}")
    return True


def fused_gemv_q4_plain(lhs_q: torch.Tensor, rhs4_p: torch.Tensor, s_a: torch.Tensor,
                        s_w4: torch.Tensor, group: int = ref.Q4_GROUP) -> torch.Tensor:
    """What the GEMV kernel computes, in plain PyTorch: rows x the
    dequantized weight, summed exactly in float64 and rounded to f32 once
    (as ref.mmt4d_q4), then * s_a."""
    n1, k1, n0, k0p = rhs4_p.shape
    w = ref.dequant_rhs4_q4(rhs4_p, s_w4, group, dtype=torch.float64)
    w = ref.unpack(w, (n1 * n0, k1 * 2 * k0p))
    return (lhs_q.double() @ w.t()).float() * s_a


@functools.cache
def gemv_q4_plan(m: int, k1: int, n1: int, group: int) -> tuple[str, int, int]:
    """("warps", GEMV_BN, W) for int8 rows (M, K1*128) x nibbles (N1, K1,
    128, 64) at `group`: the int8 GEMV's blocks (fused_gemv.gemv_q8_plan)."""
    return "warps", fused_gemv_lib.GEMV_BN, fused_gemv_lib.gemv_warps(n1)


@functools.cache
def _gemv_kernel():
    return build.entry(
        "mmt4d_q4", "fused_gemv_q4",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )


def fused_gemv_q4(lhs_q: torch.Tensor, rhs4_p: torch.Tensor, s_a: torch.Tensor,
                  s_w4: torch.Tensor, group: int = ref.Q4_GROUP, plan=None) -> torch.Tensor:
    """int8 rows (M, K) x the nibble-packed weight -> (M, N1*N0) f32.  Plain
    version on the CPU; on a CUDA tensor the kernel runs or this raises.
    `plan` overrides `gemv_q4_plan`."""
    _check_weight(rhs4_p, group)
    n1, k1, n0, k0p = rhs4_p.shape
    m, k = lhs_q.shape
    if k != k1 * 2 * k0p or lhs_q.dtype != torch.int8:
        raise ValueError(f"want int8 lhs_q (M, {k1 * 2 * k0p}), got {tuple(lhs_q.shape)} "
                         f"{lhs_q.dtype}")
    if tuple(s_a.shape) != (m, 1) or s_a.dtype != torch.float32:
        raise ValueError(f"want s_a ({m}, 1) float32, got {tuple(s_a.shape)} {s_a.dtype}")
    if tuple(s_w4.shape) != (n1, k1, n0, 2 * k0p // group):
        raise ValueError(f"s_w4 {tuple(s_w4.shape)} does not match rhs4_p "
                         f"{tuple(rhs4_p.shape)} at group {group}")
    if len({t.device for t in (lhs_q, rhs4_p, s_a, s_w4)}) != 1:
        raise ValueError("w4a8 operands lie on different devices")
    if not _on_card(lhs_q, "fused_gemv_q4"):
        return fused_gemv_q4_plain(lhs_q, rhs4_p, s_a, s_w4, group)
    _check_kernel(rhs4_p, group, "fused_gemv_q4")
    if not 1 <= m <= GEMV_MAX_ROWS or s_w4.dtype != torch.bfloat16:
        raise ValueError(f"fused_gemv_q4 takes 1..{GEMV_MAX_ROWS} rows and bf16 scales, "
                         f"got M={m}, {s_w4.dtype}")
    lhs_q, rhs4_p = build.aligned(lhs_q), build.aligned(rhs4_p)
    s_a, s_w4 = s_a.contiguous(), build.aligned(s_w4)
    out = torch.empty((m, n1 * n0), dtype=torch.float32, device=lhs_q.device)
    plan = (gemv_q4_plan(m, k1, n1, group) if plan is None
            else fused_gemv_lib.check_gemv_plan(plan, "fused_gemv_q4"))
    err = _gemv_kernel()(lhs_q.data_ptr(), rhs4_p.data_ptr(), s_a.data_ptr(), s_w4.data_ptr(),
                         out.data_ptr(), m, n1, k1, group, plan[2], build.stream_ptr(lhs_q.device))
    build.check(err, "mmt4d_q4", "fused_gemv_q4 launch")
    fused_gemv_q4.launches += 1
    return out


fused_gemv_q4.launches = 0


# ---- the packed GEMM's plan and the addresses its copies read ----------------------

Q4_ROWS = mmt4d_lib.SKINNY_ROWS  # rows a block holds at most (64-row slabs at M0 = 128)
# Block widths: Q4_BN columns whose four consumer warps split the K tiles
# (any rows), or Q4_WIDE_BN columns, a warp per 16 on every K tile (blocks
# of 57-64 rows); a warp owns 16 columns either way.
Q4_BN = 16
Q4_WIDE_BN = 64
# Blocks the K split aims at: one per SM of the H100 (132 tied or beat 264
# and 528 at the decode shapes of the sweep).
Q4_TARGET = GEMM_WAVE


def q4_warps(bn: int) -> tuple[int, int]:
    """(consumer warps across N, columns a warp owns) of a bn-column block."""
    return (1, bn) if bn == Q4_BN else (4, bn // 4)


def q4_groups(m1: int, m0: int) -> tuple[int, int]:
    """(rows a block holds, row groups): G = min(M1, 64 // M0) whole row
    blocks, ceil(M1 / G) groups; at M0 > 64, 64-row slabs of one row block,
    M1 * M0 / 64 of them."""
    if m0 > Q4_ROWS:
        return Q4_ROWS, m1 * (m0 // Q4_ROWS)
    g = min(m1, Q4_ROWS // m0)
    return g * m0, -(-m1 // g)


def q4_grid(m1: int, m0: int, n1: int, bn: int, splits: int) -> tuple[int, int, int]:
    """The grid (x: bn-column N slices, y: K splits, z: row groups)."""
    return n1 * PACK_TILE // bn, splits, q4_groups(m1, m0)[1]


@functools.cache
def q4_plan(m1: int, m0: int, n1: int, k1: int) -> tuple[str, int, int]:
    """("skinny", BN, splits) for lhs4 (M1, K1, M0, 128) and N = n1 * 128:
    64-column blocks (a warp per 16 columns, every warp on every K tile)
    where a block holds more than 56 rows and their grid fills a wave, else
    16-column blocks (the four warps split the K tiles); then the least K
    split that brings the grid to Q4_TARGET blocks, at most one a K tile
    (the sweep in PERF.md, section 6: 16-column blocks beat 32 at every
    decode shape, 64 beat 128 at every wide one)."""
    rows, groups = q4_groups(m1, m0)
    wide = rows > Q4_ROWS - 8 and n1 * PACK_TILE // Q4_WIDE_BN * groups >= GEMM_WAVE
    bn = Q4_WIDE_BN if wide else Q4_BN
    x, _, z = q4_grid(m1, m0, n1, bn, 1)
    return "skinny", bn, min(k1, -(-Q4_TARGET // (x * z)))


def q4_block_loads(bx: int, split: int, bz: int, i: int, m1: int, m0: int, k1: int,
                   bn: int, splits: int, group: int, *, plain: bool = False):
    """What block (bx, split, bz) copies at its i-th K tile: the weight box
    (64, bn) in rhs4_p viewed as (N1*K1*128, 64) as (column, row); the scale
    run as (first element, elements) of s_w4 flattened; the rows box origin
    in lhs4 as (k0, m0, k1, m1), innermost first (box (128, M0, 1, G), or
    mmt4d.slab_lhs_box at M0 > 64).  `plain`: the plain-row entry's rows
    box origin in lhs (M, K) as (column, row), box (128, rows a block
    holds), whatever M1 * M0 covers M: row group bz starts at plain row
    bz * rows, the first its packed twin holds."""
    n_base = bx * bn
    kt = mmt4d_lib.skinny_split_range(split, splits, k1)[0] + i
    row = (n_base // PACK_TILE) * k1 * PACK_TILE + n_base % PACK_TILE + kt * PACK_TILE
    gpt = PACK_TILE // group
    if plain:
        rows = (kt * PACK_TILE, bz * q4_groups(m1, m0)[0])
    elif m0 > Q4_ROWS:
        rows = mmt4d_lib.slab_lhs_origin(bz, kt, m0, Q4_ROWS)
    else:
        rows = (0, 0, kt, bz * min(m1, Q4_ROWS // m0))
    return (0, row), (row * gpt, bn * gpt), rows


def q4_launch_args(device: torch.device, m1: int, m0: int, n1: int, k1: int, plan) -> tuple:
    """(bn, splits, part, cnt) for the kernel under `plan`, with the f64
    partials' scratch (two words a partial) when the launch splits."""
    _, bn, splits = plan
    rows, _ = q4_groups(m1, m0)
    if (plan[0] != "skinny" or bn not in (Q4_BN, Q4_WIDE_BN) or not 1 <= splits <= k1
            or (bn == Q4_WIDE_BN and rows <= Q4_ROWS - 8)):
        raise ValueError(f"mmt4d_q4 takes ('skinny', {Q4_BN} (or {Q4_WIDE_BN} for blocks of "
                         f"57-64 rows), 1..{k1} splits), got {plan}")
    if splits == 1:
        return bn, 1, None, None
    x, _, z = q4_grid(m1, m0, n1, bn, splits)
    part, cnt = mmt4d_lib.scratch(device, x * z, x * z * splits * Q4_ROWS * bn * 2)
    return bn, splits, part.data_ptr(), cnt.data_ptr()


@functools.cache
def _gemm_kernel():
    return build.entry(
        "mmt4d_q4", "mmt4d_q4",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3,
    )


def mmt4d_q4(lhs4_q: torch.Tensor, rhs4_p: torch.Tensor, s_a: torch.Tensor,
             s_w4: torch.Tensor, group: int = ref.Q4_GROUP, plan=None) -> torch.Tensor:
    """Packed int8 lhs4_q x the nibble-packed weight -> packed (M1, N1, M0,
    N0) f32.  Plain version on the CPU; on a CUDA tensor the kernel runs or
    this raises.  `plan` overrides `q4_plan`, for measuring other blocks
    and splits."""
    _check_weight(rhs4_p, group)
    if lhs4_q.dim() != 4:
        raise ValueError(f"want lhs4_q (M1, K1, M0, K0), got {tuple(lhs4_q.shape)}")
    m1, k1, m0, k0 = lhs4_q.shape
    n1, k1r, n0, k0p = rhs4_p.shape
    if (k1, k0) != (k1r, 2 * k0p):
        raise ValueError(f"K tiles differ: lhs4_q {tuple(lhs4_q.shape)}, rhs4_p "
                         f"{tuple(rhs4_p.shape)}")
    check_packed_scales(lhs4_q, rhs4_p, s_a, s_w4, s_w_shape=(n1, k1, n0, k0 // group),
                        s_w_dtype=s_w4.dtype)
    if not _on_card(lhs4_q, "mmt4d_q4"):
        return mmt4d_q4_plain(lhs4_q, rhs4_p, s_a, s_w4, group)
    _check_kernel(rhs4_p, group, "mmt4d_q4")
    if not mmt4d_lib.gemm_m0(m0) or s_w4.dtype != torch.bfloat16:
        raise ValueError(f"mmt4d_q4 takes M0 in 1..{GEMV_MAX_ROWS} or {PACK_TILE} and bf16 "
                         f"scales, got M0={m0}, {s_w4.dtype}")
    lhs4_q, rhs4_p = build.aligned(lhs4_q), build.aligned(rhs4_p)
    s_a, s_w4 = s_a.contiguous(), build.aligned(s_w4)
    out4 = torch.empty((m1, n1, m0, n0), dtype=torch.float32, device=lhs4_q.device)
    bn, splits, part, cnt = q4_launch_args(lhs4_q.device, m1, m0, n1, k1,
                                           plan or q4_plan(m1, m0, n1, k1))
    err = _gemm_kernel()(lhs4_q.data_ptr(), rhs4_p.data_ptr(), s_a.data_ptr(), s_w4.data_ptr(),
                         out4.data_ptr(), m1, m0, n1, k1, group, bn, splits, part, cnt,
                         build.stream_ptr(lhs4_q.device))
    build.check(err, "mmt4d_q4", "mmt4d_q4 launch")
    mmt4d_q4.launches += 1
    return out4


mmt4d_q4.launches = 0


# ---- the plain-row entry -----------------------------------------------------------


def mmt4d_q4_rows_plain(xq: torch.Tensor, rhs4_p: torch.Tensor, s_a: torch.Tensor,
                        s_w4: torch.Tensor, group: int, m0: int) -> torch.Tensor:
    """What the plain-row entry computes, in plain PyTorch: the packed
    route ref.unpack(ref.mmt4d_q4(ref.pack(xq, (M0, 128)), ...)), cropped."""
    n1, _, n0, k0p = rhs4_p.shape
    out4 = ref.mmt4d_q4(ref.pack(xq, (m0, 2 * k0p)), rhs4_p, packed_scales(s_a, m0), s_w4,
                        group)
    return ref.unpack(out4, (xq.shape[0], n1 * n0))


@functools.cache
def _rows_kernel():
    return build.entry(
        "mmt4d_q4", "mmt4d_q4_rows",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3,
    )


def mmt4d_q4_rows(xq: torch.Tensor, rhs4_p: torch.Tensor, s_a: torch.Tensor,
                  s_w4: torch.Tensor, group: int, m0: int, plan=None) -> torch.Tensor:
    """int8 rows xq (M, K1*128), s_a (M,) x the nibble-packed weight -> (M,
    N1*N0) f32, under `q4_plan` at M1 = ceil(M / M0) (or `plan`).  Plain
    version on the CPU; on a CUDA tensor the kernel runs or this raises.
    Counts its launches as `mmt4d_q4`'s."""
    _check_weight(rhs4_p, group)
    n1, k1, n0, k0p = rhs4_p.shape
    mmt4d_lib.check_rows(xq, rhs4_p, m0, k1 * 2 * k0p)
    check_row_scales(xq, s_a)
    if tuple(s_w4.shape) != (n1, k1, n0, 2 * k0p // group) or s_w4.device != xq.device:
        raise ValueError(f"s_w4 {tuple(s_w4.shape)} on {s_w4.device} does not match rhs4_p "
                         f"{tuple(rhs4_p.shape)} at group {group}")
    if not _on_card(xq, "mmt4d_q4_rows"):
        return mmt4d_q4_rows_plain(xq, rhs4_p, s_a, s_w4, group, m0)
    _check_kernel(rhs4_p, group, "mmt4d_q4_rows")
    if s_w4.dtype != torch.bfloat16:
        raise ValueError(f"mmt4d_q4_rows takes bf16 scales, got {s_w4.dtype}")
    m = xq.shape[0]
    m1 = -(-m // m0)
    xq, rhs4_p = build.aligned(xq), build.aligned(rhs4_p)
    s_a, s_w4 = s_a.contiguous(), build.aligned(s_w4)
    out = torch.empty((m, n1 * n0), dtype=torch.float32, device=xq.device)
    bn, splits, part, cnt = q4_launch_args(xq.device, m1, m0, n1, k1,
                                           plan or q4_plan(m1, m0, n1, k1))
    err = _rows_kernel()(xq.data_ptr(), rhs4_p.data_ptr(), s_a.data_ptr(), s_w4.data_ptr(),
                         out.data_ptr(), m, m0, n1, k1, group, bn, splits, part, cnt,
                         build.stream_ptr(xq.device))
    build.check(err, "mmt4d_q4", "mmt4d_q4_rows launch")
    mmt4d_q4.launches += 1
    return out
