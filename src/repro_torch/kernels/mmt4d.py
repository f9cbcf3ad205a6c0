"""Packed-layout GEMM (counterpart of repro/kernels/mmt4d.py: mmt4d_pallas).

    lhs4 : (M1, K1, M0, K0)   packed rows: M0 in 1..8 at decode, 128 at prefill
    rhs4 : (N1, K1, N0, K0)   packed weight, N0 = K0 = 128
    out4 : (M1, N1, M0, N0)   f32, packed

CUDA source: csrc/mmt4d.cu (what bounds it and how it is laid out is noted
there).  `mmt4d` launches the kernel for CUDA tensors and takes the plain
version `mmt4d_plain` (= ref.mmt4d) only for tensors on the CPU.

`mmt4d_rows` is the same kernel's plain-row entry, the one the ops path's
packed route calls: rows x (M, K1*128) in, (M, N1*128) f32 out, under the
plan of the packed entry at lhs4 (ceil(M / M0), K1, M0, 128), equal to
unpack(mmt4d(pack(x)))[:M] bit for bit.  The activation pack is its TMA
boxes' addressing and the output unpack its epilogue's, so the route makes
one launch, not three.  Plain version `mmt4d_rows_plain` on the CPU.

The bf16 kernel runs one of two bodies, by `mmt4d_plan`: the skinny split-K
body (csrc/packed_skinny.cuh; the packed GEMV's, the plain-row decode
GEMV's and the int8 GEMM's too) for few rows, or the TMA + wgmma pipeline
(csrc/gemm_wgmma.cuh, the prefill GEMM's and the int8 GEMM's) for wide
windows.  The plans and the addresses each body's TMA copies read are
mirrored here (`skinny_split_range`, `skinny_block_loads`,
`wide_lhs_box`, `wide_lhs_origin`; `itemsize` 2 for bf16, 1 for int8;
`slab_lhs_box`, `slab_lhs_origin` for the int4 GEMM's prefill slabs; and
the plain-row entries' `skinny_plain_loads`, `skinny_plain_box`,
`wide_plain_box`, `wide_plain_origin`, `slab_plain_origin`) so the CPU
tests can hold them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.encoding import GEMV_MAX_ROWS, PACK_TILE
from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.fused_pack_mmt4d import (GEMM_K_STEP, GEMM_WAVE, gemm_grid,
                                                  gemm_tile_plan)

mmt4d_plain = ref.mmt4d

SKINNY_BN = 32    # output columns (weight rows) a skinny block owns
SKINNY_ROWS = 64  # packed rows a skinny block holds at most
# Rows up to which bf16 always takes the skinny body; above them the wide
# body where its grid fills one wave (PERF.md, section 6: the crossover
# measured at 64, 128 and 256 rows).
SKINNY_MAX_ROWS = 64
# Blocks the skinny grid's K split aims at: one per SM of the H100 (132
# beat 264 and 528 at every measured shape: a split costs a merge).
SKINNY_TARGET = GEMM_WAVE
# The plain-row entry's box over lhs (M <= 8, K), (K, M) extents innermost
# first: 64 bf16 columns of the rows padded to 8 (TMA reads the rows past M
# as zeros).
SKINNY_PLAIN_BOX = (GEMM_K_STEP, 8)
# M0s whose row blocks the wide body's rank-4 box lands whole (M0 divides
# the 64- and 128-row tiles) or in whole slabs (the tiles divide M0).
WIDE_M0 = (1, 2, 4, 8, PACK_TILE)


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


# ---- the plan ---------------------------------------------------------------------


def skinny_groups(m1: int, m0: int) -> tuple[int, int]:
    """(G, groups): the row blocks a skinny block holds, min(M1, 64 // M0),
    and the grid's row groups, ceil(M1 / G)."""
    g = min(m1, SKINNY_ROWS // m0)
    return g, -(-m1 // g)


def skinny_grid(m1: int, m0: int, n1: int, splits: int) -> tuple[int, int, int]:
    """The skinny grid (x: 32-column N slices, y: K splits, z: row groups)."""
    return n1 * PACK_TILE // SKINNY_BN, splits, skinny_groups(m1, m0)[1]


@functools.cache
def mmt4d_plan(m1: int, m0: int, n1: int, k1: int) -> tuple[str, int, int]:
    """The bf16 and int8 kernels' plan at lhs4 (M1, K1, M0, 128) and N =
    n1 * 128 (int8 takes the same bodies, tiles and crossover: the int8
    sweep in PERF.md, section 6):
    ("wide", BM, BN) -- the wgmma pipeline with the prefill GEMM's tile at
    these rows -- for M0 = 128, and for more than SKINNY_MAX_ROWS rows at an
    M0 its box can land where that tile's grid fills one wave; else
    ("skinny", BN, splits) with the least split count that brings the grid
    to SKINNY_TARGET blocks, at most one split per K tile (the wide body
    walks all of K in every block, so a grid short of a wave leaves SMs
    idle that the skinny body's split would fill)."""
    rows = m1 * m0
    if m0 == PACK_TILE or (m0 in WIDE_M0 and rows > SKINNY_MAX_ROWS):
        bm, bn = gemm_tile_plan(rows, n1)
        gx, gy = gemm_grid(rows, n1, bm, bn)
        if m0 == PACK_TILE or gx * gy >= GEMM_WAVE:
            return "wide", bm, bn
    x, _, z = skinny_grid(m1, m0, n1, 1)
    splits = min(k1, -(-SKINNY_TARGET // (x * z)))
    return "skinny", SKINNY_BN, splits


def skinny_split_range(split: int, splits: int, k1: int) -> tuple[int, int]:
    """Packed K tiles [lo, hi) of split `split` of `splits`, as the kernel
    computes them: balanced, none empty while splits <= K1."""
    return split * k1 // splits, (split + 1) * k1 // splits


def box_k(itemsize: int) -> int:
    """K elements of a TMA box row: 128 bytes (64 bf16, 128 int8)."""
    return 128 // itemsize


def skinny_block_loads(bx: int, split: int, bz: int, i: int, m1: int, m0: int,
                       splits: int, k1: int, itemsize: int = 2):
    """The TMA box origins skinny block (bx, split, bz) loads at its i-th K
    tile: the weight boxes (box_k, 32) in rhs4 viewed as (N1*K1*128, 128)
    as (column, row), and the row boxes (box_k, M0, 1, G) in lhs4 as (k0,
    m0, k1, m1) coordinates, innermost first; a packed K tile is two boxes
    in bf16, one in int8."""
    g, _ = skinny_groups(m1, m0)
    n_base = bx * SKINNY_BN
    kt = skinny_split_range(split, splits, k1)[0] + i
    row = (n_base // PACK_TILE) * k1 * PACK_TILE + n_base % PACK_TILE + kt * PACK_TILE
    k0s = range(0, PACK_TILE, box_k(itemsize))
    return (tuple((k0, row) for k0 in k0s),
            tuple((k0, 0, kt, bz * g) for k0 in k0s))


def skinny_plain_loads(bx: int, split: int, i: int, m: int, splits: int, k1: int, *,
                       m0: int | None = None, bz: int = 0, itemsize: int = 2):
    """The TMA box origins of plain-row skinny block (bx, split, bz) at its
    i-th K tile: the weight boxes as `skinny_block_loads` at the packed
    twin's M1 = ceil(M / M0), and the row boxes (`skinny_plain_box`) in
    lhs (M, K) as (column, row), one per box_k(itemsize) K elements: block
    row group bz starts at plain row bz * G * M0, the first row its packed
    twin's block holds.  `m0` None: the decode GEMV's one row block of M0 =
    M rows (its box of 8 rows, SKINNY_PLAIN_BOX)."""
    m0 = m0 or m
    m1 = -(-m // m0)
    weight, _ = skinny_block_loads(bx, split, bz, i, m1, m0, splits, k1, itemsize)
    kt = skinny_split_range(split, splits, k1)[0] + i
    row = bz * skinny_groups(m1, m0)[0] * m0
    return weight, tuple((kt * PACK_TILE + k0, row)
                         for k0 in range(0, PACK_TILE, box_k(itemsize)))


def skinny_plain_box(m: int, m0: int, itemsize: int = 2) -> tuple[int, int]:
    """The 2-D box over lhs (M, K) of the packed GEMMs' plain-row entry on
    the skinny body, (K, rows) extents innermost first: the G * M0 rows of
    the packed twin's row group (csrc/packed_skinny.cuh: launch_skinny_rows)."""
    m1 = -(-m // m0)
    return box_k(itemsize), skinny_groups(m1, m0)[0] * m0


def slab_plain_origin(bz: int, kt: int, slab: int) -> tuple[int, int]:
    """The plain-row counterpart of `slab_lhs_origin`: slab block row bz at
    packed K tile kt reads the (128, slab) box of int8 lhs (M, K) at (kt *
    128, bz * slab), the rows of slab bz % (M0 / slab) of row block bz //
    (M0 / slab)."""
    return kt * PACK_TILE, bz * slab


def slab_lhs_box(slab: int) -> tuple[int, int, int, int]:
    """The rank-4 box over int8 lhs4 (M1, K1, M0, 128) of a skinny block
    that holds one slab of `slab` rows of a row block (M0 > SKINNY_ROWS: the
    prefill's M0 = 128; csrc/packed_skinny.cuh: SkSlabRows), (K0, M0, K1,
    M1) extents innermost first: one 128-byte box a packed K tile."""
    return PACK_TILE, slab, 1, 1


def slab_lhs_origin(bz: int, kt: int, m0: int, slab: int) -> tuple[int, int, int, int]:
    """The origin of slab block row `bz`'s box at packed K tile `kt`, as
    SkSlabRows computes it: bz = m1 * (M0 / slab) + the slab."""
    per = m0 // slab
    return 0, (bz % per) * slab, kt, bz // per


def wide_lhs_box(m0: int, bm: int, itemsize: int = 2) -> tuple[int, int, int, int]:
    """The wide body's rank-4 box over lhs4, (K0, M0, K1, M1) extents
    innermost first: a (bm, box_k) slab of flattened rows."""
    return box_k(itemsize), min(m0, bm), 1, max(1, bm // m0)


def wide_lhs_origin(by: int, step: int, m0: int, bm: int,
                    itemsize: int = 2) -> tuple[int, int, int, int]:
    """The origin of block row `by`'s lhs box at K step `step` (0 ..
    K1 * boxes - 1: two boxes a packed tile in bf16, one in int8), as the
    kernel's PackedRows policy computes it."""
    boxes = PACK_TILE // box_k(itemsize)
    m_base = by * bm
    b1 = m_base // m0
    return (step % boxes) * box_k(itemsize), m_base - b1 * m0, step // boxes, b1


def wide_plain_box(bm: int, itemsize: int = 2) -> tuple[int, int]:
    """The wide body's 2-D box over plain rows lhs (M, K), (K, rows)
    extents innermost first (gemm_wgmma.cuh: PlainRows)."""
    return box_k(itemsize), bm


def wide_plain_origin(by: int, step: int, bm: int, itemsize: int = 2) -> tuple[int, int]:
    """The origin of block row `by`'s plain box at K step `step`, as
    (column, row): the rows and K slab of `wide_lhs_origin`'s box."""
    return step * box_k(itemsize), by * bm


# ---- scratch ----------------------------------------------------------------------

# Per device: the skinny body's partials (f32, or int32 in the same words
# for int8) and its arrival counters (zero between launches: the last block
# of a tile resets its own), grown to the largest size asked for.  Every
# skinny launch on the device's stream shares them: one launch ends before
# the next begins.
_scratch: dict = {}


def scratch(device: torch.device, tiles: int, part_words: int):
    """(part, cnt) of at least `part_words` 4-byte words and `tiles` zeroed
    counters, shared by every skinny launch on `device` (f64 partials take
    two words each)."""
    part, cnt = _scratch.get(device, (None, None))
    if part is None or part.numel() < part_words:
        part = torch.empty(part_words, dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < tiles:
        cnt = torch.zeros(tiles, dtype=torch.int32, device=device)
    _scratch[device] = (part, cnt)
    return part, cnt


def skinny_scratch(device: torch.device, m1: int, m0: int, n1: int, splits: int):
    """(part, cnt) for a skinny launch, or (None, None) when it does not split."""
    if splits == 1:
        return None, None
    x, _, z = skinny_grid(m1, m0, n1, splits)
    tiles = x * z
    return scratch(device, tiles, tiles * splits * SKINNY_ROWS * SKINNY_BN)


def launch_args(device: torch.device, m1: int, m0: int, n1: int, k1: int, plan) -> tuple:
    """The kernel's plan arguments (wide, bm, bn, splits, part, cnt) for
    lhs4 (M1, K1, M0, 128) under `plan`; part and cnt are the scratch's
    addresses (the cache keeps the tensors alive), None when the launch
    does not split."""
    if plan[0] == "wide":
        return 1, plan[1], plan[2], 1, None, None
    if plan[1] != SKINNY_BN or not 1 <= plan[2] <= k1:
        raise ValueError(f"skinny plan takes BN={SKINNY_BN} and 1..{k1} splits, got {plan}")
    part, cnt = skinny_scratch(device, m1, m0, n1, plan[2])
    if part is None:
        return 0, 0, 0, plan[2], None, None
    return 0, 0, 0, plan[2], part.data_ptr(), cnt.data_ptr()


@functools.cache
def _kernel():
    return build.entry(
        "mmt4d", "mmt4d",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3,
    )


def mmt4d(lhs4: torch.Tensor, rhs4: torch.Tensor, plan=None) -> torch.Tensor:
    """Packed lhs4 x packed rhs4 -> packed (M1, N1, M0, N0) f32.  Plain
    version on the CPU; on a CUDA tensor the kernel runs or this raises.
    `plan` (bf16 only) overrides `mmt4d_plan`, for measuring either body."""
    if lhs4.device.type == "cpu":
        return mmt4d_plain(lhs4, rhs4)
    if lhs4.device.type != "cuda":
        raise RuntimeError(f"mmt4d runs on cuda (or cpu: plain), not {lhs4.device}")
    check_packed(lhs4, rhs4, gemm_m0)
    m1, k1, m0, _ = lhs4.shape
    n1, _, n0, _ = rhs4.shape
    lhs4, rhs4 = build.aligned(lhs4), build.aligned(rhs4)
    out4 = torch.empty((m1, n1, m0, n0), dtype=torch.float32, device=lhs4.device)
    wide, bm, bn, splits, part, cnt = 0, 0, 0, 1, None, None
    if lhs4.dtype == torch.bfloat16:
        wide, bm, bn, splits, part, cnt = launch_args(
            lhs4.device, m1, m0, n1, k1, plan or mmt4d_plan(m1, m0, n1, k1))
    err = _kernel()(lhs4.data_ptr(), rhs4.data_ptr(), out4.data_ptr(), m1, m0, n1, k1,
                    build.dtype_code(lhs4.dtype), wide, bm, bn, splits, part, cnt,
                    build.stream_ptr(lhs4.device))
    build.check(err, "mmt4d", "mmt4d launch")
    mmt4d.launches += 1
    return out4


mmt4d.launches = 0


# ---- the plain-row entry -----------------------------------------------------------


def mmt4d_rows_plain(x: torch.Tensor, rhs4: torch.Tensor, m0: int) -> torch.Tensor:
    """What the plain-row entry computes, in plain PyTorch: the packed
    route ref.unpack(ref.mmt4d(ref.pack(x, (M0, 128)), rhs4)), cropped to
    x's M rows."""
    n1, _, n0, k0 = rhs4.shape
    return ref.unpack(ref.mmt4d(ref.pack(x, (m0, k0)), rhs4), (x.shape[0], n1 * n0))


def check_rows(x: torch.Tensor, rhs4: torch.Tensor, m0: int, k_packed: int) -> None:
    """Contract of the plain-row entries: x (M, K1*128) on rhs4's device,
    M0 one the packed twin takes."""
    if x.dim() != 2 or x.shape[1] != k_packed or x.shape[0] < 1:
        raise ValueError(f"want rows (M, {k_packed}), got {tuple(x.shape)}")
    if x.device != rhs4.device:
        raise ValueError(f"operands lie on {x.device} and {rhs4.device}")
    if not gemm_m0(m0):
        raise ValueError(f"the packed GEMMs take M0 in 1..{GEMV_MAX_ROWS} or {PACK_TILE}, "
                         f"got {m0}")


@functools.cache
def _rows_kernel():
    return build.entry(
        "mmt4d", "mmt4d_rows",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3,
    )


def mmt4d_rows(x: torch.Tensor, rhs4: torch.Tensor, m0: int, plan=None) -> torch.Tensor:
    """Plain rows x (M, K1*128) x packed rhs4 -> (M, N1*N0) f32: the packed
    route unpack(mmt4d(pack(x, (M0, 128))))[:M] in one launch, bit for bit,
    under `mmt4d_plan` at M1 = ceil(M / M0) (or `plan`, bf16 only).  Plain
    version on the CPU; on a CUDA tensor the kernel runs or this raises.
    Counts its launches as `mmt4d`'s."""
    n1, k1, n0, k0 = rhs4.shape
    check_rows(x, rhs4, m0, k1 * k0)
    if x.device.type == "cpu":
        return mmt4d_rows_plain(x, rhs4, m0)
    if x.device.type != "cuda":
        raise RuntimeError(f"mmt4d_rows runs on cuda (or cpu: plain), not {x.device}")
    if x.dtype != rhs4.dtype or (n0, k0) != (PACK_TILE, PACK_TILE):
        raise ValueError(f"want {rhs4.dtype} rows and {PACK_TILE}x{PACK_TILE} pack tiles, got "
                         f"{x.dtype} and {tuple(rhs4.shape)}")
    m = x.shape[0]
    m1 = -(-m // m0)
    x, rhs4 = build.aligned(x), build.aligned(rhs4)
    out = torch.empty((m, n1 * n0), dtype=torch.float32, device=x.device)
    wide, bm, bn, splits, part, cnt = 0, 0, 0, 1, None, None
    if x.dtype == torch.bfloat16:
        wide, bm, bn, splits, part, cnt = launch_args(
            x.device, m1, m0, n1, k1, plan or mmt4d_plan(m1, m0, n1, k1))
    err = _rows_kernel()(x.data_ptr(), rhs4.data_ptr(), out.data_ptr(), m, m0, n1, k1,
                         build.dtype_code(x.dtype), wide, bm, bn, splits, part, cnt,
                         build.stream_ptr(x.device))
    build.check(err, "mmt4d", "mmt4d_rows launch")
    mmt4d.launches += 1
    return out
