"""The packed GEMM's and GEMV's host-side arithmetic, on the CPU.

- `mmt4d_plan` (kernels/mmt4d.py): the skinny body's K split is the least
  that brings its grid to SKINNY_TARGET blocks, or one split a K tile; the
  wide body runs M0 = 128 and, past SKINNY_MAX_ROWS rows, the shapes whose
  wide grid fills a wave; the regime chosen at each of chip_smoke.py's
  phase-2 shapes.
- `skinny_split_range` covers the K tiles once, in order, none empty.
- `skinny_block_loads` and `wide_lhs_box` / `wide_lhs_origin`, the TMA box
  origins each body's copies read (a rank-4 box over lhs4 (M1, K1, M0, 128)
  emulated here as the hardware fills it: innermost extent first, zeros
  past an edge): every packed row and every K element is loaded exactly
  once per output slice, and a block's weight boxes are its rows of
  W = unpack(rhs4).
- A Python mirror of the skinny body, split-order merge included (warps
  take K tiles round-robin and are summed in warp order, the splits summed
  in split order), held against `mmt4d_plain` and against the JAX package's
  mmt4d_pallas / mmt4d_gemv_pallas in interpret mode, at K1 = 16 and 64 with
  16, 20, 24 and 1-8 rows.  Tolerance 1e-4 in f32: the same exact f32
  products summed in another order (per K tile, per warp, per split) over
  up to K = 8192 unit-scale terms, whose rounding differences stay near
  1e-6.
- The plain-row entry of the same body (the bf16 decode GEMV,
  kernels/fused_gemv.py): `skinny_plain_loads` lands each row of lhs (M, K)
  exactly once per output slice, rows past M zero, at M = 1..8 and every
  split count up to K1; its mirror, at the plan's split and others, against
  `fused_gemv_plain` and JAX fused_gemv_pallas in interpret mode, bf16
  values held in f32 (their products are exact in f32), tolerance 1e-4 as
  above.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import fused_gemv as jfused_gemv
from repro.kernels import mmt4d as jmmt4d
from repro.kernels import mmt4d_gemv as jmmt4d_gemv
from repro_torch.kernels import fused_gemv
from repro_torch.kernels import fused_pack_mmt4d as gemm
from repro_torch.kernels import mmt4d as M
from repro_torch.kernels import ref

TOL = dict(rtol=1e-4, atol=1e-4)
# (M1, M0): one row block of 1-8 rows, 16 / 20-24 / 64 / 65 rows at M0 = 8,
# the M0s the wide box cannot land, 256 and 1040 rows, prefill slabs.
SHAPES = ([(1, m0) for m0 in (1, 3, 4, 8)] + [(2, 8), (3, 8), (8, 8), (9, 8), (12, 5), (20, 7),
          (32, 8), (130, 8), (1, 128), (16, 128)])
N1S = [1, 4, 16, 64]
K1S = [1, 3, 16, 64]


def _box4(x: torch.Tensor, origin, box) -> torch.Tensor:
    """What a rank-4 TMA box over x (M1, K1, M0, 128) lands: extents `box`
    = (e0, e1, e2, e3) at `origin` = (k0, m0, k1, m1), innermost first, as
    e3*e2*e1 rows of e0 elements; past an edge the hardware writes zeros
    (-1 for the index tensors below)."""
    k0, a0, kt, b1 = origin
    e0, e1, e2, e3 = box
    fill = -1 if x.dtype == torch.int64 else 0
    out = torch.full((e3, e2, e1, e0), fill, dtype=x.dtype)
    sub = x[b1:b1 + e3, kt:kt + e2, a0:a0 + e1, k0:k0 + e0]
    out[:sub.shape[0], :sub.shape[1], :sub.shape[2], :sub.shape[3]] = sub
    return out.reshape(e3 * e2 * e1, e0)


def _skinny_row_box(m1: int, m0: int):
    g, _ = M.skinny_groups(m1, m0)
    return (M.GEMM_K_STEP, m0, 1, g)


@pytest.mark.parametrize("k1", K1S)
@pytest.mark.parametrize("n1", N1S)
@pytest.mark.parametrize("m1,m0", SHAPES)
def test_plan_fills_the_card_with_the_least_split(m1, m0, n1, k1):
    kind, a, b = M.mmt4d_plan(m1, m0, n1, k1)
    rows = m1 * m0
    if kind == "wide":
        assert m0 in M.WIDE_M0 and (m0 == 128 or rows > M.SKINNY_MAX_ROWS)
        assert (a, b) == gemm.gemm_tile_plan(rows, n1)
        gx, gy = gemm.gemm_grid(rows, n1, a, b)
        assert m0 == 128 or gx * gy >= gemm.GEMM_WAVE
        return
    assert m0 != 128 and a == M.SKINNY_BN
    if m0 in M.WIDE_M0 and rows > M.SKINNY_MAX_ROWS:  # the wide grid would fall short
        gx, gy = gemm.gemm_grid(rows, n1, *gemm.gemm_tile_plan(rows, n1))
        assert gx * gy < gemm.GEMM_WAVE
    splits = b
    x, y, z = M.skinny_grid(m1, m0, n1, splits)
    assert y == splits and 1 <= splits <= k1
    assert x * y * z >= M.SKINNY_TARGET or splits == k1
    if splits > 1:  # one split fewer would leave the grid short of the target
        assert x * (splits - 1) * z < M.SKINNY_TARGET


def test_plan_at_the_phase2_shapes():
    """chip_smoke.py's phase-2 shapes: Llama-3.2-1B's projections K x N at
    the GEMV's 1-8 rows, verify/16-slot windows (16, 20 rows), a 256-row
    mixed window (M0 = 8) and a 2048-row prefill (M0 = 128)."""
    kn_splits = {(2048, 2048): 3, (2048, 512): 9, (2048, 8192): 1, (8192, 2048): 3}
    for (k, n), splits in kn_splits.items():
        k1, n1 = k // 128, n // 128
        for m1, m0 in ((1, 1), (1, 4), (1, 8), (2, 8), (3, 8)):
            assert M.mmt4d_plan(m1, m0, n1, k1) == ("skinny", 32, splits)
        assert M.mmt4d_plan(16, 128, n1, k1) == (("wide", 64, 64) if n == 512
                                                 else ("wide", 128, 128))
    assert M.mmt4d_plan(32, 8, 16, 16) == ("skinny", 32, 1)   # 256 rows, K=N=2048
    assert M.mmt4d_plan(32, 8, 4, 16) == ("skinny", 32, 3)    # N = 512
    assert M.mmt4d_plan(32, 8, 64, 16) == ("wide", 128, 64)   # N = 8192
    assert M.mmt4d_plan(32, 8, 16, 64) == ("skinny", 32, 1)   # K = 8192, N = 2048
    assert M.mmt4d_plan(130, 8, 16, 16) == ("wide", 128, 128)  # a 1040-row window


@pytest.mark.parametrize("k1", [1, 2, 3, 16, 17, 64])
def test_split_ranges_cover_k_once_in_order(k1):
    for splits in range(1, k1 + 1):
        tiles = []
        for s in range(splits):
            lo, hi = M.skinny_split_range(s, splits, k1)
            assert hi > lo  # no split is empty
            tiles.extend(range(lo, hi))
        assert tiles == list(range(k1))


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("m1,m0", [(1, 1), (1, 8), (3, 8), (8, 8), (12, 5), (20, 7), (32, 8)])
def test_skinny_loads_each_row_and_weight_element_once(m1, m0, splits):
    """Per 32-column slice, the row boxes over all splits, row groups and K
    tiles load every element of lhs4 exactly once; the weight boxes load
    exactly the slice's rows of W, each element once."""
    n1, k1 = 2, 5
    g, groups = M.skinny_groups(m1, m0)
    box = _skinny_row_box(m1, m0)
    idx = torch.arange(m1 * k1 * m0 * 128).reshape(m1, k1, m0, 128)
    widx = torch.arange(n1 * k1 * 128 * 128).reshape(n1 * k1 * 128, 128)
    w_of = ref.unpack(widx.reshape(n1, k1, 128, 128), (n1 * 128, k1 * 128))
    gx, gy, gz = M.skinny_grid(m1, m0, n1, splits)
    assert gz == groups
    for bx in range(gx):
        lhs_seen, w_seen = [], []
        for split in range(gy):
            lo, hi = M.skinny_split_range(split, splits, k1)
            for bz in range(gz):
                for i in range(hi - lo):
                    (wa, wb), (ra, rb) = M.skinny_block_loads(bx, split, bz, i, m1, m0,
                                                              splits, k1)
                    for o in (ra, rb):
                        got = _box4(idx, o, box)
                        assert got.shape == (g * m0, 64)
                        lhs_seen.append(got[got >= 0])
                    if bz == 0:
                        for c, r in (wa, wb):
                            w_seen.append(widx[r:r + 32, c:c + 64])
                        w = torch.cat([widx[wa[1]:wa[1] + 32, wa[0]:wa[0] + 64],
                                       widx[wb[1]:wb[1] + 32, wb[0]:wb[0] + 64]], dim=1)
                        kt = lo + i
                        assert torch.equal(w, w_of[bx * 32:(bx + 1) * 32,
                                                   kt * 128:(kt + 1) * 128])
        counts = torch.bincount(torch.cat(lhs_seen), minlength=idx.numel())
        assert (counts == 1).all()
        wc = torch.bincount(torch.cat([t.reshape(-1) for t in w_seen]), minlength=widx.numel())
        mine = w_of[bx * 32:(bx + 1) * 32].reshape(-1)
        assert (wc[mine] == 1).all() and wc.sum() == mine.numel()


@pytest.mark.parametrize("m1,m0", [(9, 8), (32, 8), (130, 8), (17, 4), (70, 1), (1, 128),
                                   (3, 128), (16, 128)])
def test_wide_boxes_land_each_row_once(m1, m0):
    """The wide body's rank-4 box at every block row and K step holds the
    block's rows m_base .. m_base + BM - 1 (flattened r = m1*M0 + m0) of
    one 64-wide K slab, zeros past M1; over the grid every element of lhs4
    is loaded exactly once per output column tile."""
    k1 = 3
    rows = m1 * m0
    idx = torch.arange(m1 * k1 * m0 * 128).reshape(m1, k1, m0, 128)
    flat = idx.permute(0, 2, 1, 3).reshape(rows, k1 * 128)  # (rows, K)
    for bm in (64, 128):
        box = M.wide_lhs_box(m0, bm)
        seen = []
        for by in range(-(-rows // bm)):
            for step in range(2 * k1):
                got = _box4(idx, M.wide_lhs_origin(by, step, m0, bm), box)
                assert got.shape == (bm, 64)
                r0 = by * bm
                want = torch.full((bm, 64), -1, dtype=torch.int64)
                live = min(bm, rows - r0)
                want[:live] = flat[r0:r0 + live, step * 64:(step + 1) * 64]
                assert torch.equal(got, want)
                seen.append(got[got >= 0])
        assert (torch.bincount(torch.cat(seen), minlength=idx.numel()) == 1).all()


def _skinny_mirror(lhs4: torch.Tensor, rhs4: torch.Tensor, splits: int, warps: int = 4):
    """The skinny body in Python: per block (slice, split, row group) the
    K tiles go round-robin to `warps` accumulators, summed in warp order;
    a tile's splits are summed in split order; rows past M1 * M0 are never
    stored (left NaN here, so a missed store shows)."""
    m1, k1, m0, _ = lhs4.shape
    n1 = rhs4.shape[0]
    g, _ = M.skinny_groups(m1, m0)
    box = _skinny_row_box(m1, m0)
    view = rhs4.reshape(n1 * k1 * 128, 128)
    out4 = torch.full((m1, n1, m0, 128), float("nan"))
    gx, gy, gz = M.skinny_grid(m1, m0, n1, splits)
    for bx in range(gx):
        n_base = bx * M.SKINNY_BN
        for bz in range(gz):
            total = None
            for split in range(gy):
                lo, hi = M.skinny_split_range(split, splits, k1)
                acc = [torch.zeros(M.SKINNY_BN, g * m0) for _ in range(warps)]
                for i in range(hi - lo):
                    (wa, wb), (ra, rb) = M.skinny_block_loads(bx, split, bz, i, m1, m0,
                                                              splits, k1)
                    w = torch.cat([view[wa[1]:wa[1] + 32, wa[0]:wa[0] + 64],
                                   view[wb[1]:wb[1] + 32, wb[0]:wb[0] + 64]], dim=1)
                    a = torch.cat([_box4(lhs4, ra, box), _box4(lhs4, rb, box)], dim=1)
                    acc[i % warps] += w @ a.t()
                part = acc[0]
                for w_acc in acc[1:]:
                    part = part + w_acc
                total = part if total is None else total + part
            for r in range(min(g * m0, m1 * m0 - bz * g * m0)):
                b1, a0 = divmod(bz * g * m0 + r, m0)
                nt, c0 = divmod(n_base, 128)
                out4[b1, nt, a0, c0:c0 + M.SKINNY_BN] = total[:, r]
    return out4


def _operands(seed: int, rows: int, m0: int, n1: int, k1: int):
    """Rows packed as ops packs them (pad rows zero) and a packed weight,
    from numpy."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, k1 * 128).astype(np.float32)
    w = (rng.randn(n1, k1, 128, 128) * (k1 * 128) ** -0.5).astype(np.float32)
    return ref.pack(torch.from_numpy(x), (m0, 128)), torch.from_numpy(w)


@pytest.mark.parametrize("k1", [16, 64])
@pytest.mark.parametrize("rows", [16, 20, 24])
def test_skinny_mirror_matches_plain_and_pallas(rows, k1):
    """The split-order merge at the GEMM's decode windows, at the plan's
    split and at a few others (every split count sums the same products)."""
    n1 = 2
    lhs4, rhs4 = _operands(rows + k1, rows, 8, n1, k1)
    want = jmmt4d.mmt4d_pallas(jnp.asarray(lhs4.numpy()), jnp.asarray(rhs4.numpy()),
                               blocks=(1, 1, 1), interpret=True)
    plain = M.mmt4d_plain(lhs4, rhs4)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)
    plan = M.mmt4d_plan(lhs4.shape[0], 8, n1, k1)
    assert plan[0] == "skinny"
    for splits in sorted({plan[2], 1, 5, k1}):
        got = _skinny_mirror(lhs4, rhs4, splits)
        torch.testing.assert_close(got, plain, **TOL)


@pytest.mark.parametrize("k1", [16, 64])
@pytest.mark.parametrize("m0", list(range(1, 9)))
def test_skinny_mirror_matches_gemv_pallas(m0, k1):
    """The packed GEMV's body: one row block of 1-8 rows, no row padding
    stored."""
    n1 = 2
    lhs4, rhs4 = _operands(m0 * k1, m0, m0, n1, k1)
    assert lhs4.shape == (1, k1, m0, 128)
    want = jmmt4d_gemv.mmt4d_gemv_pallas(jnp.asarray(lhs4.numpy()), jnp.asarray(rhs4.numpy()),
                                         bn1=1, interpret=True)
    splits = M.mmt4d_plan(1, m0, n1, k1)[2]
    got = _skinny_mirror(lhs4, rhs4, splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(got, M.mmt4d_plain(lhs4, rhs4), **TOL)


@pytest.mark.parametrize("m1,m0", [(12, 5), (20, 7)])
def test_skinny_mirror_row_groups(m1, m0):
    """Past 64 rows at an M0 the wide box cannot land, row groups of G =
    64 // M0 blocks along the grid's third axis."""
    lhs4, rhs4 = _operands(m1, m1 * m0, m0, 1, 3)
    assert M.mmt4d_plan(m1, m0, 1, 3)[0] == "skinny"
    torch.testing.assert_close(_skinny_mirror(lhs4, rhs4, 2), M.mmt4d_plain(lhs4, rhs4), **TOL)


# ---- the plain-row entry (the bf16 decode GEMV) ----------------------------------


def _box2(x: torch.Tensor, origin, box) -> torch.Tensor:
    """What a 2-D TMA box over x (M, K) lands: extents `box` = (columns,
    rows) at `origin` = (column, row); past an edge zeros (-1 for index
    tensors)."""
    c0, r0 = origin
    ec, er = box
    fill = -1 if x.dtype == torch.int64 else 0
    out = torch.full((er, ec), fill, dtype=x.dtype)
    sub = x[r0:r0 + er, c0:c0 + ec]
    out[:sub.shape[0], :sub.shape[1]] = sub
    return out


@pytest.mark.parametrize("m", list(range(1, 9)))
def test_plain_boxes_land_each_row_once(m):
    """Per 32-column slice, the row boxes over all splits and K tiles load
    every element of lhs (M, K) exactly once, as (8, 64) boxes whose rows
    past M are zeros; the weight boxes are the packed entry's, the slice's
    rows of W."""
    n1, k1 = 2, 5
    box = M.SKINNY_PLAIN_BOX
    idx = torch.arange(m * k1 * 128).reshape(m, k1 * 128)
    widx = torch.arange(n1 * k1 * 128 * 128).reshape(n1 * k1 * 128, 128)
    w_of = ref.unpack(widx.reshape(n1, k1, 128, 128), (n1 * 128, k1 * 128))
    assert M.mmt4d_plan(1, m, n1, k1)[2] == k1  # the plan splits every K tile here
    for splits in range(1, k1 + 1):
        gx, gy, gz = M.skinny_grid(1, m, n1, splits)
        assert gz == 1
        for bx in range(gx):
            seen = []
            for split in range(gy):
                lo, hi = M.skinny_split_range(split, splits, k1)
                for i in range(hi - lo):
                    (wa, wb), rows = M.skinny_plain_loads(bx, split, i, m, splits, k1)
                    assert (wa, wb) == M.skinny_block_loads(bx, split, 0, i, 1, m, splits, k1)[0]
                    for o in rows:
                        got = _box2(idx, o, box)
                        assert got.shape == (8, 64) and (got[m:] == -1).all()
                        seen.append(got[got >= 0])
                    w = torch.cat([widx[wa[1]:wa[1] + 32, wa[0]:wa[0] + 64],
                                   widx[wb[1]:wb[1] + 32, wb[0]:wb[0] + 64]], dim=1)
                    kt = lo + i
                    assert torch.equal(w, w_of[bx * 32:(bx + 1) * 32, kt * 128:(kt + 1) * 128])
            assert (torch.bincount(torch.cat(seen), minlength=idx.numel()) == 1).all()


def _skinny_plain_mirror(x: torch.Tensor, rhs4: torch.Tensor, splits: int, warps: int = 4):
    """The plain-row entry in Python: the packed mirror's order of sums
    (K tiles round-robin over `warps`, warp order, split order) on (8, 64)
    row boxes of x (M, K), each row's 32 columns stored at out[m, n ..]
    (rows past M never stored: left NaN, so a missed store shows)."""
    m, _ = x.shape
    n1, k1 = rhs4.shape[:2]
    box = M.SKINNY_PLAIN_BOX
    view = rhs4.reshape(n1 * k1 * 128, 128)
    out = torch.full((m, n1 * 128), float("nan"))
    gx, gy, _ = M.skinny_grid(1, m, n1, splits)
    for bx in range(gx):
        total = None
        for split in range(gy):
            lo, hi = M.skinny_split_range(split, splits, k1)
            acc = [torch.zeros(M.SKINNY_BN, box[1]) for _ in range(warps)]
            for i in range(hi - lo):
                (wa, wb), (ra, rb) = M.skinny_plain_loads(bx, split, i, m, splits, k1)
                w = torch.cat([view[wa[1]:wa[1] + 32, wa[0]:wa[0] + 64],
                               view[wb[1]:wb[1] + 32, wb[0]:wb[0] + 64]], dim=1)
                a = torch.cat([_box2(x, ra, box), _box2(x, rb, box)], dim=1)
                acc[i % warps] += w @ a.t()
            part = acc[0]
            for w_acc in acc[1:]:
                part = part + w_acc
            total = part if total is None else total + part
        out[:, bx * M.SKINNY_BN:(bx + 1) * M.SKINNY_BN] = total[:, :m].t()
    return out


@pytest.mark.parametrize("k1", [16, 64])
@pytest.mark.parametrize("m", list(range(1, 9)))
def test_plain_mirror_matches_fused_gemv(m, k1):
    """The decode GEMV on plain rows: the body's sums at the plan's split
    and at 1 and K1 splits against fused_gemv_plain and JAX's
    fused_gemv_pallas (interpret), on bf16 values."""
    n1 = 2
    rng = np.random.RandomState(100 * m + k1)
    x = torch.from_numpy(rng.randn(m, k1 * 128).astype(np.float32))
    w = torch.from_numpy((rng.randn(n1, k1, 128, 128) * (k1 * 128) ** -0.5).astype(np.float32))
    x, w = x.bfloat16().float(), w.bfloat16().float()
    plain = fused_gemv.fused_gemv_plain(x, w)
    want = jfused_gemv.fused_gemv_pallas(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                                         bn1=1, interpret=True)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)
    plan = M.mmt4d_plan(1, m, n1, k1)
    assert plan[0] == "skinny" and plan[2] > 1
    for splits in sorted({plan[2], 1, k1}):
        got = _skinny_plain_mirror(x, w, splits)
        torch.testing.assert_close(got, plain, **TOL)
