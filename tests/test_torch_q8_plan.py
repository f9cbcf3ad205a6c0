"""The int8 packed GEMM's (w8a8, kernels/mmt4d_q8.py) host-side arithmetic,
on the CPU.

- `mmt4d_plan`, which the int8 kernel takes too, at chip_smoke.py's
  phase-2 shapes: which body (skinny split-K or the wgmma pipeline), which
  tile and which K split.
- The int8 TMA boxes (`skinny_block_loads`, `wide_lhs_box`,
  `wide_lhs_origin` at itemsize 1: one 128-byte box a packed K tile),
  emulated as the hardware fills them: every element of lhs4 is loaded
  exactly once per output slice, and a block's weight box is its rows of
  W = unpack(rhs4).
- A Python mirror of the int8 skinny body: K tiles round-robin over four
  warps, warp sums in warp order, split partials in split order, all in
  integers, then (float(sum) * s_a) * s_w once.  It must equal ref.mmt4d_q8
  and JAX's mmt4d_q8_pallas (interpret mode) bit for bit: the integer sum
  is exact, and the epilogue rounds in the same order.  Cases: full-range
  random int8 at 16, 20, 24 and 64 rows (and 100 rows at M0 = 5, two row
  groups), K1 = 16 and 64; all operands 127 at K = 8192 (|sum| ~ 1.3e8 >
  2^24); and operands drawn from [100, 127], where partials merged in f32
  instead would round (the test shows that they do).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import mmt4d_q8 as jq8
from repro_torch.kernels import fused_pack_mmt4d as gemm
from repro_torch.kernels import mmt4d as M
from repro_torch.kernels import mmt4d_q8
from repro_torch.kernels import ref

def _box4(x: torch.Tensor, origin, box) -> torch.Tensor:
    """What a rank-4 TMA box over x (M1, K1, M0, 128) lands: extents `box`
    = (e0, e1, e2, e3) at `origin` = (k0, m0, k1, m1), innermost first, as
    e3*e2*e1 rows of e0 elements; past an edge zeros (-1 for index
    tensors)."""
    k0, a0, kt, b1 = origin
    e0, e1, e2, e3 = box
    fill = -1 if x.dtype == torch.int64 else 0
    out = torch.full((e3, e2, e1, e0), fill, dtype=x.dtype)
    sub = x[b1:b1 + e3, kt:kt + e2, a0:a0 + e1, k0:k0 + e0]
    out[:sub.shape[0], :sub.shape[1], :sub.shape[2], :sub.shape[3]] = sub
    return out.reshape(e3 * e2 * e1, e0)


def test_q8_plan_at_the_phase2_shapes():
    """16 and 20 rows (M0 = 8) take the skinny body with the bf16 split;
    256 rows the wide body only at N = 8192 (the other wide grids hold
    32-128 blocks); 2048 rows (M0 = 128) the wide body with the prefill
    GEMM's tile."""
    kn_splits = {(2048, 2048): 3, (2048, 512): 9, (2048, 8192): 1, (8192, 2048): 3}
    for (k, n), splits in kn_splits.items():
        k1, n1 = k // 128, n // 128
        for m1 in (2, 3):
            assert M.mmt4d_plan(m1, 8, n1, k1) == ("skinny", M.SKINNY_BN, splits)
        assert M.mmt4d_plan(16, 128, n1, k1) == ("wide",) + gemm.gemm_tile_plan(2048, n1)
        want_256 = (("wide", 128, 64) if n == 8192
                    else ("skinny", M.SKINNY_BN, 3 if n == 512 else 1))
        assert M.mmt4d_plan(32, 8, n1, k1) == want_256
    assert M.mmt4d_plan(8, 8, 16, 16)[0] == "skinny"  # 64 rows
    assert M.mmt4d_plan(20, 5, 16, 16)[0] == "skinny"  # M0 = 5: no wide box


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("m1,m0", [(1, 8), (3, 8), (8, 8), (12, 5), (20, 7)])
def test_q8_skinny_loads_each_row_and_weight_element_once(m1, m0, splits):
    n1, k1 = 2, 5
    g, groups = M.skinny_groups(m1, m0)
    box = (128, m0, 1, g)
    idx = torch.arange(m1 * k1 * m0 * 128).reshape(m1, k1, m0, 128)
    widx = torch.arange(n1 * k1 * 128 * 128).reshape(n1 * k1 * 128, 128)
    w_of = ref.unpack(widx.reshape(n1, k1, 128, 128), (n1 * 128, k1 * 128))
    gx, gy, gz = M.skinny_grid(m1, m0, n1, splits)
    assert gz == groups
    for bx in range(gx):
        seen, w_seen = [], []
        for split in range(gy):
            lo, hi = M.skinny_split_range(split, splits, k1)
            for bz in range(gz):
                for i in range(hi - lo):
                    weight, rows = M.skinny_block_loads(bx, split, bz, i, m1, m0, splits, k1,
                                                        itemsize=1)
                    assert len(weight) == len(rows) == 1  # one box a packed K tile
                    got = _box4(idx, rows[0], box)
                    assert got.shape == (g * m0, 128)
                    seen.append(got[got >= 0])
                    if bz == 0:
                        c, r = weight[0]
                        w = widx[r:r + 32, c:c + 128]
                        kt = lo + i
                        assert torch.equal(w, w_of[bx * 32:(bx + 1) * 32,
                                                   kt * 128:(kt + 1) * 128])
                        w_seen.append(w.reshape(-1))
        assert (torch.bincount(torch.cat(seen), minlength=idx.numel()) == 1).all()
        wc = torch.bincount(torch.cat(w_seen), minlength=widx.numel())
        mine = w_of[bx * 32:(bx + 1) * 32].reshape(-1)
        assert (wc[mine] == 1).all() and wc.sum() == mine.numel()


@pytest.mark.parametrize("m1,m0", [(9, 8), (32, 8), (17, 4), (70, 1), (1, 128), (3, 128)])
def test_q8_wide_boxes_land_each_row_once(m1, m0):
    """The wide body in int8 takes one (BM, 128) box a packed K tile: at
    every block row and K step the block's rows of that tile, zeros past
    the last row, every element of lhs4 once per output column tile."""
    k1 = 3
    rows = m1 * m0
    idx = torch.arange(m1 * k1 * m0 * 128).reshape(m1, k1, m0, 128)
    flat = idx.permute(0, 2, 1, 3).reshape(rows, k1 * 128)
    for bm in (64, 128):
        box = M.wide_lhs_box(m0, bm, itemsize=1)
        assert box[0] == 128
        seen = []
        for by in range(-(-rows // bm)):
            for step in range(k1):
                got = _box4(idx, M.wide_lhs_origin(by, step, m0, bm, itemsize=1), box)
                r0 = by * bm
                want = torch.full((bm, 128), -1, dtype=torch.int64)
                live = min(bm, rows - r0)
                want[:live] = flat[r0:r0 + live, step * 128:(step + 1) * 128]
                assert torch.equal(got, want)
                seen.append(got[got >= 0])
        assert (torch.bincount(torch.cat(seen), minlength=idx.numel()) == 1).all()


def _q8_skinny_mirror(lhs4, rhs4, s_a, s_w, splits: int, merge: str = "int", warps: int = 4):
    """The int8 skinny body in Python.  merge="int": warp and split sums in
    integers (the kernel's int32: asserted to fit), then the epilogue once;
    merge="f32": each warp's integer partial rounded to f32 and the warp and
    split sums taken in f32, what an f32 merge would give.  Rows past the
    last are never stored (left NaN)."""
    m1, k1, m0, _ = lhs4.shape
    n1 = rhs4.shape[0]
    g, _ = M.skinny_groups(m1, m0)
    box = (128, m0, 1, g)
    view = rhs4.reshape(n1 * k1 * 128, 128).long()
    lhs = lhs4.long()
    sa, sw = s_a.reshape(-1), s_w.reshape(-1)
    out4 = torch.full((m1, n1, m0, 128), float("nan"))
    gx, gy, gz = M.skinny_grid(m1, m0, n1, splits)
    for bx in range(gx):
        n_base = bx * M.SKINNY_BN
        nt, c0 = divmod(n_base, 128)
        for bz in range(gz):
            total = None
            for split in range(gy):
                lo, hi = M.skinny_split_range(split, splits, k1)
                acc = [torch.zeros(M.SKINNY_BN, g * m0, dtype=torch.int64) for _ in range(warps)]
                for i in range(hi - lo):
                    ((wc, wr),), (ro,) = M.skinny_block_loads(bx, split, bz, i, m1, m0, splits,
                                                               k1, itemsize=1)
                    acc[i % warps] += view[wr:wr + 32, wc:wc + 128] @ _box4(lhs, ro, box).t()
                if merge == "f32":
                    acc = [a.float() for a in acc]
                part = acc[0]
                for w_acc in acc[1:]:
                    part = part + w_acc
                total = part if total is None else total + part
            if merge == "int":
                assert total.abs().max() < 2**31
            for r in range(min(g * m0, m1 * m0 - bz * g * m0)):
                gr = bz * g * m0 + r
                b1, a0 = divmod(gr, m0)
                out4[b1, nt, a0, c0:c0 + 32] = (total[:, r].float() * sa[gr]) * sw[n_base:n_base + 32]
    return out4


def _q8_operands(seed: int, m1: int, m0: int, n1: int, k1: int, lo: int = -127, hi: int = 127):
    rng = np.random.RandomState(seed)
    lhs4 = rng.randint(lo, hi + 1, size=(m1, k1, m0, 128)).astype(np.int8)
    rhs4 = rng.randint(lo, hi + 1, size=(n1, k1, 128, 128)).astype(np.int8)
    s_a = (0.5 + rng.rand(m1, m0)).astype(np.float32) * np.float32(1e-2)
    s_w = (0.5 + rng.rand(n1, 128)).astype(np.float32) * np.float32(1e-2)
    return tuple(torch.from_numpy(a) for a in (lhs4, rhs4, s_a, s_w))


def _pallas(lhs4, rhs4, s_a, s_w) -> np.ndarray:
    return np.asarray(jq8.mmt4d_q8_pallas(*(jnp.asarray(t.numpy()) for t in (lhs4, rhs4, s_a, s_w)),
                                          blocks=(1, 1, 1), interpret=True))


def _assert_bits(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("k1", [16, 64])
@pytest.mark.parametrize("m1,m0", [(2, 8), (3, 8), (8, 8), (20, 5)])
def test_q8_skinny_mirror_equals_plain_and_pallas_bit_for_bit(m1, m0, k1):
    """16, 24 (a 20-row window packs as 3 blocks), 64 rows and two row
    groups at M0 = 5, at the plan's split and at 1 and K1 splits."""
    n1 = 2
    ops = _q8_operands(m1 * m0 + k1, m1, m0, n1, k1)
    plain = mmt4d_q8.mmt4d_q8_plain(*ops)
    _assert_bits(plain, _pallas(*ops))
    plan = M.mmt4d_plan(m1, m0, n1, k1)
    assert plan[0] == "skinny"
    for splits in sorted({plan[2], 1, k1}):
        _assert_bits(_q8_skinny_mirror(*ops, splits), plain.numpy())


def test_q8_all_127_at_k8192():
    """Every operand 127 at K = 8192: each sum is 127 * 127 * 8192 =
    132128768 > 2^24, held exactly in int32."""
    n1, k1 = 2, 64
    lhs4 = torch.full((3, k1, 8, 128), 127, dtype=torch.int8)
    rhs4 = torch.full((n1, k1, 128, 128), 127, dtype=torch.int8)
    _, _, s_a, s_w = _q8_operands(5, 3, 8, n1, 1)
    plain = mmt4d_q8.mmt4d_q8_plain(lhs4, rhs4, s_a, s_w)
    _assert_bits(plain, _pallas(lhs4, rhs4, s_a, s_w))
    splits = M.mmt4d_plan(3, 8, n1, k1)[2]
    assert splits > 1
    _assert_bits(_q8_skinny_mirror(lhs4, rhs4, s_a, s_w, splits), plain.numpy())


def test_q8_int_merge_where_an_f32_merge_rounds():
    """Operands from [100, 127] at K = 8192: warp and split partials of
    ~2e7-1e8 that are not multiples of f32's spacing there.  The integer
    merge equals plain and Pallas bit for bit; an f32 merge does not."""
    n1, k1 = 2, 64
    ops = _q8_operands(11, 3, 8, n1, k1, lo=100, hi=127)
    plain = mmt4d_q8.mmt4d_q8_plain(*ops)
    _assert_bits(plain, _pallas(*ops))
    splits = M.mmt4d_plan(3, 8, n1, k1)[2]
    _assert_bits(_q8_skinny_mirror(*ops, splits), plain.numpy())
    f32 = _q8_skinny_mirror(*ops, splits, merge="f32")
    assert not torch.equal(f32, plain)
