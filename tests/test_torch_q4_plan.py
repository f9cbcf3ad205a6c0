"""The packed w4a8 GEMM's (kernels/mmt4d_q4.py, csrc/mmt4d_q4.cu on
csrc/packed_skinny.cuh) host-side arithmetic and its device arithmetic,
mirrored in Python, on the CPU.

- `q4_plan` at chip_smoke.py's phase-2 shapes: the block width (16 columns
  with the four warps splitting the K tiles, or 64 with a warp per 16) and
  the K split.
- The copies (`q4_block_loads`), emulated as the hardware fills them: the
  weight box (64-byte rows of rhs4_p viewed as (N1*K1*128, 64)) holds the
  block's weight rows of its K tile, the scale run is their 128/G scales,
  the rows box (row groups, or 64-row slabs at M0 = 128) lands the block's
  rows; every weight byte and scale once per row group, every row element
  once per N slice.
- The fragment K order: the lanes' weight words, gathered from the
  64B-swizzled box with the kernel's loads and byte permutes, and the rows'
  ldmatrix fragments from the 128B-swizzled box, put into the PTX
  m16n8k32 / m16n8k16 s8 fragment layouts, give 16 x the group's integer
  sum of every (weight row, row) pair.
- A mirror of the whole body: per group the int32 fragment starting at the
  constant 0x40F80000, read as the high word of a double (1.5 * 2^16 +
  s), times the scale, summed in f64; the scales' sum times 1.5 * 2^16
  taken off once per warp; warp sums in warp order, split partials in
  split order; float(sum) * s_a.  It equals ref.mmt4d_q4 bit for bit (the
  f64 sums are exact) and JAX's mmt4d_q4_pallas (interpret mode, f32 sums)
  within 3e-5 of the largest output, at groups 16 and 32 and M0 in {1, 5,
  8, 128}, under every plan the kernel takes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import mmt4d_q4 as jq4
from repro_torch.kernels import mmt4d as M
from repro_torch.kernels import mmt4d_q4 as Q
from repro_torch.kernels import ref

Q4_C = 0x40F80000       # csrc/packed_skinny.cuh
Q4_OFFSET = 98304.0     # 1.5 * 2^16


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


def _rows_box(m1: int, m0: int):
    if m0 > Q.Q4_ROWS:
        return M.slab_lhs_box(Q.Q4_ROWS)
    return 128, m0, 1, min(m1, Q.Q4_ROWS // m0)


def test_q4_plan_at_the_phase2_shapes():
    """16 and 20 rows: 16-column blocks at the split that fills 132
    blocks; 256 rows (M0 = 8) and 2048 rows (M0 = 128): 64-column blocks
    where their grid fills a wave, else 16-column ones."""
    want = {  # (K, N): (16 and 20 rows, 256 rows, 2048 rows)
        (2048, 2048): (("skinny", 16, 2), ("skinny", 16, 1), ("skinny", 64, 1)),
        (2048, 512): (("skinny", 16, 5), ("skinny", 16, 2), ("skinny", 64, 1)),
        (2048, 8192): (("skinny", 16, 1), ("skinny", 64, 1), ("skinny", 64, 1)),
        (8192, 2048): (("skinny", 16, 2), ("skinny", 16, 1), ("skinny", 64, 1)),
    }
    for (k, n), (few, mid, wide) in want.items():
        k1, n1 = k // 128, n // 128
        assert Q.q4_plan(2, 8, n1, k1) == few and Q.q4_plan(3, 8, n1, k1) == few
        assert Q.q4_plan(32, 8, n1, k1) == mid
        assert Q.q4_plan(16, 128, n1, k1) == wide
    assert Q.q4_groups(20, 1) == (20, 1)
    assert Q.q4_groups(13, 5) == (60, 2)
    assert Q.q4_groups(2, 128) == (64, 4)
    assert Q.q4_warps(Q.Q4_BN) == (1, 16) and Q.q4_warps(Q.Q4_WIDE_BN) == (4, 16)
    assert Q.q4_plan(1, 8, 16, 16)[1] == Q.Q4_BN  # 8 rows: never the 64-column block
    with pytest.raises(ValueError, match="mmt4d_q4 takes"):
        Q.q4_launch_args(torch.device("cpu"), 3, 8, 4, 3, ("skinny", 64, 1))  # 24 rows
    with pytest.raises(ValueError, match="mmt4d_q4 takes"):
        Q.q4_launch_args(torch.device("cpu"), 8, 8, 4, 3, ("skinny", 32, 1))


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("m1,m0,bn,splits", [(1, 8, 16, 1), (3, 8, 16, 2), (13, 5, 16, 5),
                                             (20, 1, 16, 1), (9, 8, 64, 2), (2, 128, 64, 1),
                                             (3, 128, 16, 3), (8, 8, 64, 3)])
def test_q4_copies_land_each_weight_scale_and_row_once(m1, m0, bn, splits, group):
    n1, k1 = 2, 5
    gpt = 128 // group
    rows_blk, _ = Q.q4_groups(m1, m0)
    box = _rows_box(m1, m0)
    idx = torch.arange(m1 * k1 * m0 * 128).reshape(m1, k1, m0, 128)
    widx = torch.arange(n1 * k1 * 128 * 64).reshape(n1 * k1 * 128, 64)
    sidx = torch.arange(n1 * k1 * 128 * gpt).reshape(n1, k1, 128, gpt)
    gx, gy, gz = Q.q4_grid(m1, m0, n1, bn, splits)
    w_count = torch.zeros(widx.numel(), dtype=torch.int64)
    s_count = torch.zeros(sidx.numel(), dtype=torch.int64)
    for bx in range(gx):
        n_base = bx * bn
        nt, c0 = divmod(n_base, 128)
        seen = []
        for split in range(gy):
            lo, hi = M.skinny_split_range(split, splits, k1)
            for bz in range(gz):
                for i in range(hi - lo):
                    kt = lo + i
                    (wc, wr), (s0, sn), ro = Q.q4_block_loads(bx, split, bz, i, m1, m0, k1, bn,
                                                              splits, group)
                    got = _box4(idx, ro, box)
                    assert got.shape == (rows_blk, 128)
                    seen.append(got[got >= 0])
                    if bz == 0:
                        w = widx[wr:wr + bn, wc:wc + 64]
                        assert torch.equal(w, widx.reshape(n1, k1, 128, 64)[nt, kt, c0:c0 + bn])
                        w_count[w.reshape(-1)] += 1
                        s = sidx.reshape(-1)[s0:s0 + sn]
                        assert torch.equal(s, sidx[nt, kt, c0:c0 + bn].reshape(-1))
                        s_count[s] += 1
        assert (torch.bincount(torch.cat(seen), minlength=idx.numel()) == 1).all()
    assert (w_count == 1).all() and (s_count == 1).all()


# ---- the lanes' fragments ----------------------------------------------------------


def _byte_perm(x, y, sel: int):
    """__byte_perm(x, y, sel) on uint32 arrays: byte i of the result is byte
    (sel >> 4i) & 7 of y:x."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint64)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * b)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _swizzle_64(box: np.ndarray) -> np.ndarray:
    """A (rows, 64) u8 box as TMA's 64B swizzle lays it in shared memory:
    16-byte chunk ch of row r at chunk ch ^ ((r >> 1) & 3)."""
    out = np.zeros(box.size, dtype=np.uint8)
    for r in range(box.shape[0]):
        for ch in range(4):
            dst = r * 64 + ((ch ^ ((r >> 1) & 3)) << 4)
            out[dst:dst + 16] = box[r, ch * 16:(ch + 1) * 16]
    return out


def _swizzle_128(box: np.ndarray) -> np.ndarray:
    out = np.zeros(box.size, dtype=np.uint8)
    for r in range(box.shape[0]):
        for ch in range(8):
            dst = r * 128 + ((ch ^ (r & 7)) << 4)
            out[dst:dst + 16] = box[r, ch * 16:(ch + 1) * 16]
    return out


def _u32(smem: np.ndarray, addr) -> np.ndarray:
    addr = np.asarray(addr)
    return (smem[addr].astype(np.uint32) | smem[addr + 1].astype(np.uint32) << 8
            | smem[addr + 2].astype(np.uint32) << 16 | smem[addr + 3].astype(np.uint32) << 24)


def _s8(word: int) -> list[int]:
    return [((word >> (8 * i)) & 0xFF) - (256 if (word >> (8 * i)) & 0x80 else 0)
            for i in range(4)]


def _weight_words(wsm: np.ndarray, kk: int):
    """xa, ya (4 weight rows i*8 + g, 32 lanes) as the kernel gathers them."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    pick = np.where(t & 1, 0x7632, 0x5410)
    xa, ya = [], []
    for i in range(4):
        r = i * 8 + g
        chunk = r * 64 + ((kk ^ ((r >> 1) & 3)) << 4) + 4 * (t >> 1)
        wa, wb = _u32(wsm, chunk), _u32(wsm, chunk + 8)
        w = np.array([_byte_perm(wa[j:j + 1], wb[j:j + 1], int(pick[j]))[0] for j in range(32)],
                     dtype=np.uint32)
        w4 = (w.astype(np.uint64) << np.uint64(4)).astype(np.uint32)
        xa.append(_byte_perm(w4, w, 0x5140) & np.uint32(0xF0F0F0F0))
        ya.append(_byte_perm(w4, w, 0x7362) & np.uint32(0xF0F0F0F0))
    return xa, ya


def _row_frags(asm: np.ndarray, q: int, kk: int):
    """ldmatrix.x2 of rows q*8.. at chunks 2kk, 2kk+1 of the 128B-swizzled
    rows box: lane T gets row T/4, bytes 4(T%4).. of each matrix."""
    lane = np.arange(32)
    frags = []
    for mat in range(2):
        row = q * 8 + (lane >> 2)
        addr = row * 128 + (((2 * kk + mat) ^ (row & 7)) << 4) + 4 * (lane & 3)
        frags.append(_u32(asm, addr))
    return frags


def _mma(a_regs, b_regs, k: int) -> np.ndarray:
    """D (16 x 8) of mma.sync m16n8k{k}.s8 from the lanes' registers, by the
    PTX fragment layouts: A reg 0 (row g, K 4t..), 1 (row g+8, K 4t..), at
    k32 also 2 (row g, K 16+4t..), 3 (row g+8, K 16+4t..); B reg 0 (K 4t..,
    column g), at k32 also 1 (K 16+4t.., column g)."""
    a = np.zeros((16, k), dtype=np.int64)
    b = np.zeros((k, 8), dtype=np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for reg, word in enumerate(a_regs):
            row = g + 8 * (reg & 1)
            k0 = 4 * t + 16 * (reg >> 1)
            a[row, k0:k0 + 4] = _s8(int(word[lane]))
        for reg, word in enumerate(b_regs):
            k0 = 4 * t + 16 * reg
            b[k0:k0 + 4, g] = _s8(int(word[lane]))
    return a @ b


@pytest.mark.parametrize("group", [16, 32])
def test_q4_fragments_give_each_groups_sum(group):
    """Every step, weight fragment j and row group q: the s8 mma on the
    lanes' registers gives 16 x the group's sum of w * a."""
    rng = np.random.RandomState(group)
    wbox = rng.randint(0, 256, size=(32, 64)).astype(np.uint8)   # one K tile, 32 weight rows
    rows = rng.randint(-128, 128, size=(16, 128)).astype(np.int8)  # NT = 2
    w_int = ref.unpack_nibbles(torch.from_numpy(wbox)).numpy().astype(np.int64)  # (32, 128)
    wsm = _swizzle_64(wbox)
    asm = _swizzle_128(rows.view(np.uint8))
    for kk in range(4):
        xa, ya = _weight_words(wsm, kk)
        for q in range(2):
            fb = _row_frags(asm, q, kk)
            for j in range(2):
                wr = slice(j * 16, j * 16 + 16)
                xr = rows[q * 8:q * 8 + 8].astype(np.int64)
                if group == 32:
                    ks = slice(kk * 32, kk * 32 + 32)
                    d = _mma([xa[2 * j], xa[2 * j + 1], ya[2 * j], ya[2 * j + 1]], fb, 32)
                    np.testing.assert_array_equal(d, 16 * w_int[wr, ks] @ xr[:, ks].T)
                else:
                    for gs, (regs, b) in enumerate((((xa[2 * j], xa[2 * j + 1]), fb[0]),
                                                    ((ya[2 * j], ya[2 * j + 1]), fb[1]))):
                        ks = slice(kk * 32 + 16 * gs, kk * 32 + 16 * gs + 16)
                        d = _mma(list(regs), [b], 16)
                        np.testing.assert_array_equal(d, 16 * w_int[wr, ks] @ xr[:, ks].T)


# ---- the body ----------------------------------------------------------------------


def _f64_term(s: np.ndarray) -> np.ndarray:
    """The group's int32 fragment, Q4_C + 16 s, read as a double's high word."""
    c = Q4_C + 16 * s
    assert (c >= 0).all() and (c < 2**31).all()
    return (c.astype(np.uint64) << np.uint64(32)).view(np.float64)


def _q4_mirror(lhs4, rhs4_p, s_a, s_w4, group: int, plan) -> torch.Tensor:
    """The int4 skinny body in Python (rows past the last left NaN)."""
    m1, k1, m0, _ = lhs4.shape
    n1 = rhs4_p.shape[0]
    _, bn, splits = plan
    wn, wc = Q.q4_warps(bn)
    gpt = 128 // group
    rows_blk, _ = Q.q4_groups(m1, m0)
    box = _rows_box(m1, m0)
    w_view = ref.unpack_nibbles(rhs4_p.reshape(n1 * k1 * 128, 64)).numpy().astype(np.int64)
    s_flat = s_w4.double().reshape(-1).numpy()
    sa = s_a.reshape(-1).numpy()
    out4 = np.full((m1, n1, m0, 128), np.nan, dtype=np.float32)
    gx, gy, gz = Q.q4_grid(m1, m0, n1, bn, splits)
    for bx in range(gx):
        nt, c0 = divmod(bx * bn, 128)
        for bz in range(gz):
            total = None
            for split in range(gy):
                lo, hi = M.skinny_split_range(split, splits, k1)
                acc = np.zeros((4, wc, rows_blk))
                ssum = np.zeros((4, wc))
                for i in range(hi - lo):
                    (_, wr), (s0, sn), ro = Q.q4_block_loads(bx, split, bz, i, m1, m0, k1, bn,
                                                             splits, group)
                    wt = w_view[wr:wr + bn]
                    st = s_flat[s0:s0 + sn].reshape(bn, gpt)
                    xt = _box4(lhs4, ro, box).numpy().astype(np.int64)
                    for w in ([i % 4] if wn == 1 else range(4)):
                        cols = slice(wc * w, wc * w + wc) if wn > 1 else slice(0, wc)
                        for gi in range(gpt):  # steps in order, groups in order
                            ks = slice(gi * group, (gi + 1) * group)
                            d = _f64_term(wt[cols, ks] @ xt[:, ks].T)
                            ssum[w] += st[cols, gi]
                            acc[w] += d * st[cols, gi][:, None]  # exact product: the DFMA
                acc -= Q4_OFFSET * ssum[:, :, None]
                part = (acc[0] + acc[1] + acc[2] + acc[3] if wn == 1
                        else np.concatenate(list(acc), axis=0))
                total = part if total is None else total + part
            for r in range(min(rows_blk, m1 * m0 - bz * rows_blk)):
                gr = bz * rows_blk + r
                b1, a0 = divmod(gr, m0)
                out4[b1, nt, a0, c0:c0 + bn] = total[:, r].astype(np.float32) * sa[gr]
    return torch.from_numpy(out4)


def _q4_operands(seed: int, m1: int, m0: int, n1: int, k1: int, group: int, span: int = 0):
    rng = np.random.RandomState(seed)
    lhs4 = rng.randint(-127, 128, size=(m1, k1, m0, 128)).astype(np.int8)
    rhs4_p = rng.randint(0, 256, size=(n1, k1, 128, 64)).astype(np.uint8)
    s_a = (0.5 + rng.rand(m1, m0)).astype(np.float32) * np.float32(1e-2)
    s_w4 = (0.5 + rng.rand(n1, k1, 128, 128 // group)) * 1e-2
    if span:
        s_w4 = s_w4 * np.exp2(rng.randint(-span, span + 1, size=s_w4.shape))
    s_w4 = torch.from_numpy(s_w4.astype(np.float32)).to(torch.bfloat16)
    return (torch.from_numpy(lhs4), torch.from_numpy(rhs4_p), torch.from_numpy(s_a), s_w4)


def _plans(m1: int, m0: int, n1: int, k1: int) -> list:
    plans = {Q.q4_plan(m1, m0, n1, k1), ("skinny", 16, 1), ("skinny", 16, k1)}
    if Q.q4_groups(m1, m0)[0] > Q.Q4_ROWS - 8:
        plans |= {("skinny", 64, 1), ("skinny", 64, 2)}
    return sorted(plans)


def _assert_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("m1,m0", [(20, 1), (4, 5), (3, 8), (9, 8), (2, 128)])
def test_q4_mirror_equals_plain_bit_for_bit_and_pallas(m1, m0, group):
    """20 rows at M0 = 1, a 20-row window at M0 = 5, 24 and 72 rows at M0 =
    8 (two row groups, the 128-column block), two prefill row blocks at M0
    = 128 (four 64-row slabs), under every plan the kernel takes."""
    n1, k1 = 2, 3
    ops = _q4_operands(m1 * m0 + group, m1, m0, n1, k1, group)
    plain = Q.mmt4d_q4_plain(*ops, group)
    for plan in _plans(m1, m0, n1, k1):
        _assert_bits(_q4_mirror(*ops, group, plan), plain)
    lhs4, rhs4_p, s_a, s_w4 = ops
    want = np.asarray(jq4.mmt4d_q4_pallas(
        jnp.asarray(lhs4.numpy()), jnp.asarray(rhs4_p.numpy()), jnp.asarray(s_a.numpy()),
        jnp.asarray(s_w4.float().numpy()), blocks=(1, 1, 1), group=group, interpret=True))
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=3e-5 * np.abs(want).max())


@pytest.mark.parametrize("group", [16, 32])
def test_q4_mirror_at_the_edges(group):
    """Every row -128 against every nibble -8 (each group's sum 1024 *
    group: 32768 at g32, where the double's high word carries into its
    exponent), and group scales spanning 2^-10 .. 2^10 in a row at K = 2048
    over 5 splits: the f64 sums stay exact, so the mirror equals the plain
    version bit for bit."""
    n1, k1, m1 = 1, 16, 3
    lhs4, rhs4_p, s_a, s_w4 = _q4_operands(3, m1, 8, n1, k1, group)
    edge = (torch.full_like(lhs4, -128), torch.full_like(rhs4_p, 0x88), s_a, s_w4)
    _assert_bits(_q4_mirror(*edge, group, ("skinny", 16, 5)), Q.mmt4d_q4_plain(*edge, group))
    ops = _q4_operands(4, m1, 8, n1, k1, group, span=10)
    _assert_bits(_q4_mirror(*ops, group, ("skinny", 16, 5)), Q.mmt4d_q4_plain(*ops, group))
