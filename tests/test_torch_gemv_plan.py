"""The w8a8 and w4a8 decode GEMVs' plan and device arithmetic
(kernels/fused_gemv.py: fused_gemv_q8, kernels/mmt4d_q4.py: fused_gemv_q4,
both on the decode-GEMV body of csrc/gemv_warps.cuh), mirrored in Python, on
the CPU.

- The plans (`gemv_q8_plan`, `gemv_q4_plan`) at the four Llama-3.2-1B
  decode projections (K x N = 2048 x 2048, 2048 x 512, 2048 x 8192, 8192 x
  2048) and M = 1..8, both groups: one body, 16-column blocks over the
  whole of K (32 / 128 / 512 / 128 blocks, no K split across blocks), 16
  warps a block or 8 where the grid is large.
- The warps' K ranges (`gemv_warp_tiles`, the kernel's gv_warp_tiles):
  every K tile of a block taken by one warp, contiguous, in warp order.
- A lane-by-lane mirror of both bodies: each lane's 16-byte loads, the
  quad exchange of the nibble words, the mma.sync m16n8k32 s8 fragments as
  PTX lays them out (emulated here, independently of the kernel's code),
  the int32 fragment sums, the f64 rescale of each nibble group from its
  Q4_C-offset fragment, the warps' sums added in warp order and the
  epilogue.  At a reduced size (K1 <= 4, N1 <= 2), for every warp count the
  plan can pick, it equals the plain version bit for bit (tolerance 0: the
  sums are exact) and JAX's Pallas GEMVs in interpret mode: bit for bit
  (int8: the same integer sum and f32 epilogue) or within 1e-5 of the
  largest output (int4: JAX sums the dequantized terms in f32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import fused_gemv as jgemv
from repro.kernels import mmt4d_q4 as jq4
from repro_torch.kernels import fused_gemv as G
from repro_torch.kernels import mmt4d_q4 as Q

SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]  # (K, N)
Q4_C = 0x40F80000      # csrc/packed_skinny.cuh: the high word of 1.5 * 2^16
Q4_OFFSET = 98304.0    # 1.5 * 2^16
NIB = np.uint32(0xF0F0F0F0)
LANE = np.arange(32)
LG, LT = LANE >> 2, LANE & 3  # lane (g, t)




def gemv_warp_tiles(warp: int, warps: int, k1: int) -> tuple[int, int]:
    """The K tiles [lo, hi) warp `warp` of `warps` takes
    (csrc/gemv_warps.cuh: gv_warp_tiles)."""
    return warp * k1 // warps, (warp + 1) * k1 // warps


def gemv_q4_row_blocks(m: int, group: int) -> int:
    """8-row blocks of the nibble body's B side (csrc/mmt4d_q4.cu: NB): at
    g16 a step's B columns hold 4 rows (each twice, once per group half),
    so 5-8 rows take a second step."""
    return 2 if group == 16 and m > 4 else 1


# ---- the plans ---------------------------------------------------------------------


@pytest.mark.parametrize("m", list(range(1, 9)))
def test_gemv_plans_at_the_decode_shapes(m):
    """One body, GEMV_BN = 16 columns a block over the whole of K: N / 16
    blocks, 32 / 128 / 512 / 128 at the four projections, so no shape
    splits K; 16 warps a block, 8 where the grid has more than two blocks
    an SM (N = 8192); the same for int4 at either group."""
    want = {(2048, 2048): (128, 16), (2048, 512): (32, 16), (2048, 8192): (512, 8),
            (8192, 2048): (128, 16)}
    for (k, n), (blocks, warps) in want.items():
        k1, n1 = k // 128, n // 128
        plans = [G.gemv_q8_plan(m, k1, n1)] + [Q.gemv_q4_plan(m, k1, n1, g) for g in (16, 32)]
        for plan in plans:
            assert plan == ("warps", G.GEMV_BN, warps)
            assert n1 * 128 // plan[1] == blocks
            assert G.check_gemv_plan(plan, "plan") == plan


@pytest.mark.parametrize("n1", [1, 4, 16, 33, 34, 64, 128])
def test_gemv_warps_keep_the_grid_resident(n1):
    """8 warps a block where the grid has more than 2 * 132 blocks (N1 >
    33), else 16: at most 264 blocks of 16 warps or 32 warps an SM's worth
    of 8-warp blocks per SM pass, so a wave holds them all."""
    blocks = n1 * 128 // G.GEMV_BN
    assert G.gemv_warps(n1) == (8 if blocks > 264 else 16)


def test_gemv_plan_overrides():
    """A forced plan names the warps, 8 or 16; anything else is refused."""
    for w in G.GEMV_WARPS:
        assert G.check_gemv_plan(("warps", G.GEMV_BN, w), "x") == ("warps", G.GEMV_BN, w)
    for bad in (("warps", 32, 8), ("warps", 16, 4), ("warps", 16, 8, 2), ("skinny", 32, 1)):
        with pytest.raises(ValueError, match="takes"):
            G.check_gemv_plan(bad, "x")


@pytest.mark.parametrize("k1", [1, 2, 3, 5, 16, 64])
@pytest.mark.parametrize("warps", G.GEMV_WARPS)
def test_warp_tiles_cover_k_once_in_order(k1, warps):
    """Warp w takes [w*K1/W, (w+1)*K1/W): the ranges tile [0, K1) in warp
    order, each K tile once (some warps none when K1 < W)."""
    ranges = [gemv_warp_tiles(w, warps, k1) for w in range(warps)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k1
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi - lo in (k1 // warps, -(-k1 // warps)) for lo, hi in ranges)


# ---- the mirror ------------------------------------------------------------------


def _words(b: np.ndarray) -> np.ndarray:
    """(..., 4k) bytes -> (..., k) little-endian 32-bit words."""
    return np.ascontiguousarray(b).view(np.uint8).view("<u4")


def _bytes(w: np.ndarray) -> np.ndarray:
    """(...,) 32-bit words -> (..., 4) int8 bytes, lowest first."""
    return np.ascontiguousarray(w.astype("<u4")).view(np.int8).reshape(*w.shape, 4)


def _mma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32, lanes on the first axis, as
    the PTX ISA lays out its fragments: a (32, 4) words (a0: row g, K
    4t..4t+3; a1: row g+8; a2, a3: K 16+4t..), b (32, 2) (column g, K
    4t.. and 16+4t..), c and the result (32, 4) (rows g, g, g+8, g+8;
    columns 2t, 2t+1, 2t, 2t+1)."""
    ab, bb = _bytes(a).astype(np.int64), _bytes(b).astype(np.int64)
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for i in range(4):
        A[LG, 4 * LT + i] = ab[:, 0, i]
        A[LG + 8, 4 * LT + i] = ab[:, 1, i]
        A[LG, 16 + 4 * LT + i] = ab[:, 2, i]
        A[LG + 8, 16 + 4 * LT + i] = ab[:, 3, i]
        B[4 * LT + i, LG] = bb[:, 0, i]
        B[16 + 4 * LT + i, LG] = bb[:, 1, i]
    D = A @ B
    return c + np.stack([D[LG, 2 * LT], D[LG, 2 * LT + 1], D[LG + 8, 2 * LT],
                         D[LG + 8, 2 * LT + 1]], axis=1)


def _stash(red_w: np.ndarray, acc: np.ndarray, rows: np.ndarray, lanes: np.ndarray) -> None:
    """A warp's fragment (32, 4) into its sums [row][column]: acc[:, 0] at
    (rows, g), 1 at (rows + 1, g), 2 and 3 at column g + 8; `lanes` write."""
    for i, (dr, dc) in enumerate(((0, 0), (1, 0), (0, 8), (1, 8))):
        red_w[rows[lanes] + dr, LG[lanes] + dc] = acc[lanes, i]


def mirror_q8(xq, rhs4, s_a, s_w, warps):
    """The int8 body, lane by lane: lane (g, t) loads bytes 16t.. and
    64+16t.. of weight rows g and g+8 and of row g of x (zeros past M);
    each 16 bytes feed two k32 steps as they stand."""
    m, k = xq.shape
    n1, k1 = rhs4.shape[:2]
    xpad = np.zeros((8, k), np.int8)
    xpad[:m] = xq
    out = np.zeros((m, n1 * 128), np.float32)
    for bx in range(n1 * 128 // G.GEMV_BN):
        nt, nc = divmod(bx * G.GEMV_BN, 128)
        red = np.zeros((warps, 8, 16), np.int64)
        for w in range(warps):
            lo, hi = gemv_warp_tiles(w, warps, k1)
            acc = np.zeros((32, 4), np.int64)
            for kt in range(lo, hi):
                for h in (0, 1):
                    cols = 16 * (LT + 4 * h)[:, None] + np.arange(16)
                    wa = _words(rhs4[nt, kt][(nc + LG)[:, None], cols])
                    wb = _words(rhs4[nt, kt][(nc + LG + 8)[:, None], cols])
                    xv = _words(xpad[LG[:, None], kt * 128 + cols])
                    for q in (0, 1):
                        a = np.stack([wa[:, 2 * q], wb[:, 2 * q], wa[:, 2 * q + 1],
                                      wb[:, 2 * q + 1]], axis=1)
                        acc = _mma(a, xv[:, 2 * q:2 * q + 2], acc)
            _stash(red[w], acc, 2 * LT, LANE)
        s = red[0]
        for w in range(1, warps):
            s = s + red[w]
        n = nt * 128 + nc + np.arange(16)
        out[:, bx * 16:(bx + 1) * 16] = ((s[:m].astype(np.float32) * s_a[:m])
                                         * s_w.reshape(-1)[n])
    return out


def _hilo(c: np.ndarray) -> np.ndarray:
    """__hiloint2double(c, 0): the int32 as the high word of a double."""
    return (c.astype(np.int64).astype(np.uint64) << np.uint64(32)).view(np.float64)


def _bf16_f64(s: np.ndarray) -> np.ndarray:
    return (s.astype(np.uint32) << np.uint32(16)).view(np.float32).astype(np.float64)


def mirror_q4(xq, rhs4_p, s_a, s_w4_bits, group, warps):
    """The nibble body, lane by lane: lane (g, t) loads bytes 16t..16t+15 of
    weight rows g and g+8; the quad exchange leaves it word t of each 16-byte
    chunk c; a k32 step takes chunk c's low nibbles (16 w) in slots 4t.. and
    high ones in 16+4t.., the rows' bytes at K 32c + 8t split into even and
    odd elements on the B side.  g32: B column j is row j; g16: lane t's
    slots are group 2c + t/2, B column j row 4 rb + j%4 on the lanes of
    group half j/4 only, a second step (rb = 1) past 4 rows.  Each group's
    fragment starts at Q4_C and is rescaled in f64 (the products are exact,
    so a * b + c is the DFMA)."""
    m, k = xq.shape
    n1, k1 = rhs4_p.shape[:2]
    gpt = 128 // group
    nb = gemv_q4_row_blocks(m, group)
    out = np.zeros((m, n1 * 128), np.float32)
    xrows, xlive = [], []
    for rb in range(nb):
        r = LG if group == 32 else 4 * rb + (LG & 3)
        live = (r < m) & ((group == 32) | ((LT >> 1) == (LG >> 2)))
        xrows.append(np.where(live, r, 0))
        xlive.append(live)
    for bx in range(n1 * 128 // G.GEMV_BN):
        nt, nc = divmod(bx * G.GEMV_BN, 128)
        red = np.zeros((warps, 8, 16), np.float64)
        for w in range(warps):
            lo, hi = gemv_warp_tiles(w, warps, k1)
            acc = np.zeros((nb, 32, 4), np.float64)
            ssum = np.zeros((32, 2), np.float64)
            for kt in range(lo, hi):
                cols = 16 * LT[:, None] + np.arange(16)
                w0 = _words(rhs4_p[nt, kt][(nc + LG)[:, None], cols])       # (32, 4)
                w1 = _words(rhs4_p[nt, kt][(nc + LG + 8)[:, None], cols])
                v0 = w0[4 * LG[:, None] + np.arange(4), LT[:, None]]        # word t of lane c
                v1 = w1[4 * LG[:, None] + np.arange(4), LT[:, None]]
                s0 = _bf16_f64(s_w4_bits[nt, kt, nc + LG])                  # (32, gpt)
                s1 = _bf16_f64(s_w4_bits[nt, kt, nc + LG + 8])
                for c in range(4):
                    p0, p1 = v0[:, c], v1[:, c]
                    a = np.stack([(p0 << 4) & NIB, (p1 << 4) & NIB, p0 & NIB, p1 & NIB], axis=1)
                    grp = np.full(32, c) if group == 32 else 2 * c + (LT >> 1)
                    d0, d1 = s0[LANE, grp], s1[LANE, grp]
                    ssum += np.stack([d0, d1], axis=1)
                    for rb in range(nb):
                        xb = xq[xrows[rb][:, None], kt * 128 + 32 * c + 8 * LT[:, None]
                                + np.arange(8)]
                        xb = np.where(xlive[rb][:, None], xb, 0).astype(np.int8)
                        b = np.stack([_words(xb[:, 0::2]), _words(xb[:, 1::2])], axis=1)[:, :, 0]
                        cc = _mma(a, b, np.full((32, 4), Q4_C, np.int64))
                        acc[rb] += _hilo(cc) * np.stack([d0, d0, d1, d1], axis=1)
            acc = acc - Q4_OFFSET * ssum[:, [0, 0, 1, 1]]
            if group == 16:
                acc = acc + acc[:, LANE ^ 2]
            for rb in range(nb):
                if group == 32:
                    _stash(red[w], acc[rb], 2 * LT, LANE)
                else:
                    _stash(red[w], acc[rb], 4 * rb + 2 * (LT & 1), LT < 2)
        s = red[0]
        for w in range(1, warps):
            s = s + red[w]
        out[:, bx * 16:(bx + 1) * 16] = s[:m].astype(np.float32) * s_a[:m]
    return out


def _q8_operands(rng, m, n1, k1):
    xq = rng.randint(-128, 128, (m, k1 * 128)).astype(np.int8)
    rhs4 = rng.randint(-128, 128, (n1, k1, 128, 128)).astype(np.int8)
    s_a = ((0.5 + rng.rand(m, 1)) * 1e-2).astype(np.float32)
    s_w = ((0.5 + rng.rand(n1, 128)) * 1e-2).astype(np.float32)
    return xq, rhs4, s_a, s_w


def _q4_operands(rng, m, n1, k1, group):
    xq = rng.randint(-128, 128, (m, k1 * 128)).astype(np.int8)
    rhs4_p = rng.randint(0, 256, (n1, k1, 128, 64)).astype(np.uint8)
    s_a = ((0.5 + rng.rand(m, 1)) * 1e-2).astype(np.float32)
    s_w4 = torch.from_numpy(((0.5 + rng.rand(n1, k1, 128, 128 // group)) * 1e-2)
                            .astype(np.float32)).to(torch.bfloat16)
    return xq, rhs4_p, s_a, s_w4


@pytest.mark.parametrize("warps", G.GEMV_WARPS)
@pytest.mark.parametrize("m,n1,k1", [(1, 1, 4), (2, 1, 1), (3, 2, 3), (5, 1, 2), (6, 2, 2),
                                     (8, 1, 4)])
def test_q8_mirror_equals_plain_and_pallas(m, n1, k1, warps):
    """The int8 mirror equals fused_gemv_q8_plain and JAX's
    fused_gemv_q8_pallas (interpret mode) bit for bit."""
    xq, rhs4, s_a, s_w = _q8_operands(np.random.RandomState(m * 31 + k1), m, n1, k1)
    got = mirror_q8(xq, rhs4, s_a, s_w, warps)
    plain = G.fused_gemv_q8(*(torch.from_numpy(a) for a in (xq, rhs4, s_a, s_w)))
    np.testing.assert_array_equal(got, plain.numpy())
    want = jgemv.fused_gemv_q8_pallas(jnp.asarray(xq), jnp.asarray(rhs4), jnp.asarray(s_a),
                                      jnp.asarray(s_w), bn1=1, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("warps", G.GEMV_WARPS)
@pytest.mark.parametrize("m,n1,k1", [(1, 1, 4), (2, 1, 1), (4, 2, 3), (5, 1, 2), (6, 2, 2),
                                     (8, 1, 4)])
def test_q4_mirror_equals_plain_and_pallas(m, n1, k1, warps, group):
    """The nibble mirror equals fused_gemv_q4_plain bit for bit, and JAX's
    fused_gemv_q4_pallas (interpret mode, f32 sums) within 1e-5 of the
    largest output."""
    xq, rhs4_p, s_a, s_w4 = _q4_operands(np.random.RandomState(m * 7 + group + k1), m, n1,
                                         k1, group)
    bits = s_w4.view(torch.int16).numpy().view(np.uint16)
    got = mirror_q4(xq, rhs4_p, s_a, bits, group, warps)
    plain = Q.fused_gemv_q4(torch.from_numpy(xq), torch.from_numpy(rhs4_p),
                            torch.from_numpy(s_a), s_w4, group)
    np.testing.assert_array_equal(got, plain.numpy())
    want = np.asarray(jq4.fused_gemv_q4_pallas(
        jnp.asarray(xq), jnp.asarray(rhs4_p), jnp.asarray(s_a),
        jnp.asarray(s_w4.float().numpy()).astype(jnp.bfloat16), bn1=1, group=group,
        interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("group", [16, 32])
def test_q4_mirror_extreme_sums_and_scales(group):
    """Every row -128 against every nibble -8 (each group's sum 1024 *
    group: 32768 at g32 carries the fragment's high word into the double's
    exponent), then group scales spanning 2^-10 .. 2^10 in each weight row:
    still exact, so the mirror equals the plain version bit for bit."""
    m, n1, k1 = 8, 1, 4
    rng = np.random.RandomState(group)
    _, _, s_a, s_w4 = _q4_operands(rng, m, n1, k1, group)
    xq = np.full((m, k1 * 128), -128, np.int8)
    rhs4_p = np.full((n1, k1, 128, 64), 0x88, np.uint8)
    span = torch.from_numpy(np.exp2(rng.randint(-10, 11, s_w4.shape)).astype(np.float32))
    for scales in (s_w4, (s_w4.float() * span).to(torch.bfloat16)):
        bits = scales.view(torch.int16).numpy().view(np.uint16)
        got = mirror_q4(xq, rhs4_p, s_a, bits, group, 4)
        plain = Q.fused_gemv_q4(torch.from_numpy(xq), torch.from_numpy(rhs4_p),
                                torch.from_numpy(s_a), scales, group)
        np.testing.assert_array_equal(got, plain.numpy())
        xq = rng.randint(-128, 128, xq.shape).astype(np.int8)
        rhs4_p = rng.randint(0, 256, rhs4_p.shape).astype(np.uint8)


def test_q8_mirror_sums_past_f32():
    """All operands 127 at K = 8192 in the mirror's int32 fragments: |sum| =
    132128768 > 2^24, exact, so equal to the plain version bit for bit."""
    m, n1, k1 = 2, 1, 64
    xq = np.full((m, k1 * 128), 127, np.int8)
    rhs4 = np.full((n1, k1, 128, 128), 127, np.int8)
    s_a = np.full((m, 1), 0.5, np.float32)
    s_w = np.full((n1, 128), 0.25, np.float32)
    got = mirror_q8(xq, rhs4, s_a, s_w, 16)
    plain = G.fused_gemv_q8(*(torch.from_numpy(a) for a in (xq, rhs4, s_a, s_w)))
    np.testing.assert_array_equal(got, plain.numpy())
    assert got[0, 0] == np.float32(127 * 127 * 8192) * np.float32(0.5) * np.float32(0.25)
