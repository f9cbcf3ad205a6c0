"""The packed GEMMs' plain-row entries (mmt4d_rows, mmt4d_gemv_rows,
mmt4d_q8_rows, mmt4d_q4_rows) on the CPU.

Each entry runs the plan of its packed twin at M1 = ceil(M / M0) on plain
rows x (M, K): its TMA boxes read the rows straight from x and its epilogue
stores each row at out + row * N, so the packed route launches no pack and
no unpack.  What is held here:
- The boxes (kernels/mmt4d.py: `skinny_plain_loads`, `skinny_plain_box`,
  `wide_plain_box`, `wide_plain_origin`, `slab_plain_origin`;
  kernels/mmt4d_q4.py: `q4_block_loads(plain=True)`), emulated as the
  hardware fills them (zeros past an edge, -1 for the index tensors): every
  plain-row block reads exactly the rows and K tiles its packed twin's box
  reads from pack(x), pad rows as zeros, each element of x once per output
  slice; its stores cover each row < M once, the rows its twin stores.  At
  M = 9-64 and 256, 300, 2048 at select_tile_sizes's M0 (8 at decode, 128
  at prefill), and at the M0s of 3, 5, 6 and 7 whose row groups are not a
  multiple of 8 rows.
- Each entry's plain version equals ref.unpack(ref.mmt4d*(ref.pack(x)))
  exactly and the JAX ref route on the same numpy inputs: f32 within rtol
  = atol = 1e-5 (the same exact products summed in another order), int8
  bit for bit, int4 within 1e-5 of the largest output (JAX sums the exact
  terms in f32, the port in float64).
- With the pack and unpack wrappers made to raise, encoded_matmul,
  encoded_matmul_q8 and encoded_matmul_q4 on their packed routes still equal
  JAX's: no activation goes through either.
The kernels themselves are held bit for bit against the packed routes on
the card by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.encoding import Phase as JPhase
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import to_torch
from repro_torch.core import encoding
from repro_torch.core.encoding import Phase
from repro_torch.kernels import mmt4d as M
from repro_torch.kernels import mmt4d_gemv
from repro_torch.kernels import mmt4d_q4 as Q
from repro_torch.kernels import mmt4d_q8
from repro_torch.kernels import ops
from repro_torch.kernels import pack as pack_lib
from repro_torch.kernels import ref

TOL = dict(rtol=1e-5, atol=1e-5)
# Decode rows at select_tile_sizes's M0 = 8 (9-64: the skinny body's row
# groups), then the wide windows and prefill batches.
ROWS = list(range(9, 65)) + [256, 300, 2048]
# (M, M0) whose row group G * M0 is not a multiple of 8.
ODD_M0 = [(20, 3), (33, 5), (21, 6), (65, 7), (7, 7), (300, 3)]


def _m0(m: int, phase: Phase) -> int:
    return encoding.select_tile_sizes(phase, m_hint=m).m0


def _index(m: int, k1: int, m0: int):
    """Element ids of plain rows (M, K1*128) and the packed twin's lhs4 of
    the same ids, its pad rows -1 (what TMA's zeros stand for)."""
    idx = torch.arange(m * k1 * 128).reshape(m, k1 * 128)
    return idx, ref.pack(idx + 1, (m0, 128)) - 1


def _box4(x: torch.Tensor, origin, box) -> torch.Tensor:
    """A rank-4 TMA box over x (M1, K1, M0, 128): extents `box` innermost
    first at `origin` (k0, m0, k1, m1), as e3*e2*e1 rows of e0; -1 past an
    edge."""
    k0, a0, kt, b1 = origin
    e0, e1, e2, e3 = box
    out = torch.full((e3, e2, e1, e0), -1, dtype=x.dtype)
    sub = x[b1:b1 + e3, kt:kt + e2, a0:a0 + e1, k0:k0 + e0]
    out[:sub.shape[0], :sub.shape[1], :sub.shape[2], :sub.shape[3]] = sub
    return out.reshape(e3 * e2 * e1, e0)


def _box2(x: torch.Tensor, origin, box) -> torch.Tensor:
    """A 2-D TMA box over x (M, K): extents (columns, rows) at (column,
    row); -1 past an edge."""
    c0, r0 = origin
    ec, er = box
    out = torch.full((er, ec), -1, dtype=x.dtype)
    sub = x[r0:r0 + er, c0:c0 + ec]
    out[:sub.shape[0], :sub.shape[1]] = sub
    return out


def _stores_once(m: int, group: int, blocks: int, packed_rows: int) -> None:
    """Block bz stores rows [bz * group, min((bz + 1) * group, M)): over the
    grid each row < M once, and each one a row its packed twin's block bz
    stores (rows < M1 * M0 of the same group)."""
    seen = []
    for bz in range(blocks):
        lo = bz * group
        mine = range(lo, min(lo + group, m))
        assert set(mine) <= set(range(lo, min(lo + group, packed_rows)))
        seen.extend(mine)
    assert sorted(seen) == list(range(m))


# ---------------------------------------------------------------------------
# the boxes


def _skinny_cases():
    return ([(m, _m0(m, Phase.DECODE)) for m in ROWS] + ODD_M0)


@pytest.mark.parametrize("itemsize", [2, 1])
@pytest.mark.parametrize("m,m0", _skinny_cases())
def test_skinny_plain_boxes_read_the_packed_twins_rows(m, m0, itemsize):
    """bf16 (two boxes a K tile) and int8 (one): plain block (bx, split, bz)
    reads at each K tile what its packed twin reads from pack(x), the same
    weight boxes, every element of x once per slice, and stores each row
    once."""
    k1, n1 = 2, 1
    m1 = -(-m // m0)
    idx, lhs4 = _index(m, k1, m0)
    g, groups = M.skinny_groups(m1, m0)
    box4 = (M.box_k(itemsize), m0, 1, g)
    box2 = M.skinny_plain_box(m, m0, itemsize)
    assert box2 == (M.box_k(itemsize), g * m0)
    for splits in (1, 2):
        _, _, gz = M.skinny_grid(m1, m0, n1, splits)
        assert gz == groups == -(-m // box2[1])
        seen = []
        for split in range(splits):
            lo, hi = M.skinny_split_range(split, splits, k1)
            for bz in range(gz):
                for i in range(hi - lo):
                    w4, r4 = M.skinny_block_loads(0, split, bz, i, m1, m0, splits, k1, itemsize)
                    w2, r2 = M.skinny_plain_loads(0, split, i, m, splits, k1, m0=m0, bz=bz,
                                                  itemsize=itemsize)
                    assert w2 == w4 and len(r2) == len(r4) == 128 // M.box_k(itemsize)
                    for o4, o2 in zip(r4, r2):
                        got = _box2(idx, o2, box2)
                        assert torch.equal(got, _box4(lhs4, o4, box4))
                        seen.append(got[got >= 0])
        assert (torch.bincount(torch.cat(seen), minlength=idx.numel()) == 1).all()
        _stores_once(m, box2[1], gz, m1 * m0)


def test_decode_gemv_boxes_keep_their_eight_rows():
    """The decode GEMV's call (m0 None) keeps its one (64, 8) box a half
    tile at row 0, whatever M <= 8."""
    for m in range(1, 9):
        _, rows = M.skinny_plain_loads(0, 0, 1, m, 1, 3)
        assert rows == ((128, 0), (192, 0))
    assert M.SKINNY_PLAIN_BOX == (64, 8)


def _wide_cases():
    return ([(m, 8) for m in (65, 72, 256, 300, 2048)]
            + [(m, 128) for m in (9, 20, 64, 65, 256, 300, 2048)])


@pytest.mark.parametrize("itemsize", [2, 1])
@pytest.mark.parametrize("m,m0", _wide_cases())
def test_wide_plain_boxes_read_the_packed_twins_rows(m, m0, itemsize):
    """The wgmma body: plain block row `by` at every K step lands the rows
    and K slab of its packed twin's rank-4 box; the twin's blocks past the
    plain grid hold only pad rows; each row is stored once."""
    k1 = 2
    m1 = -(-m // m0)
    idx, lhs4 = _index(m, k1, m0)
    steps = k1 * 128 // M.box_k(itemsize)
    for bm in (64, 128):
        box4 = M.wide_lhs_box(m0, bm, itemsize)
        box2 = M.wide_plain_box(bm, itemsize)
        plain_blocks = -(-m // bm)
        seen = []
        for by in range(-(-m1 * m0 // bm)):
            for step in range(steps):
                want = _box4(lhs4, M.wide_lhs_origin(by, step, m0, bm, itemsize), box4)
                if by >= plain_blocks:
                    assert (want == -1).all()
                    continue
                got = _box2(idx, M.wide_plain_origin(by, step, bm, itemsize), box2)
                assert torch.equal(got, want)
                seen.append(got[got >= 0])
        assert (torch.bincount(torch.cat(seen), minlength=idx.numel()) == 1).all()
        _stores_once(m, bm, plain_blocks, m1 * m0)


@pytest.mark.parametrize("m,m0", [(m, _m0(m, Phase.DECODE)) for m in (9, 20, 33, 57, 64, 300)]
                         + [(m, 128) for m in (9, 64, 65, 256, 300, 2048)] + ODD_M0[:3])
def test_q4_plain_boxes_read_the_packed_twins_rows(m, m0):
    """The int4 GEMM: row groups of whole row blocks (M0 <= 8) or 64-row
    slabs of one (M0 = 128): plain block bz reads at each K tile what its
    packed twin reads, the weight and scale copies unchanged; each row once."""
    k1, n1, group = 2, 1, 16
    m1 = -(-m // m0)
    idx, lhs4 = _index(m, k1, m0)
    rows, groups = Q.q4_groups(m1, m0)
    box4 = M.slab_lhs_box(Q.Q4_ROWS) if m0 > Q.Q4_ROWS else (128, m0, 1, rows // m0)
    plain_groups = -(-m // rows)
    assert plain_groups <= groups
    for bn in (Q.Q4_BN, Q.Q4_WIDE_BN):
        for splits in (1, 2):
            seen = []
            for split in range(splits):
                lo, hi = M.skinny_split_range(split, splits, k1)
                for bz in range(groups):
                    for i in range(hi - lo):
                        w4, s4, r4 = Q.q4_block_loads(0, split, bz, i, m1, m0, k1, bn, splits,
                                                      group)
                        want = _box4(lhs4, r4, box4)
                        if bz >= plain_groups:
                            assert (want == -1).all()
                            continue
                        w2, s2, r2 = Q.q4_block_loads(0, split, bz, i, m1, m0, k1, bn, splits,
                                                      group, plain=True)
                        assert (w2, s2) == (w4, s4)
                        if m0 > Q.Q4_ROWS:
                            assert r2 == M.slab_plain_origin(bz, lo + i, Q.Q4_ROWS)
                        got = _box2(idx, r2, (128, rows))
                        assert torch.equal(got, want)
                        seen.append(got[got >= 0])
            assert (torch.bincount(torch.cat(seen), minlength=idx.numel()) == 1).all()
            _stores_once(m, rows, plain_groups, m1 * m0)


def test_plain_grids_run_the_packed_twins_plan():
    """The entries take the plan the packed route would run: mmt4d_plan /
    q4_plan at M1 = ceil(M / M0), so the scratch the wrappers size for the
    twin's grid covers the plain grid (never more row groups)."""
    for m in ROWS:
        for phase in (Phase.DECODE, Phase.PREFILL):
            m0 = _m0(m, phase)
            m1 = -(-m // m0)
            plan = M.mmt4d_plan(m1, m0, 64, 16)
            if plan[0] == "skinny":
                assert M.skinny_grid(m1, m0, 64, plan[2])[2] == -(-m // M.skinny_plain_box(m, m0)[1])
            rows, groups = Q.q4_groups(m1, m0)
            assert -(-m // rows) <= groups


# ---------------------------------------------------------------------------
# the plain versions against the packed route and JAX


def _np_rows(rng, m, k, dname, scale=1.0):
    x = (rng.randn(m, k) * scale).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16)) if dname == "bf16" else x


def _np_weight(rng, n1, k1, dname):
    """A packed weight of unit-scale rows: outputs of order one."""
    return _np_rows(rng, n1 * k1 * 128, 128, dname, (k1 * 128) ** -0.5).reshape(
        n1, k1, 128, 128)


def _jax_route(x, rhs4, m0, n):
    return np.asarray(jref.unpack(jref.mmt4d(jref.pack(jnp.asarray(x), (m0, 128)),
                                             jnp.asarray(rhs4)), (x.shape[0], n)))


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("m,phase", [(9, "decode"), (20, "decode"), (64, "decode"),
                                     (65, "decode"), (300, "decode"), (20, "prefill"),
                                     (300, "prefill")])
def test_mmt4d_rows_plain_is_the_packed_route(m, phase, dname):
    rng = np.random.RandomState(m)
    n1, k1 = 3, 2
    m0 = _m0(m, Phase(phase))
    x = _np_rows(rng, m, k1 * 128, dname)
    rhs4 = _np_weight(rng, n1, k1, dname)
    tx, trhs4 = to_torch(x, "cpu"), to_torch(rhs4, "cpu")
    got = M.mmt4d_rows(tx, trhs4, m0)
    assert M.mmt4d.launches == 0 and got.shape == (m, n1 * 128) and got.dtype == torch.float32
    want = ref.unpack(ref.mmt4d(ref.pack(tx, (m0, 128)), trhs4), (m, n1 * 128))
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), _jax_route(x, rhs4, m0, n1 * 128), **TOL)


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("m", list(range(1, 9)))
def test_mmt4d_gemv_rows_plain_is_the_packed_route(m, dname):
    rng = np.random.RandomState(50 + m)
    n1, k1 = 2, 3
    x = _np_rows(rng, m, k1 * 128, dname)
    rhs4 = _np_weight(rng, n1, k1, dname)
    tx, trhs4 = to_torch(x, "cpu"), to_torch(rhs4, "cpu")
    got = mmt4d_gemv.mmt4d_gemv_rows(tx, trhs4)
    assert mmt4d_gemv.mmt4d_gemv.launches == 0
    want = ref.unpack(mmt4d_gemv.mmt4d_gemv(ref.pack(tx, (m, 128)), trhs4), (m, n1 * 128))
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), _jax_route(x, rhs4, m, n1 * 128), **TOL)


def test_mmt4d_gemv_rows_takes_one_row_block():
    with pytest.raises(ValueError, match="1..8 rows"):
        mmt4d_gemv.mmt4d_gemv_rows(torch.zeros(9, 128), torch.zeros(1, 1, 128, 128))


def _quant_case(rng, m, n1, k1):
    xq = rng.randint(-127, 128, (m, k1 * 128)).astype(np.int8)
    s_a = (rng.rand(m).astype(np.float32) + 0.5) / 127
    w = rng.randn(n1 * 128, k1 * 128).astype(np.float32) * (k1 * 128) ** -0.5
    return xq, s_a, w


@pytest.mark.parametrize("m,phase", [(9, "decode"), (20, "decode"), (57, "decode"),
                                     (65, "decode"), (300, "decode"), (20, "prefill"),
                                     (300, "prefill")])
def test_mmt4d_q8_rows_plain_is_the_packed_route(m, phase):
    rng = np.random.RandomState(100 + m)
    n1, k1 = 3, 2
    m0 = _m0(m, Phase(phase))
    xq, s_a, w = _quant_case(rng, m, n1, k1)
    rhs4_q, s_w = jops.pack_rhs_q8(jnp.asarray(w))
    t_rhs4, t_sw = to_torch(np.asarray(rhs4_q), "cpu"), to_torch(np.asarray(s_w), "cpu")
    txq, tsa = to_torch(xq, "cpu"), to_torch(s_a, "cpu")
    got = mmt4d_q8.mmt4d_q8_rows(txq, t_rhs4, tsa, t_sw, m0)
    assert mmt4d_q8.mmt4d_q8.launches == 0
    lhs4 = ref.pack(txq, (m0, 128))
    sa2 = torch.nn.functional.pad(tsa, (0, lhs4.shape[0] * m0 - m)).reshape(-1, m0)
    want = ref.unpack(ref.mmt4d_q8(lhs4, t_rhs4, sa2, t_sw), (m, n1 * 128))
    assert torch.equal(got, want)
    jl = jref.pack(jnp.asarray(xq), (m0, 128))
    jout = jref.mmt4d_q8(jl, rhs4_q, jnp.asarray(sa2.numpy()), s_w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.unpack(jout, (m, n1 * 128))))


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("m,phase", [(9, "decode"), (20, "decode"), (64, "decode"),
                                     (300, "decode"), (37, "prefill"), (300, "prefill")])
def test_mmt4d_q4_rows_plain_is_the_packed_route(m, phase, group):
    rng = np.random.RandomState(200 + m + group)
    n1, k1 = 2, 2
    m0 = _m0(m, Phase(phase))
    xq, s_a, w = _quant_case(rng, m, n1, k1)
    rhs4_p, s_w4 = jops.pack_rhs_q4(jnp.asarray(w), group=group)
    t_rhs4, t_sw4 = to_torch(np.asarray(rhs4_p), "cpu"), to_torch(np.asarray(s_w4), "cpu")
    txq, tsa = to_torch(xq, "cpu"), to_torch(s_a, "cpu")
    got = Q.mmt4d_q4_rows(txq, t_rhs4, tsa, t_sw4, group, m0)
    assert Q.mmt4d_q4.launches == 0
    lhs4 = ref.pack(txq, (m0, 128))
    sa2 = torch.nn.functional.pad(tsa, (0, lhs4.shape[0] * m0 - m)).reshape(-1, m0)
    want = ref.unpack(ref.mmt4d_q4(lhs4, t_rhs4, sa2, t_sw4, group), (m, n1 * 128))
    assert torch.equal(got, want)
    jl = jref.pack(jnp.asarray(xq), (m0, 128))
    jout = np.asarray(jref.unpack(jref.mmt4d_q4(jl, rhs4_p, jnp.asarray(sa2.numpy()), s_w4,
                                                group), (m, n1 * 128)))
    np.testing.assert_allclose(got.numpy(), jout, rtol=0, atol=1e-5 * np.abs(jout).max())


def test_entries_check_operands():
    """Rows must cover the packed K, int8 entries take s_a (M,); anything
    but the CPU and CUDA raises."""
    w = torch.zeros(1, 2, 128, 128)
    with pytest.raises(ValueError, match="want rows"):
        M.mmt4d_rows(torch.zeros(4, 200), w, 4)
    with pytest.raises(ValueError, match="M0"):
        M.mmt4d_rows(torch.zeros(4, 256), w, 9)
    xq = torch.zeros(4, 256, dtype=torch.int8)
    wq = torch.zeros(1, 2, 128, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="s_a"):
        mmt4d_q8.mmt4d_q8_rows(xq, wq, torch.zeros(4, 1), torch.zeros(1, 128), 4)
    meta = dict(device="meta")
    with pytest.raises(RuntimeError, match="runs on cuda"):
        M.mmt4d_rows(torch.zeros(4, 256, **meta), torch.zeros(1, 2, 128, 128, **meta), 4)
    with pytest.raises(RuntimeError, match="runs on cuda"):
        mmt4d_gemv.mmt4d_gemv_rows(torch.zeros(4, 256, **meta),
                                   torch.zeros(1, 2, 128, 128, **meta))


# ---------------------------------------------------------------------------
# the packed routes launch no pack and no unpack


@pytest.fixture
def no_activation_packs(monkeypatch):
    """After the weights are packed: pack and unpack raise if called."""
    def refuse(*args, **kwargs):
        raise AssertionError("a packed route called the pack or unpack wrapper")

    def arm():
        monkeypatch.setattr(pack_lib, "pack", refuse)
        monkeypatch.setattr(pack_lib, "unpack", refuse)
    return arm


def _unit(rng, n, k):
    return rng.randn(n, k).astype(np.float32) * k**-0.5


@pytest.mark.parametrize("phase,m", [("decode", 4), ("decode", 20), ("decode", 65),
                                     ("prefill", 130)])
def test_pallas_route_packs_nothing(no_activation_packs, phase, m):
    rng = np.random.RandomState(m)
    n, k = 300, 200
    x = np.asarray(jnp.asarray(rng.randn(m, k), jnp.bfloat16))
    w_t = np.asarray(jnp.asarray(_unit(rng, n, k), jnp.bfloat16))
    rhs4 = jops.pack_rhs(jnp.asarray(w_t))
    want = jops.encoded_matmul(jnp.asarray(x), rhs4, n=n, phase=JPhase(phase),
                               backend="pallas", out_dtype=jnp.float32, interpret=True)
    got_rhs4 = ops.pack_rhs(to_torch(w_t, "cpu"))
    no_activation_packs()
    got = ops.encoded_matmul(to_torch(x, "cpu"), got_rhs4, n=n, phase=Phase(phase),
                             backend="pallas", out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("backend", ["pallas", "fused"])
@pytest.mark.parametrize("quant", ["w8a8", "w4a8"])
@pytest.mark.parametrize("phase,m", [("decode", 20), ("decode", 65), ("prefill", 37)])
def test_quantized_packed_routes_pack_nothing(no_activation_packs, quant, backend, phase, m):
    """w8a8 bit for bit, w4a8 within 1e-5 of the largest output; "fused"
    takes the packed GEMM past 8 decode rows and at prefill."""
    rng = np.random.RandomState(m + 7)
    n, k = 300, 200
    x = np.asarray(jnp.asarray(rng.randn(m, k), jnp.bfloat16))
    w_t = _unit(rng, n, k)
    kw = dict(n=n, phase=Phase(phase), backend=backend, out_dtype=torch.float32)
    jkw = dict(n=n, phase=JPhase(phase), backend="pallas", out_dtype=jnp.float32,
               interpret=True)
    if quant == "w8a8":
        want = jops.encoded_matmul_q8(jnp.asarray(x), *jops.pack_rhs_q8(jnp.asarray(w_t)), **jkw)
        weights = ops.pack_rhs_q8(to_torch(w_t, "cpu"))
        no_activation_packs()
        got = ops.encoded_matmul_q8(to_torch(x, "cpu"), *weights, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        want = np.asarray(jops.encoded_matmul_q4(
            jnp.asarray(x), *jops.pack_rhs_q4(jnp.asarray(w_t), group=16), group=16, **jkw))
        weights = ops.pack_rhs_q4(to_torch(w_t, "cpu"), group=16)
        no_activation_packs()
        got = ops.encoded_matmul_q4(to_torch(x, "cpu"), *weights, group=16, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
