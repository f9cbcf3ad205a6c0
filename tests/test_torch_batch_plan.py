"""The batched packed GEMM's (kernels/batch_mmt4d.py, csrc/batch_mmt4d.cu)
host-side arithmetic, on the CPU.

- `batch_mmt4d_plan`: its (BM, BN) tile fills a wave of 132 SMs at the
  attention shapes, and the kernel's blocks, as csrc/batch_mmt4d.cu maps
  blockIdx.x to a batch entry and an output tile and an output element to
  its packed address, write every element of out5 (B, M1, N1, M0, N0)
  exactly once: at the JAX test's shapes, the attention shapes and tiles
  past the old kernel's 1024 outputs.
- The kernel's division by M0, N0 and K0 (a multiply-high and a shift,
  the multiplier computed on the host) is exact for every index it takes.
- A Python mirror of the kernel's body: BK = 32 K elements at a time, each
  staged from the packed addresses the kernel computes (row m is (m / M0,
  m % M0), column k is (k / K0, k % K0)), zeros past the edges, summed in
  f32 one stage after the other.  It must agree with ref.batch_mmt4d and
  JAX's batch_mmt4d_pallas (interpret mode, as the JAX tests run it) within
  rtol 1e-5, atol 1e-4: f32 sums of the same exact products (bf16 products
  are exact in f32) in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import batch_mmt4d as jbatch
from repro_torch.kernels import batch_mmt4d as B
from repro_torch.kernels.fused_pack_mmt4d import GEMM_WAVE

# (B, M1, N1, K1, M0, N0, K0)
JAX_SHAPES = [(2, 2, 3, 3, 16, 8, 8), (3, 4, 5, 2, 8, 32, 16)]
ATTENTION = [(128, 8, 8, 1, 16, 16, 64), (128, 8, 4, 2, 16, 16, 64)]
PAST_OLD_LIMIT = [(2, 2, 2, 3, 64, 64, 40), (32, 2, 2, 2, 64, 64, 64), (3, 3, 2, 2, 5, 7, 13),
                  (1, 1, 1, 2, 200, 130, 3)]


def _blocks(bsz, m, n, bm, bn):
    """(z, m_base, n_base) of every block, as the kernel decodes blockIdx.x."""
    tiles_n = -(-n // bn)
    tiles = -(-m // bm) * tiles_n
    for bx in range(bsz * tiles):
        z, tile = divmod(bx, tiles)
        yield z, (tile // tiles_n) * bm, (tile % tiles_n) * bn


def _out_index(z, m, n, m1, n1, m0, n0):
    """The kernel's packed output address of (z, m, n) (numpy arrays)."""
    a1, b1 = m // m0, n // n0
    return (z * m1 * n1 * m0 * n0 + ((a1 * n1 + b1) * m0 + (m - a1 * m0)) * n0 + (n - b1 * n0))


def _at(x, k, x0, k1, k0):
    """The kernel's packed operand address of row x, column k of one batch
    entry (X1, K1, X0, K0)."""
    a1, c1 = x // x0, k // k0
    return ((a1 * k1 + c1) * x0 + (x - a1 * x0)) * k0 + (k - c1 * k0)


def _make_div(d: int) -> tuple[int, int]:
    """csrc/batch_mmt4d.cu: make_div, the multiplier and shift of n / d."""
    if d == 1:
        return 0, 0
    l = (d - 1).bit_length()  # ceil(log2 d)
    p = 31 + l
    return ((1 << p) + d - 1) // d, p - 32


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 8, 13, 16, 24, 40, 64, 100, 128, 130, 200, 1000,
                               4097, 65535, 2**20 + 7])
def test_fast_division_is_exact(d):
    """The kernel's n / d as (n * mul) >> 32 >> shr, for n in [0, 2^31)."""
    mul, shr = _make_div(d)
    assert mul < 2**32
    rng = np.random.RandomState(d)
    ns = np.concatenate([np.arange(0, 5000), rng.randint(0, 2**31, size=20000),
                         np.arange(2**31 - 5000, 2**31), d * np.arange(1, 2000),
                         d * np.arange(1, 2000) - 1]).astype(np.uint64)
    ns = ns[ns < 2**31]
    got = ns if d == 1 else ((ns * np.uint64(mul)) >> np.uint64(32)) >> np.uint64(shr)
    np.testing.assert_array_equal(got, ns // np.uint64(d))


def test_plan_fills_a_wave_at_the_attention_shapes():
    for bsz, m1, n1, _, m0, n0, _ in ATTENTION:
        bm, bn, bk = B.batch_mmt4d_plan(bsz, m1 * m0, n1 * n0)
        assert (bm, bn, bk) == (64, 64, B.STAGE_K)
        assert bsz * -(-m1 * m0 // bm) * -(-n1 * n0 // bn) >= GEMM_WAVE
    assert B.batch_mmt4d_plan(2, 32, 24) == (32, 32, B.STAGE_K)   # none fills: the smallest
    assert B.batch_mmt4d_plan(3, 64, 64)[:2] == (32, 32)
    assert B.batch_mmt4d_plan(66, 64, 64)[:2] == (32, 64)  # 66 blocks of 64 x 64, 132 of 32 x 64


@pytest.mark.parametrize("shape", JAX_SHAPES + ATTENTION + PAST_OLD_LIMIT)
def test_blocks_write_every_output_once(shape):
    bsz, m1, n1, _, m0, n0, _ = shape
    m, n = m1 * m0, n1 * n0
    bm, bn, _ = B.batch_mmt4d_plan(bsz, m, n)
    counts = np.zeros(bsz * m * n, dtype=np.int64)
    for tile_bm, tile_bn in ((bm, bn),) + B.TILES:
        counts[:] = 0
        for z, mb, nb in _blocks(bsz, m, n, tile_bm, tile_bn):
            mm, nn = np.meshgrid(np.arange(mb, mb + tile_bm), np.arange(nb, nb + tile_bn),
                                 indexing="ij")
            live = (mm < m) & (nn < n)
            np.add.at(counts, _out_index(z, mm[live], nn[live], m1, n1, m0, n0), 1)
        assert (counts == 1).all(), (tile_bm, tile_bn)


def _mirror(lhs5: torch.Tensor, rhs5: torch.Tensor) -> torch.Tensor:
    """The kernel's body in Python: every block stages BK K elements of its
    rows and columns from the packed addresses (zeros past the edges) and
    sums the stages in f32; the outputs land at the packed addresses."""
    bsz, m1, k1, m0, k0 = lhs5.shape
    _, n1, _, n0, _ = rhs5.shape
    m, n, kk_all = m1 * m0, n1 * n0, k1 * k0
    bm, bn, bk = B.batch_mmt4d_plan(bsz, m, n)
    lflat = lhs5.float().reshape(bsz, -1)
    rflat = rhs5.float().reshape(bsz, -1)
    out = torch.full((bsz * m * n,), float("nan"))

    def stage(flat, z, base, rows, x0, kc, r):
        xs = torch.arange(base, base + r)[:, None].expand(r, bk)
        ks = torch.arange(kc, kc + bk)[None, :].expand(r, bk)
        live = (xs < rows) & (ks < kk_all)
        tile = torch.zeros(r, bk)
        tile[live] = flat[z][_at(xs[live], ks[live], x0, k1, k0)]
        return tile

    for z, mb, nb in _blocks(bsz, m, n, bm, bn):
        acc = torch.zeros(bm, bn)
        for kc in range(0, kk_all, bk):
            a = stage(lflat, z, mb, m, m0, kc, bm)
            b = stage(rflat, z, nb, n, n0, kc, bn)
            acc = acc + a @ b.t()
        mm, nn = np.meshgrid(np.arange(mb, mb + bm), np.arange(nb, nb + bn), indexing="ij")
        live = torch.from_numpy((mm < m) & (nn < n))
        idx = torch.from_numpy(_out_index(z, mm, nn, m1, n1, m0, n0))
        out[idx[live]] = acc[live]
    return out.reshape(bsz, m1, n1, m0, n0)


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("shape", JAX_SHAPES + PAST_OLD_LIMIT[:1] + PAST_OLD_LIMIT[2:3])
def test_mirror_matches_plain_and_pallas(shape, dname):
    bsz, m1, n1, k1, m0, n0, k0 = shape
    dt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dname]
    rng = np.random.RandomState(sum(shape))
    lhs = np.asarray(jnp.asarray(rng.randn(bsz, m1, k1, m0, k0), dt))
    rhs = np.asarray(jnp.asarray(rng.randn(bsz, n1, k1, n0, k0), dt))
    t_lhs = torch.from_numpy(lhs.astype(np.float32)).to(
        torch.bfloat16 if dname == "bf16" else torch.float32)
    t_rhs = torch.from_numpy(rhs.astype(np.float32)).to(t_lhs.dtype)
    got = _mirror(t_lhs, t_rhs)
    assert not got.isnan().any()
    plain = B.batch_mmt4d_plain(t_lhs, t_rhs)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-4)
    want = jbatch.batch_mmt4d_pallas(jnp.asarray(lhs), jnp.asarray(rhs), blocks=(1, 1, 1),
                                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_mirror_at_the_attention_scores_shape():
    """The scores shape (128 GEMMs of 128 x 128, K = 64), the plain version
    only (the Pallas grid would take 8192 interpreted steps)."""
    bsz, m1, n1, k1, m0, n0, k0 = ATTENTION[0]
    g = torch.Generator().manual_seed(0)
    lhs = torch.randn((bsz, m1, k1, m0, k0), generator=g)
    rhs = torch.randn((bsz, n1, k1, n0, k0), generator=g)
    torch.testing.assert_close(_mirror(lhs, rhs), B.batch_mmt4d_plain(lhs, rhs),
                               rtol=1e-5, atol=1e-4)
