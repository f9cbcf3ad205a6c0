"""The prefill kernels' host-side arithmetic, on the CPU.

- `gemm_tile_plan` (kernels/fused_pack_mmt4d.py), the block tile of the bf16
  GEMM kernel, over M in {1, 16, 63, 64, 65, 300, 512, 2048, 8192} and N1 in
  {1, 4, 16, 64}: the grid's tiles cover every output element exactly once,
  BN divides the 128-wide packed tile, and the grid fills one wave of the
  H100's 132 SMs wherever the smallest tile can.
- `gemm_block_loads`, where each block's TMA copies read, over K1 in {1, 16,
  64}: a block's K steps cover K once, and the weight box of each step holds
  exactly the block's rows of W = unpack(rhs4) at that step's columns.
- Flash prefill is dense decode over K/V as a cache of Sk slots: their plain
  versions agree on the causal shapes of test_torch_kernels.py's flash test
  (tolerance 1e-6: the two einsums order their sums differently).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import attn
from repro_torch.kernels import fused_pack_mmt4d as gemm
from repro_torch.kernels import ref

MS = [1, 16, 63, 64, 65, 300, 512, 2048, 8192]
N1S = [1, 4, 16, 64]
K1S = [1, 16, 64]


def _cover(extent: int, tile: int, blocks: int) -> np.ndarray:
    """How many of `blocks` consecutive tiles of `tile` cover each index of
    0 .. extent - 1 (blocks past the extent must not exist)."""
    count = np.zeros(blocks * tile, np.int64)
    for i in range(blocks):
        count[i * tile:(i + 1) * tile] += 1
    assert (blocks - 1) * tile < extent  # no block lies wholly past the edge
    return count[:extent]


@pytest.mark.parametrize("n1", N1S)
@pytest.mark.parametrize("m", MS)
def test_gemm_tile_plan_covers_the_output_once(m, n1):
    bm, bn = gemm.gemm_tile_plan(m, n1)
    assert (bm, bn) in gemm.GEMM_TILES and 128 % bn == 0
    gx, gy = gemm.gemm_grid(m, n1, bm, bn)
    # An element (r, c) lies in block (bx, by) iff r is in by's rows and c in
    # bx's columns: exactly once in both is exactly once in the grid.
    assert (_cover(m, bm, gy) == 1).all()
    assert gx * bn == n1 * 128 and (_cover(n1 * 128, bn, gx) == 1).all()
    most = gemm.gemm_grid(m, n1, *gemm.GEMM_TILES[-1])
    if most[0] * most[1] >= gemm.GEMM_WAVE:
        assert gx * gy >= gemm.GEMM_WAVE
        bigger = [t for t in gemm.GEMM_TILES if t[0] * t[1] > bm * bn]
        for t in bigger:  # a larger tile would leave SMs idle
            tx, ty = gemm.gemm_grid(m, n1, *t)
            assert tx * ty < gemm.GEMM_WAVE
    else:
        assert (bm, bn) == gemm.GEMM_TILES[-1]


def test_gemm_tile_plan_at_the_serving_shapes():
    """Llama-3.2-1B's projections (N = 2048, 512, 8192) at a 4 x 512 batched
    prefill and a one-request 512-row prefill: no grid of 16-64 blocks."""
    assert gemm.gemm_tile_plan(2048, 64) == (128, 128)  # gate/up: 1024 blocks
    assert gemm.gemm_tile_plan(2048, 16) == (128, 128)  # q/o/down: 256
    for m, n1 in ((2048, 4), (512, 16), (512, 4)):  # k/v, and one request
        assert gemm.gemm_tile_plan(m, n1) == (64, 64)
    assert gemm.gemm_grid(2048, 4, 64, 64) == (8, 32)


@pytest.mark.parametrize("k1", K1S)
@pytest.mark.parametrize("n1", N1S)
def test_gemm_block_loads_walk_k_once(n1, k1):
    """Index arithmetic at every (N1, K1): the lhs boxes of a block step
    through K in 64-wide slabs, and the first and last rows of each weight
    box are rows n_base and n_base + BN - 1 of W at that slab's columns."""
    for bm, bn in gemm.GEMM_TILES:
        for bx in range(n1 * 128 // bn):
            n_base = bx * bn
            cols = []
            for step in range(2 * k1):
                (ac, ar), (bc, br) = gemm.gemm_block_loads(bx, 3, step, bm, bn, k1)
                assert ar == 3 * bm
                cols.append(ac)
                for i in (0, bn - 1):
                    r = br + i  # row of rhs4 viewed as (N1*K1*128, 128)
                    nt, kt, n0 = r // (k1 * 128), (r // 128) % k1, r % 128
                    assert nt * 128 + n0 == n_base + i
                    assert kt * 128 + bc == ac
            assert cols == list(range(0, k1 * 128, gemm.GEMM_K_STEP))


def test_gemm_block_loads_read_the_blocks_weight():
    """Content: assembling each block's weight boxes from rhs4 (viewed as
    the kernel's TMA map sees it) gives W's rows of the block, and the
    products of its lhs and weight boxes give its tile of the plain output."""
    rng = np.random.RandomState(0)
    n1, k1, m = 2, 3, 70
    rhs4 = torch.from_numpy(rng.randn(n1, k1, 128, 128).astype(np.float32)) * (k1 * 128)**-0.5
    lhs = torch.from_numpy(rng.randn(m, k1 * 128).astype(np.float32))
    w = ref.unpack(rhs4, (n1 * 128, k1 * 128))
    view = rhs4.reshape(n1 * k1 * 128, 128)
    lhs_pad = torch.cat([lhs, torch.zeros(128, k1 * 128)])  # TMA zero-fills rows past M
    want = gemm.fused_pack_mmt4d_plain(lhs, rhs4)
    for bm, bn in gemm.GEMM_TILES:
        gx, gy = gemm.gemm_grid(m, n1, bm, bn)
        for bx in range(gx):
            for by in range(gy):
                acc = torch.zeros(bm, bn, dtype=torch.float64)
                for step in range(2 * k1):
                    (ac, ar), (bc, br) = gemm.gemm_block_loads(bx, by, step, bm, bn, k1)
                    a = lhs_pad[ar:ar + bm, ac:ac + 64]
                    b = view[br:br + bn, bc:bc + 64]
                    assert torch.equal(b, w[bx * bn:(bx + 1) * bn, ac:ac + 64])
                    acc += a.double() @ b.double().t()
                rows = min(bm, m - by * bm)
                torch.testing.assert_close(
                    acc[:rows].float(), want[by * bm:by * bm + rows, bx * bn:(bx + 1) * bn],
                    rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,kv", [(4, 1), (4, 2)])
@pytest.mark.parametrize("sq,sk,q_offset", [(13, 13, 0), (7, 20, 13), (16, 16, 0)])
def test_flash_prefill_plain_equals_dense_decode_plain(h, kv, sq, sk, q_offset):
    """What the card's shared body relies on: causal prefill at q_offset is
    decode over the K/V as a dense cache of Sk slots at pos = q_offset."""
    rng = np.random.RandomState(sq + sk + h * kv)
    b, d = 2, 16
    q = torch.from_numpy(rng.randn(b, sq, h, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, sk, kv, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, sk, kv, d).astype(np.float32))
    flash = attn.flash_prefill_attention_plain(q, k, v, q_offset=q_offset)
    dense = attn.dense_decode_attention_plain(q, k, v, q_offset)
    torch.testing.assert_close(flash, dense, rtol=1e-6, atol=1e-6)
