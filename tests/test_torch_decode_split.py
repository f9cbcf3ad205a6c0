"""The decode kernels' key split (kernels/attn.py: decode_split_plan and
decode_split_range, the arithmetic csrc/decode_attn.cuh runs), on the CPU.

Llama-3.2-1B's heads (KV = 8, G = 4) at B in {1, 4, 16}, windows L in
{1, 5, 16, 256} and key counts of 1 to 8192, for the paged kernel (its
bound: the table's NB*bs keys, bs = 16) and the dense kernel (S_c keys):

- the plan is a function of the key bound alone, so a dense cache as wide
  as the paged table (S_c = NB*bs, the identity-table pair) gets the paged
  kernel's plan;
- the splits' ranges start 64-aligned, and every key 0 .. t_end of a row
  falls in exactly one of them, for rows ending anywhere up to the bound;
- a split is empty only past a row's last key, after every busy split,
  and never at the bound itself;
- the grid reaches 264 blocks (two per SM of the H100) wherever one split
  per 64 keys gets there, with fewer than twice the splits it needs, and
  holds one split per 64 keys otherwise.
"""

import pytest

from repro_torch.kernels import attn

KVH, G, BS = 8, 4, 16
KT = attn.DECODE_KEY_TILE
TARGET = attn.DECODE_TARGET_BLOCKS


def _ranges(splits, kps, n_live):
    return [attn.decode_split_range(s, splits, kps, n_live) for s in range(splits)]


def _check_cover(splits, kps, n_live):
    rs = _ranges(splits, kps, n_live)
    assert all(lo % KT == 0 and lo <= hi for lo, hi in rs)
    assert [t for lo, hi in rs for t in range(lo, hi)] == list(range(n_live))
    busy = [lo < hi for lo, hi in rs]
    assert busy[0] and busy == sorted(busy, reverse=True)
    return rs


@pytest.mark.parametrize("kind", ["paged", "dense"])
@pytest.mark.parametrize("live", [1, 15, 16, 17, 900, 1024, 8192])
@pytest.mark.parametrize("L", [1, 5, 16, 256])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_split_plan_covers_every_key_once(b, L, live, kind):
    bound = -(-live // BS) * BS if kind == "paged" else live
    splits, kps = attn.decode_split_plan(b, KVH, L, G, bound)
    assert splits >= 1 and kps >= KT and kps % KT == 0
    chunks = -(-bound // KT)
    blocks = b * KVH * -(-(L * G) // attn.DECODE_TILE_ROWS)
    need = -(-TARGET // blocks)
    if chunks >= need:
        assert need <= splits < 2 * need
    else:
        assert (splits, kps) == (chunks, KT)
    assert all(lo < hi for lo, hi in _ranges(splits, kps, bound))
    for n_live in {1, 2, 63, 64, 65, live, bound // 2 + 1, bound - 1, bound}:
        if 1 <= n_live <= bound:
            _check_cover(splits, kps, n_live)


@pytest.mark.parametrize("n_live", [1, 63, 64, 65, 256, 900, 1024])
def test_split_range_edges(n_live):
    """Key counts at and around one 64-key tile and whole numbers of
    splits (256 = 4 x 64, 1024 = 16 x 64), under the L = 1, B = 4 plan of a
    1024-key bound: the ranges tile 0 .. n_live, none longer than the
    plan's range."""
    splits, kps = attn.decode_split_plan(4, KVH, 1, G, 1024)
    rs = _check_cover(splits, kps, n_live)
    assert all(hi - lo <= kps for lo, hi in rs)
    assert sum(lo < hi for lo, hi in rs) == min(splits, -(-n_live // KT))


def test_serving_shapes_fill_the_card():
    """The phase-2 shapes: L = 1 at B = 4 (32 blocks without a split) gets
    >= 264 blocks over a 1024-key bound; L = 256 (16 tiles, 512 blocks)
    runs unsplit."""
    splits, kps = attn.decode_split_plan(4, KVH, 1, G, 1024)
    assert 4 * KVH * splits >= TARGET and splits * kps >= 1024
    assert attn.decode_split_plan(4, KVH, 256, G, 1216)[0] == 1


@pytest.mark.parametrize("b,sq,sk", [(4, 512, 512), (4, 256, 512), (16, 512, 512),
                                     (1, 100, 356), (1, 7, 100)])
def test_split_plan_at_the_prefill_shapes(b, sq, sk):
    """Flash prefill runs the decode body with L = Sq over Sk keys: the
    batched prefills of the serving runs (4 x 512, a 4 x 256 suffix at
    q_offset 256, 16 x 512) fill the card unsplit; one short request's
    prefill (or suffix) splits its keys until the grid reaches 264 blocks."""
    splits, kps = attn.decode_split_plan(b, KVH, sq, G, sk)
    blocks = b * KVH * -(-(sq * G) // attn.DECODE_TILE_ROWS)
    if blocks >= TARGET:
        assert splits == 1 and kps >= sk
    else:
        assert splits > 1 and (blocks * splits >= TARGET or splits == -(-sk // KT))
    for q_offset in (0, sk - sq):
        if q_offset >= 0:
            _check_cover(splits, kps, min(sk, q_offset + sq))


@pytest.mark.parametrize("first", [0, 64, 128, 320])
@pytest.mark.parametrize("n_live", [1, 65, 200, 384, 700])
def test_split_range_covers_a_band_once(first, n_live):
    """A prefill band's tile starts its splits at the band's 64-aligned
    first key: the ranges cover first .. n_live - 1 exactly once (nothing
    when the band lies past the live keys)."""
    splits, kps = attn.decode_split_plan(1, KVH, 7, G, 1024)
    rs = [attn.decode_split_range(s, splits, kps, n_live, first) for s in range(splits)]
    assert all(lo >= first and (lo - first) % KT == 0 and lo <= hi for lo, hi in rs)
    assert [t for lo, hi in rs for t in range(lo, hi)] == list(range(first, n_live))


@pytest.mark.parametrize("kind,b,L,live", [
    ("ring decode", 4, 1, 2048), ("ring decode", 1, 1, 2048), ("grouped decode", 4, 1, 2048),
    ("prefill", 1, 2560, 2560), ("prefill", 1, 500, 500), ("prefill", 1, 37, 137),
])
def test_plan_at_head_dim_256(kind, b, L, live):
    """RecurrentGemma's local attention (D = 256, 16 query heads on one kv
    head, G = 16, a 2048-slot ring): the split plan covers every key of
    every row once, and each launch's shared memory (Geo in
    csrc/decode_attn.cuh, mirrored by attn.decode_smem_bytes) stays within
    the H100's 227 KB a block, bf16 double-buffered and f32 single-buffered
    on the CUDA cores (which take D = 256: csrc/decode_attn.cuh,
    launch_path)."""
    kvh, g, d = 1, 16, 256
    splits, kps = attn.decode_split_plan(b, kvh, L, g, live)
    tiles = -(-(L * g) // attn.DECODE_TILE_ROWS)
    assert splits == 1 or b * kvh * tiles * splits >= TARGET or splits == -(-live // KT)
    for last in {0, 1, live // 3, live - 1}:
        _check_cover(splits, kps, last + 1)
    qt = min(attn.DECODE_TILE_ROWS, L * g)
    for itemsize, nbuf in ((2, 2), (4, 1)):
        smem, got_nbuf = attn.decode_smem_bytes(itemsize, d, qt, tc=False)
        assert smem <= attn.SMEM_MAX and got_nbuf == nbuf
    # Every head dim below keeps two buffers on either path.
    for dd in attn.HEAD_DIMS:
        for tc, kv in ((True, "bf16"), (False, "bf16"), (True, "kv8"), (False, "kv4")):
            assert attn.decode_smem_bytes(2, dd, qt, tc=tc, kv_quant=kv)[1] == 2
