"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is False.  This file imports torch and repro_torch only (no JAX), so it runs
on a machine with the GPU:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the GEMV and GEMM accumulate f32 products of the same inputs in
both versions (1e-4); attention outputs are rounded to the input dtype, so
bf16 allows about one bf16 ulp (2e-2).  The int8 (w8a8) kernels sum integers
exactly and apply the same f32 epilogue: equal bit for bit.  The int4 (w4a8)
kernels sum exact terms in float64, as their plain versions do, and round
once: the GEMV and the GEMM equal bit for bit under every plan, as the
sums stay exact while a row's group scales span less than 2**21.  The
paged and dense decode kernels on kv8/kv4 caches dequantize exactly, so
they keep the attention tolerances; through an identity page table the two
kernels agree bit for bit, and flash prefill (the same body over K/V as a
dense cache) agrees with dense decode at pos = q_offset bit for bit.  The
bf16 prefill GEMM sums each output in a fixed order: a repeat call gives
the same bits.  So do the packed GEMM and GEMV, whose skinny body merges
its K splits in split order, and the packed GEMM on its wide body runs the
prefill GEMM's pipeline: unpack(mmt4d(pack(x))) equals fused_pack_mmt4d(x)
bit for bit where the two plans pick one tile.  The bf16 decode GEMV runs
the skinny body on plain rows: 1e-4, and a repeat call the same bits.  The
int8 GEMM on either body sums integers exactly: equal to its plain version
bit for bit.  The pack and unpack kernels copy bytes: equal
bit for bit.  The packed GEMMs' plain-row entries equal their packed routes
(pack, the packed entry, unpack) bit for bit under every plan, in every
format.  batch_mmt4d sums the same exact products in another order
(rtol 1e-5, atol 1e-4), at any tile shape (64 x 64 outputs, K0 = 13).  The sampler's integer bits, and so its uniforms,
are the same on the card and the CPU."""

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as cfg_registry
from repro_torch.core import encoding
from repro_torch.core import packed as packed_lib
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import attn
from repro_torch.kernels import batch_mmt4d
from repro_torch.kernels import fused_gemv
from repro_torch.kernels import fused_pack_mmt4d
from repro_torch.kernels import mmt4d
from repro_torch.kernels import mmt4d_gemv
from repro_torch.kernels import mmt4d_q4
from repro_torch.kernels import mmt4d_q8
from repro_torch.kernels import pack
from repro_torch.models import transformer as T
from repro_torch.serving import engine as engine_lib
from repro_torch.serving import sampling
from repro_torch.serving.config import EngineConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, exact_sum: bool):
    if dtype == torch.float32 or exact_sum:
        return dict(rtol=1e-4, atol=1e-4)
    return dict(rtol=2e-2, atol=2e-2)


def _rand(dev, dtype, *shape, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 5, 8])
def test_fused_gemv_kernel(dev, dtype, m):
    rhs4 = _rand(dev, dtype, 4, 3, 128, 128, scale=384**-0.5)
    lhs = _rand(dev, dtype, m, 384, seed=m)
    before = fused_gemv.fused_gemv.launches
    got = fused_gemv.fused_gemv(lhs, rhs4)
    assert fused_gemv.fused_gemv.launches == before + 1
    torch.testing.assert_close(got, fused_gemv.fused_gemv_plain(lhs, rhs4), **_tol(dtype, True))


def _counters_zero() -> bool:
    """The skinny body's arrival counters are back at 0 after a launch."""
    torch.cuda.synchronize()
    return all(int(cnt.abs().sum()) == 0 for _, cnt in mmt4d._scratch.values())


@pytest.mark.parametrize("n1,k1", [(4, 16), (16, 64), (1, 3)])
@pytest.mark.parametrize("m", list(range(1, 9)))
def test_fused_gemv_bf16_skinny_splits(dev, m, n1, k1):
    """bf16 fused_gemv on the skinny body with plain rows: M = 1..8 at the
    plan's K split (9, 9 and 3 here), one launch a call, repeat calls equal
    bit for bit, counters reset by each launch."""
    splits = mmt4d.mmt4d_plan(1, m, n1, k1)[2]
    assert splits > 1
    k = k1 * 128
    rhs4 = _rand(dev, torch.bfloat16, n1, k1, 128, 128, scale=k**-0.5, seed=n1 + k1)
    lhs = _rand(dev, torch.bfloat16, m, k, seed=m + k1)
    before = fused_gemv.fused_gemv.launches
    got = fused_gemv.fused_gemv(lhs, rhs4)
    assert fused_gemv.fused_gemv.launches == before + 1
    torch.testing.assert_close(got, fused_gemv.fused_gemv_plain(lhs, rhs4),
                               **_tol(torch.bfloat16, True))
    assert _counters_zero()
    assert torch.equal(fused_gemv.fused_gemv(lhs, rhs4), got)
    assert fused_gemv.fused_gemv.launches == before + 2 and _counters_zero()


def test_fused_gemv_takes_an_unaligned_view(dev):
    """A row view that starts off a 16-byte boundary (a TMA base must not)
    goes through build.aligned."""
    rhs4 = _rand(dev, torch.bfloat16, 4, 16, 128, 128, scale=2048**-0.5)
    buf = _rand(dev, torch.bfloat16, 4 * 2048 + 1, seed=3)
    lhs = buf[1:].view(4, 2048)
    assert lhs.data_ptr() % 16 != 0
    torch.testing.assert_close(fused_gemv.fused_gemv(lhs, rhs4),
                               fused_gemv.fused_gemv_plain(lhs, rhs4), **_tol(torch.bfloat16, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 16, 37, 63, 64, 65, 129, 300, 2065])
def test_fused_pack_mmt4d_kernel(dev, dtype, m):
    """Ragged M: rows past M are zero-filled by the copies (bf16: TMA) and
    never stored, at, below and past the 64- and 128-row tiles."""
    rhs4 = _rand(dev, dtype, 4, 3, 128, 128, scale=384**-0.5)
    lhs = _rand(dev, dtype, m, 384, seed=m)
    before = fused_pack_mmt4d.fused_pack_mmt4d.launches
    got = fused_pack_mmt4d.fused_pack_mmt4d(lhs, rhs4)
    assert fused_pack_mmt4d.fused_pack_mmt4d.launches == before + 1
    torch.testing.assert_close(got, fused_pack_mmt4d.fused_pack_mmt4d_plain(lhs, rhs4),
                               **_tol(dtype, True))


# (N1, K1, M) and the bf16 tile the plan gives them: every tile the plan can
# pick, at N1 in {1, 4, 64} and K1 in {1, 64}.
_GEMM_TILE_CASES = [
    (64, 1, 300, (128, 128)), (64, 64, 300, (128, 128)), (4, 1, 4200, (128, 128)),
    (64, 1, 200, (128, 64)), (64, 64, 200, (128, 64)), (4, 64, 2065, (128, 64)),
    (1, 1, 8321, (128, 64)),
    (64, 1, 65, (64, 64)), (64, 64, 65, (64, 64)), (4, 1, 2048, (64, 64)),
    (1, 64, 129, (64, 64)), (1, 1, 1, (64, 64)),
]


@pytest.mark.parametrize("n1,k1,m,tile", _GEMM_TILE_CASES)
def test_fused_pack_mmt4d_every_tile(dev, n1, k1, m, tile):
    assert fused_pack_mmt4d.gemm_tile_plan(m, n1) == tile
    k = k1 * 128
    rhs4 = _rand(dev, torch.bfloat16, n1, k1, 128, 128, scale=k**-0.5, seed=n1 + k1)
    lhs = _rand(dev, torch.bfloat16, m, k, seed=m)
    got = fused_pack_mmt4d.fused_pack_mmt4d(lhs, rhs4)
    torch.testing.assert_close(got, fused_pack_mmt4d.fused_pack_mmt4d_plain(lhs, rhs4),
                               **_tol(torch.bfloat16, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_pack_mmt4d_repeats_bit_for_bit(dev, dtype):
    """Each block sums all of K itself in a fixed order: no split, no
    atomics, so a second call gives the same bits."""
    rhs4 = _rand(dev, dtype, 16, 16, 128, 128, scale=2048**-0.5)
    lhs = _rand(dev, dtype, 777, 2048, seed=7)
    got = fused_pack_mmt4d.fused_pack_mmt4d(lhs, rhs4)
    for _ in range(2):
        assert torch.equal(fused_pack_mmt4d.fused_pack_mmt4d(lhs, rhs4), got)


# (M1, M0) of the packed GEMM's row cases: one row block of 1-8 rows; 16,
# 20 and 24 (both pack as 3 blocks), 64 and 65 rows at M0 = 8 (skinny up
# to 64, wide past it); an M0 of 5 (skinny only); 256 and 1040 rows (mixed
# windows); one, two and three prefill slabs of M0 = 128.
_PACKED_ROWS = ([(1, m0) for m0 in range(1, 9)] + [(2, 8), (3, 8), (8, 8), (9, 8), (2, 5)]
                + [(32, 8), (130, 8), (1, 128), (2, 128), (3, 128)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n1", [1, 4, 16])
@pytest.mark.parametrize("k1", [3, 16, 64])
@pytest.mark.parametrize("m1,m0", _PACKED_ROWS)
def test_mmt4d_kernel(dev, dtype, k1, n1, m1, m0):
    """Packed GEMM at decode row blocks, mixed windows and prefill slabs;
    K1 = 16 and 64, so the skinny body really splits K (up to one split a
    K tile) and the wide body walks long K; one launch a call; a repeat call
    gives the same bits (splits merged in split order, no atomics on data)."""
    k = k1 * 128
    lhs4 = _rand(dev, dtype, m1, k1, m0, 128, seed=m1 * m0 + k1)
    rhs4 = _rand(dev, dtype, n1, k1, 128, 128, scale=k**-0.5, seed=n1 + k1)
    before = mmt4d.mmt4d.launches
    got = mmt4d.mmt4d(lhs4, rhs4)
    assert mmt4d.mmt4d.launches == before + 1
    torch.testing.assert_close(got, mmt4d.mmt4d_plain(lhs4, rhs4), **_tol(dtype, True))
    assert torch.equal(mmt4d.mmt4d(lhs4, rhs4), got)
    assert mmt4d.mmt4d.launches == before + 2


@pytest.mark.parametrize("m1,m0", [(20, 5), (30, 7), (11, 6), (25, 3), (9, 7)])
def test_mmt4d_skinny_row_groups(dev, m1, m0):
    """An M0 the wide body's box cannot land (3, 5, 6, 7) stays on the
    skinny body past 64 rows, which then runs groups of G = 64 // M0 row
    blocks along the grid's third axis."""
    assert mmt4d.mmt4d_plan(m1, m0, 4, 16)[0] == "skinny"
    lhs4 = _rand(dev, torch.bfloat16, m1, 16, m0, 128, seed=m1 * m0)
    rhs4 = _rand(dev, torch.bfloat16, 4, 16, 128, 128, scale=2048**-0.5, seed=3)
    got = mmt4d.mmt4d(lhs4, rhs4)
    torch.testing.assert_close(got, mmt4d.mmt4d_plain(lhs4, rhs4), **_tol(torch.bfloat16, True))


@pytest.mark.parametrize("m1", [8, 16, 32])
@pytest.mark.parametrize("splits", [1, 3, 16])
def test_mmt4d_either_body(dev, m1, splits):
    """64, 128 and 256 rows at M0 = 8 under both bodies (the crossover
    bench_packed measures): forced skinny plans at 1, 3 and 16 splits and
    the wide plan agree with the plain version and, both summing exact bf16
    products in f32, with each other to the same tolerance."""
    lhs4 = _rand(dev, torch.bfloat16, m1, 16, 8, 128, seed=m1)
    rhs4 = _rand(dev, torch.bfloat16, 16, 16, 128, 128, scale=2048**-0.5, seed=5)
    want = mmt4d.mmt4d_plain(lhs4, rhs4)
    skinny = mmt4d.mmt4d(lhs4, rhs4, plan=("skinny", mmt4d.SKINNY_BN, splits))
    wide = mmt4d.mmt4d(lhs4, rhs4, plan=("wide",) + fused_pack_mmt4d.gemm_tile_plan(m1 * 8, 16))
    torch.testing.assert_close(skinny, want, **_tol(torch.bfloat16, True))
    torch.testing.assert_close(wide, want, **_tol(torch.bfloat16, True))
    torch.testing.assert_close(skinny, wide, **_tol(torch.bfloat16, True))


@pytest.mark.parametrize("m,m0,n1,k1", [
    (2048, 128, 64, 16), (2048, 128, 4, 16), (512, 128, 16, 16), (2048, 128, 16, 64),
    (256, 8, 64, 16), (1040, 8, 16, 16), (600, 8, 16, 3), (1000, 8, 64, 2)])
def test_packed_wide_equals_prefill_gemm(dev, m, m0, n1, k1):
    """unpack(mmt4d(pack(x))) == fused_pack_mmt4d(x) bit for bit wherever
    the two plans pick the same tile: one pipeline, one order of sums."""
    k = k1 * 128
    x = _rand(dev, torch.bfloat16, m, k, seed=m)
    rhs4 = _rand(dev, torch.bfloat16, n1, k1, 128, 128, scale=k**-0.5, seed=n1)
    lhs4 = pack.pack(x, (m0, 128))
    plan = mmt4d.mmt4d_plan(lhs4.shape[0], m0, n1, k1)
    assert plan[0] == "wide"
    assert plan[1:] == fused_pack_mmt4d.gemm_tile_plan(m, n1)
    got = pack.unpack(mmt4d.mmt4d(lhs4, rhs4), (m, n1 * 128))
    assert torch.equal(got, fused_pack_mmt4d.fused_pack_mmt4d(x, rhs4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n1", [1, 4, 16])
@pytest.mark.parametrize("k1", [3, 16, 64])
@pytest.mark.parametrize("m0", list(range(1, 9)))
def test_mmt4d_gemv_kernel(dev, dtype, k1, n1, m0):
    """The packed GEMV (bf16: the skinny body at M1 = 1), K1 = 16 and 64
    splitting K: one launch a call, repeat calls equal bit for bit."""
    k = k1 * 128
    lhs4 = _rand(dev, dtype, 1, k1, m0, 128, seed=m0 + k1)
    rhs4 = _rand(dev, dtype, n1, k1, 128, 128, scale=k**-0.5, seed=n1 + k1)
    before = mmt4d_gemv.mmt4d_gemv.launches
    got = mmt4d_gemv.mmt4d_gemv(lhs4, rhs4)
    assert mmt4d_gemv.mmt4d_gemv.launches == before + 1
    torch.testing.assert_close(got, mmt4d_gemv.mmt4d_gemv_plain(lhs4, rhs4),
                               **_tol(dtype, True))
    assert torch.equal(mmt4d_gemv.mmt4d_gemv(lhs4, rhs4), got)
    assert mmt4d_gemv.mmt4d_gemv.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,q_offset", [
    (40, 40, 0), (40, 72, 32), (7, 100, 93),
    (1, 1, 0), (7, 7, 0), (63, 63, 0), (64, 64, 0), (65, 65, 0), (512, 512, 0),
    (40, 100, 20),  # keys past the last query's position: never attended
    (40, 50, 30),   # q_offset + Sq > Sk: the last rows attend every key
])
def test_flash_prefill_kernel(dev, dtype, sq, sk, q_offset):
    """Sq at and around the 16-position query tiles of G = 4 and a full
    serving prefill; Sk past the diagonal and Sk short of it."""
    q = _rand(dev, dtype, 2, sq, 8, 64, seed=1)
    k = _rand(dev, dtype, 2, sk, 2, 64, seed=2)
    v = _rand(dev, dtype, 2, sk, 2, 64, seed=3)
    got = attn.flash_prefill_attention(q, k, v, q_offset=q_offset)
    want = attn.flash_prefill_attention_plain(q, k, v, q_offset=q_offset)
    torch.testing.assert_close(got, want, **_tol(dtype, False))


def _prefill_qkv(dev, dtype, b, sq, sk, h, kvh, d, seed=40):
    return (_rand(dev, dtype, b, sq, h, d, seed=seed), _rand(dev, dtype, b, sk, kvh, d, seed=seed + 1),
            _rand(dev, dtype, b, sk, kvh, d, seed=seed + 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 50), (False, 0), (False, 50)])
def test_flash_prefill_masks(dev, dtype, d, g, causal, window):
    """The sliding band at L > 1 (keys > qpos - window; tiles below every
    row's band skipped), non-causal attention to every key, at each head
    width and group size, with a q_offset that puts keys on both sides."""
    q, k, v = _prefill_qkv(dev, dtype, 2, 150, 230, 2 * g, 2, d)
    kw = dict(causal=causal, window=window, q_offset=60)
    got = attn.flash_prefill_attention(q, k, v, **kw)
    want = attn.flash_prefill_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got, want, **_tol(dtype, False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_rows_without_keys_are_zero_on_card(dev, dtype):
    """A band that lies past every key (window 1, q_offset 10, Sk 4): every
    row writes 0, not NaN, at 16 rows (tensor cores in bf16) and 3."""
    for sq, h in ((4, 4), (3, 1)):
        q, k, v = _prefill_qkv(dev, dtype, 1, sq, 4, h, 1, 16)
        out = attn.flash_prefill_attention(q, k, v, causal=True, window=1, q_offset=10)
        assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,q_offset", [(4, 512, 512, 0), (4, 256, 512, 256),
                                              (1, 7, 100, 93), (2, 40, 72, 32)])
def test_flash_prefill_equals_dense_decode_bit_for_bit(dev, dtype, b, sq, sk, q_offset):
    """Flash prefill is the dense decode body over K/V as a cache of Sk
    slots: with pos = q_offset the two give the same bits (one unsplit and
    one split plan among the shapes), and a repeat call too."""
    q, k, v = _prefill_qkv(dev, dtype, b, sq, sk, 32, 8, 64)
    got = attn.flash_prefill_attention(q, k, v, q_offset=q_offset)
    assert torch.equal(got, attn.dense_decode_attention(q, k, v, q_offset))
    assert torch.equal(attn.flash_prefill_attention(q, k, v, q_offset=q_offset), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk", [(4, 1500, 1500), (4, 64, 1500), (2, 448, 1500),
                                     (1, 70, 130)])
def test_flash_prefill_non_causal_encoder_and_cross(dev, dtype, b, sq, sk):
    """causal=False as the enc-dec family runs it, at G = 1, D = 64:
    Whisper's encoder (Sq = Sk = 1500, whose last 64-key tile holds 28
    keys) and cross attention (Sq != Sk, the key range split across blocks
    by the plan); every query attends every key.  The launch counts once,
    and once as non-causal."""
    q, k, v = _prefill_qkv(dev, dtype, b, sq, sk, 6, 6, 64)
    fn = attn.flash_prefill_attention
    before = (fn.launches, fn.launches_noncausal)
    got = fn(q, k, v, causal=False)
    assert (fn.launches, fn.launches_noncausal) == (before[0] + 1, before[1] + 1)
    want = attn.flash_prefill_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got, want, **_tol(dtype, False))
    v2 = v.clone()
    v2[:, -1] += 4.0  # the partial tile's last key moves every row
    moved = (fn(q, k, v2, causal=False).float() - got.float()).abs().amax(dim=(2, 3))
    assert bool((moved > 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 5])
def test_dense_decode_over_a_cross_cache(dev, dtype, L):
    """Cross attention at decode: a 1500-row cache (not a multiple of the
    64-key tile), G = 1, D = 64, every row at pos = 1499, which attends all
    1500 keys: the plain version's output, and flash prefill's with
    causal=False on the same K/V."""
    q, k, v = _prefill_qkv(dev, dtype, 4, L, 1500, 6, 6, 64, seed=50)
    got = attn.dense_decode_attention(q, k, v, 1499)
    torch.testing.assert_close(got, attn.dense_decode_attention_plain(q, k, v, 1499),
                               **_tol(dtype, False))
    torch.testing.assert_close(got, attn.flash_prefill_attention(q, k, v, causal=False),
                               **_tol(dtype, False))


def _kv_pages(dev, kv, dtype, *shape, seed):
    """K or V rows of `shape` (.., KV, D) in the layout `kv`: (data, scales)."""
    x = _rand(dev, torch.float32, *shape, seed=seed)
    if kv == "bf16":
        return x.to(dtype), None
    return encoding.kv_layout(kv).quantize(x)


@pytest.mark.parametrize("kv", ["bf16", "kv8", "kv4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 3, 16, 256])
def test_paged_decode_kernel(dev, dtype, L, kv):
    """G = 4: L = 16 and 256 are 64 and 1024 query rows per (row, kv head),
    several 32-row tiles of the kernel.  kv8/kv4 pools with their scale
    pages (the dequantized operands are exact; only the order of the sums
    differs)."""
    rng = np.random.RandomState(L)
    b, h, kvh, d, bs, pages = 3, 8, 2, 64, 16, 30
    nb = 8 + L // bs
    q = _rand(dev, dtype, b, L, h, d, seed=4)
    k_pool, k_scale = _kv_pages(dev, kv, dtype, pages, bs, kvh, d, seed=5)
    v_pool, v_scale = _kv_pages(dev, kv, dtype, pages, bs, kvh, d, seed=6)
    table = torch.from_numpy(rng.randint(1, pages, (b, nb)).astype(np.int32)).to(dev)
    table[1, :2] = table[0, :2]  # shared leading pages
    pos = torch.tensor([0, 37, nb * bs - L], dtype=torch.int32, device=dev)
    kw = dict(k_scale=k_scale, v_scale=v_scale, kv_quant=kv)
    before = attn.paged_decode_attention.launches_by_kv[kv]
    got = attn.paged_decode_attention(q, k_pool, v_pool, table, pos, **kw)
    assert attn.paged_decode_attention.launches_by_kv[kv] == before + 1
    want = attn.paged_decode_attention_plain(q, k_pool, v_pool, table, pos, **kw)
    torch.testing.assert_close(got, want, **_tol(dtype, False))


@pytest.mark.parametrize("kv", ["bf16", "kv8", "kv4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,window,pos", [(1, 0, [0, 37, 1023]), (16, 0, [5, 300, 1008]),
                                          (1, 0, 511), (1, 256, [37, 300, 900]),
                                          (1, 1024, [37, 1500, 3000])])
def test_dense_decode_kernel(dev, dtype, L, window, pos, kv):
    """Full attention at ragged and scalar positions and L = 16 windows, and
    ring caches (bf16/f32 only) at positions past the window: S_c = 1024
    with a 256-slot window, and S_c = window = 1024 wrapped twice."""
    if window and kv != "bf16":
        pytest.skip("ring windows take unquantized caches only (as in the JAX kernel)")
    b, h, kvh, d, s_c = 3, 8, 2, 64, 1024
    q = _rand(dev, dtype, b, L, h, d, seed=7)
    k, k_scale = _kv_pages(dev, kv, dtype, b, s_c, kvh, d, seed=8)
    v, v_scale = _kv_pages(dev, kv, dtype, b, s_c, kvh, d, seed=9)
    posv = (torch.tensor(pos, dtype=torch.int32, device=dev) if isinstance(pos, list)
            else pos)
    kw = dict(window=window, k_scale=k_scale, v_scale=v_scale, kv_quant=kv)
    before = attn.dense_decode_attention.launches_by_kv[kv]
    got = attn.dense_decode_attention(q, k, v, posv, **kw)
    assert attn.dense_decode_attention.launches_by_kv[kv] == before + 1
    want = attn.dense_decode_attention_plain(q, k, v, posv, **kw)
    torch.testing.assert_close(got, want, **_tol(dtype, False))


@pytest.mark.parametrize("kv,dtype", [("bf16", torch.bfloat16), ("bf16", torch.float32),
                                      ("kv8", torch.bfloat16), ("kv4", torch.float32)])
@pytest.mark.parametrize("L", [1, 16])
def test_identity_table_paged_kernel_equals_dense_kernel(dev, kv, dtype, L):
    """The two kernels share one body and split keys across warps the same
    way: a pool whose pages are the dense cache's blocks, read through the
    identity table, gives the dense kernel's output bit for bit."""
    b, h, kvh, d, bs, nb = 4, 32, 8, 64, 16, 64
    s_c = nb * bs
    q = _rand(dev, dtype, b, L, h, d, seed=10)
    k, k_scale = _kv_pages(dev, kv, dtype, b, s_c, kvh, d, seed=11)
    v, v_scale = _kv_pages(dev, kv, dtype, b, s_c, kvh, d, seed=12)
    pos = torch.tensor([37, 300, 511, s_c - L], dtype=torch.int32, device=dev)
    table = torch.arange(b * nb, dtype=torch.int32, device=dev).reshape(b, nb)

    def pages(a):
        return None if a is None else a.reshape(b * nb, bs, *a.shape[2:])

    dense = attn.dense_decode_attention(q, k, v, pos, k_scale=k_scale, v_scale=v_scale,
                                        kv_quant=kv)
    paged = attn.paged_decode_attention(q, pages(k), pages(v), table, pos,
                                        k_scale=pages(k_scale), v_scale=pages(v_scale),
                                        kv_quant=kv)
    assert torch.equal(paged, dense)


def _paged_case(dev, kv, dtype, b, L, pos, *, nb=64, h=32, kvh=8, seed=20):
    """Paged decode at Llama-3.2-1B's heads over a random table of nb pages
    of 16: (kernel output, plain output, inputs for a second call)."""
    rng = np.random.RandomState(seed)
    d, bs, pages = 64, 16, b * nb + 1
    q = _rand(dev, dtype, b, L, h, d, seed=seed)
    k_pool, k_scale = _kv_pages(dev, kv, dtype, pages, bs, kvh, d, seed=seed + 1)
    v_pool, v_scale = _kv_pages(dev, kv, dtype, pages, bs, kvh, d, seed=seed + 2)
    table = torch.from_numpy(
        np.stack([rng.permutation(pages - 1)[:nb] + 1 for _ in range(b)]).astype(np.int32)
    ).to(dev)
    posv = torch.tensor(pos, dtype=torch.int32, device=dev)
    args = (q, k_pool, v_pool, table, posv)
    kw = dict(k_scale=k_scale, v_scale=v_scale, kv_quant=kv)
    got = attn.paged_decode_attention(*args, **kw)
    return got, attn.paged_decode_attention_plain(*args, **kw), (args, kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [[0, 62, 63, 64], [1023, 0, 900, 255], [511, 767, 383, 127]])
def test_decode_split_edges(dev, dtype, pos):
    """L = 1 at B = 4 over a 1024-key table splits into 16 ranges of 64 keys:
    rows with 1, 63, 64 and 65 live keys (one split busy, or two), pos 0
    beside 900 and a full 1024 (every split busy), and rows ending on split
    boundaries."""
    got, want, _ = _paged_case(dev, "bf16", dtype, 4, 1, pos)
    assert attn.decode_split_plan(4, 8, 1, 4, 1024)[0] > 1
    torch.testing.assert_close(got, want, **_tol(dtype, False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 16])
def test_decode_wide_window_batch_edges(dev, dtype, b):
    """L = 256 (sixteen 64-row tiles, the tensor cores in bf16) at B = 1,
    which splits keys, and at B = 16, which does not."""
    pos = [0, 37, 300, 511, 700, 64, 1, 128, 600, 2, 65, 63, 450, 99, 200, 767][:b]
    got, want, _ = _paged_case(dev, "bf16", dtype, b, 256, pos)
    torch.testing.assert_close(got, want, **_tol(dtype, False))


@pytest.mark.parametrize("kv", ["kv8", "kv4"])
@pytest.mark.parametrize("L", [4, 5, 16])
def test_quantized_pools_on_tensor_cores(dev, kv, L):
    """bf16 queries on kv8/kv4 pools: L*G = 16, 20 and 64 rows take the
    tensor cores (tiles dequantized to bf16 in shared memory)."""
    got, want, _ = _paged_case(dev, kv, torch.bfloat16, 4, L, [37, 300, 511, 900])
    torch.testing.assert_close(got, want, **_tol(torch.bfloat16, False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_wrapping_at_a_split_boundary(dev, dtype):
    """A 256-slot ring (window 256) over four 64-key splits: rows whose
    newest slot is 63, 127 or 191 wrap exactly at a split boundary."""
    b, h, kvh, d, ring = 4, 32, 8, 64, 256
    q = _rand(dev, dtype, b, 1, h, d, seed=30)
    k = _rand(dev, dtype, b, ring, kvh, d, seed=31)
    v = _rand(dev, dtype, b, ring, kvh, d, seed=32)
    pos = torch.tensor([319, 383, 447 + 256, 63], dtype=torch.int32, device=dev)
    assert attn.decode_split_plan(b, kvh, 1, h // kvh, ring)[0] == 4
    got = attn.dense_decode_attention(q, k, v, pos, window=ring)
    want = attn.dense_decode_attention_plain(q, k, v, pos, window=ring)
    torch.testing.assert_close(got, want, **_tol(dtype, False))


@pytest.mark.parametrize("kv,dtype,L", [("bf16", torch.bfloat16, 1), ("bf16", torch.float32, 1),
                                        ("bf16", torch.bfloat16, 16), ("kv8", torch.bfloat16, 5),
                                        ("kv4", torch.float32, 1)])
def test_decode_repeats_bit_for_bit(dev, kv, dtype, L):
    """Two calls in a row give the same bits: the merge runs in split order
    and the last block leaves its counter at 0 for the next launch."""
    got, _, (args, kw) = _paged_case(dev, kv, dtype, 4, L, [37, 300, 511, 900])
    for _ in range(2):
        assert torch.equal(attn.paged_decode_attention(*args, **kw), got)


def _serve(params, cfg, enc, dev, prompts, max_new, **config):
    eng = engine_lib.Engine(params, cfg, enc, config=EngineConfig(**config), device=dev)
    for i, p in enumerate(prompts):
        eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=max_new))
    done = {r.uid: r.generated for r in eng.run()}
    assert eng.stats.get("pages_in_use", 0) == 0 and not eng.stats["degraded"]
    return done, eng


@pytest.mark.parametrize("backend,config", [
    ("auto", dict(spec_decode=True, draft_k=4)),
    ("pallas", dict(spec_decode=True, draft_k=4)),
    ("auto", dict(token_budget=16)),
    ("auto", dict(token_budget=16, spec_decode=True, draft_k=3)),
    ("auto", dict(slots=10)),
])
def test_engine_window_paths_match_plain_path(dev, backend, config):
    """Spec decode, the token budget and 10 slots, served through the
    kernels (the packed mmt4d GEMM for windows of more than 8 rows), emit
    the tokens of the plain phase-split engine on the card."""
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    params = T.model_init(cfg, EncodingConfig(), seed=0, device=dev)
    rng = np.random.RandomState(1)
    prompts = [np.tile(rng.randint(1, cfg.vocab_size, 4), n).astype(np.int32)
               for n in (3, 8, 5, 2, 6, 4)]
    config = dict(dict(slots=4, max_seq=96, block_size=8), **config)
    want, _ = _serve(params, cfg, EncodingConfig(backend="reference", attn_backend="xla"),
                     dev, prompts, 12, slots=config["slots"], max_seq=96, block_size=8)
    before = mmt4d.mmt4d.launches
    got, eng = _serve(params, cfg, EncodingConfig(backend=backend, attn_backend="auto"),
                      dev, prompts, 12, **config)
    assert got == want
    assert mmt4d.mmt4d.launches > before


def test_engine_kernels_match_plain_path(dev):
    """The reduced model served through the four kernels emits the tokens
    the plain backends emit on the card."""
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    params = T.model_init(cfg, EncodingConfig(), seed=0, device=dev)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in (5, 17, 30, 9)]
    outs = []
    for enc in (EncodingConfig(backend="fused", attn_backend="auto"),
                EncodingConfig(backend="reference", attn_backend="xla")):
        eng = engine_lib.Engine(params, cfg, enc, config=EngineConfig(slots=4, max_seq=64),
                                device=dev)
        for i, p in enumerate(prompts):
            eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=6))
        outs.append({r.uid: r.generated for r in eng.run()})
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# Quantized weights (w8a8, w4a8)


def _int8(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)


def _scales(dev, *shape, seed=0, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (0.5 + torch.rand(shape, generator=g, device=dev)).mul_(1e-2).to(dtype)


def _nibbles(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)


@pytest.mark.parametrize("m", [1, 5, 8])
@pytest.mark.parametrize("n1,k1", [(4, 3), (2, 64)])
def test_fused_gemv_q8_kernel(dev, m, n1, k1):
    """At the plan: k1 = 3 (fewer K tiles than warps) and 64 (K = 8192,
    16 warps a block)."""
    lhs, rhs4 = _int8(dev, m, k1 * 128, seed=m), _int8(dev, n1, k1, 128, 128, seed=1)
    s_a, s_w = _scales(dev, m, 1, seed=2), _scales(dev, n1, 128, seed=3)
    before = fused_gemv.fused_gemv_q8.launches
    got = fused_gemv.fused_gemv_q8(lhs, rhs4, s_a, s_w)
    assert fused_gemv.fused_gemv_q8.launches == before + 1
    assert torch.equal(got, fused_gemv.fused_gemv_q8_plain(lhs, rhs4, s_a, s_w))


@pytest.mark.parametrize("m1,m0", [(1, 8), (3, 8), (2, 5), (1, 128), (3, 128), (130, 8)])
def test_mmt4d_q8_kernel(dev, m1, m0):
    lhs4, rhs4 = _int8(dev, m1, 3, m0, 128, seed=m1 * m0), _int8(dev, 4, 3, 128, 128, seed=1)
    s_a, s_w = _scales(dev, m1, m0, seed=2), _scales(dev, 4, 128, seed=3)
    before = mmt4d_q8.mmt4d_q8.launches
    got = mmt4d_q8.mmt4d_q8(lhs4, rhs4, s_a, s_w)
    assert mmt4d_q8.mmt4d_q8.launches == before + 1
    assert torch.equal(got, mmt4d_q8.mmt4d_q8_plain(lhs4, rhs4, s_a, s_w))


@pytest.mark.parametrize("n1,k1", [(16, 16), (16, 64), (4, 16), (64, 16)])
@pytest.mark.parametrize("rows,m0", [(16, 8), (20, 8), (64, 8), (256, 8), (2048, 8), (2048, 128)])
def test_mmt4d_q8_either_body(dev, rows, m0, n1, k1):
    """The int8 GEMM with the plan forced: the skinny body at 1 and 3
    splits (M0 <= 64) and the wide body at the prefill GEMM's tile, each
    equal to the plain version bit for bit (exact integer sums, the same
    epilogue), a repeat call too, counters reset by each launch."""
    m1 = -(-rows // m0)
    lhs4, rhs4 = _int8(dev, m1, k1, m0, 128, seed=rows + k1), _int8(dev, n1, k1, 128, 128, seed=n1)
    s_a, s_w = _scales(dev, m1, m0, seed=2), _scales(dev, n1, 128, seed=3)
    want = mmt4d_q8.mmt4d_q8_plain(lhs4, rhs4, s_a, s_w)
    plans = [("wide",) + fused_pack_mmt4d.gemm_tile_plan(m1 * m0, n1)]
    if m0 <= 64:
        plans += [("skinny", mmt4d.SKINNY_BN, 1), ("skinny", mmt4d.SKINNY_BN, 3)]
    for plan in plans:
        before = mmt4d_q8.mmt4d_q8.launches
        got = mmt4d_q8.mmt4d_q8(lhs4, rhs4, s_a, s_w, plan=plan)
        assert mmt4d_q8.mmt4d_q8.launches == before + 1
        assert torch.equal(got, want), plan
        assert _counters_zero()
        assert torch.equal(mmt4d_q8.mmt4d_q8(lhs4, rhs4, s_a, s_w, plan=plan), got)


def test_mmt4d_q8_sums_past_f32(dev):
    """All operands 127 at K = 8192 (|sum| = 132128768 > 2^24) and operands
    from [100, 127] on the skinny body at its plan's split: int32 partials
    keep the sums exact, so the output equals the plain version bit for
    bit."""
    m1, k1, n1 = 3, 64, 4
    s_a, s_w = _scales(dev, m1, 8, seed=2), _scales(dev, n1, 128, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    cases = [(torch.full((m1, k1, 8, 128), 127, dtype=torch.int8, device=dev),
              torch.full((n1, k1, 128, 128), 127, dtype=torch.int8, device=dev)),
             tuple(torch.randint(100, 128, shape, generator=g, device=dev, dtype=torch.int8)
                   for shape in ((m1, k1, 8, 128), (n1, k1, 128, 128)))]
    assert mmt4d.mmt4d_plan(m1, 8, n1, k1)[:2] == ("skinny", mmt4d.SKINNY_BN)
    for lhs4, rhs4 in cases:
        got = mmt4d_q8.mmt4d_q8(lhs4, rhs4, s_a, s_w)
        assert torch.equal(got, mmt4d_q8.mmt4d_q8_plain(lhs4, rhs4, s_a, s_w))


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("m", [1, 5, 8])
@pytest.mark.parametrize("n1,k1", [(4, 3), (2, 64)])
def test_fused_gemv_q4_kernel(dev, m, group, n1, k1):
    lhs, rhs4 = _int8(dev, m, k1 * 128, seed=m), _nibbles(dev, n1, k1, 128, 64, seed=1)
    s_a = _scales(dev, m, 1, seed=2)
    s_w4 = _scales(dev, n1, k1, 128, 128 // group, seed=3, dtype=torch.bfloat16)
    before = mmt4d_q4.fused_gemv_q4.launches
    got = mmt4d_q4.fused_gemv_q4(lhs, rhs4, s_a, s_w4, group)
    assert mmt4d_q4.fused_gemv_q4.launches == before + 1
    assert torch.equal(got, mmt4d_q4.fused_gemv_q4_plain(lhs, rhs4, s_a, s_w4, group))


def _gemv_plans():
    """Every plan of the w8a8/w4a8 decode GEMVs: the decode-GEMV body at
    each warp count it is built for."""
    return [("warps", fused_gemv.GEMV_BN, w) for w in fused_gemv.GEMV_WARPS]


@pytest.mark.parametrize("n1,k1", [(4, 16), (1, 3), (2, 64)])
@pytest.mark.parametrize("m", list(range(1, 9)))
def test_fused_gemv_q8_every_plan(dev, m, n1, k1):
    """The w8a8 GEMV under every plan it can take, forced: bit for bit with
    the plain version (exact int32 sums, the same epilogue), one launch a
    call, a repeat call the same bits."""
    lhs, rhs4 = _int8(dev, m, k1 * 128, seed=m + k1), _int8(dev, n1, k1, 128, 128, seed=n1)
    s_a, s_w = _scales(dev, m, 1, seed=2), _scales(dev, n1, 128, seed=3)
    want = fused_gemv.fused_gemv_q8_plain(lhs, rhs4, s_a, s_w)
    for plan in _gemv_plans():
        before = fused_gemv.fused_gemv_q8.launches
        got = fused_gemv.fused_gemv_q8(lhs, rhs4, s_a, s_w, plan=plan)
        assert fused_gemv.fused_gemv_q8.launches == before + 1
        assert torch.equal(got, want), plan
        assert torch.equal(fused_gemv.fused_gemv_q8(lhs, rhs4, s_a, s_w, plan=plan), got)


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("n1,k1", [(4, 16), (1, 3), (2, 64)])
@pytest.mark.parametrize("m", list(range(1, 9)))
def test_fused_gemv_q4_every_plan(dev, m, n1, k1, group):
    """The w4a8 GEMV under every plan it can take, forced, at both groups
    (one and two B row blocks at g16): bit for bit with the plain version
    (exact f64 sums), one launch a call, a repeat call the same bits."""
    lhs, rhs4 = _int8(dev, m, k1 * 128, seed=m + k1), _nibbles(dev, n1, k1, 128, 64, seed=n1)
    s_a = _scales(dev, m, 1, seed=2)
    s_w4 = _scales(dev, n1, k1, 128, 128 // group, seed=3, dtype=torch.bfloat16)
    want = mmt4d_q4.fused_gemv_q4_plain(lhs, rhs4, s_a, s_w4, group)
    for plan in _gemv_plans():
        before = mmt4d_q4.fused_gemv_q4.launches
        got = mmt4d_q4.fused_gemv_q4(lhs, rhs4, s_a, s_w4, group, plan=plan)
        assert mmt4d_q4.fused_gemv_q4.launches == before + 1
        assert torch.equal(got, want), plan
        assert torch.equal(mmt4d_q4.fused_gemv_q4(lhs, rhs4, s_a, s_w4, group, plan=plan), got)


def test_fused_gemv_q8_sums_past_f32(dev):
    """All operands 127 at K = 8192 (|sum| = 132128768 > 2^24), then
    operands from [100, 127] and -128 against 127: the int32 fragments keep
    every sum exact, so the output equals the plain version bit for bit at
    8 and 16 warps a block (8 and 4 K tiles a warp)."""
    m, k1, n1 = 8, 64, 4
    s_a, s_w = _scales(dev, m, 1, seed=2), _scales(dev, n1, 128, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    full = torch.full((m, k1 * 128), 127, dtype=torch.int8, device=dev)
    cases = [(full, torch.full((n1, k1, 128, 128), 127, dtype=torch.int8, device=dev)),
             tuple(torch.randint(100, 128, shape, generator=g, device=dev, dtype=torch.int8)
                   for shape in ((m, k1 * 128), (n1, k1, 128, 128))),
             (torch.full_like(full, -128), torch.full((n1, k1, 128, 128), 127,
                                                       dtype=torch.int8, device=dev))]
    for lhs, rhs4 in cases:
        want = fused_gemv.fused_gemv_q8_plain(lhs, rhs4, s_a, s_w)
        for plan in _gemv_plans():
            assert torch.equal(fused_gemv.fused_gemv_q8(lhs, rhs4, s_a, s_w, plan=plan), want)


@pytest.mark.parametrize("group", [16, 32])
def test_fused_gemv_q4_extreme_sums_and_scales(dev, group):
    """Every row -128 against every nibble -8: each group's sum is 1024 *
    group (32768 at g32, where the f64 term's high word carries into its
    exponent); then group scales spanning 2^-10 .. 2^10 in each weight row,
    at K = 8192: still exact, so equal bit for bit, at 1-4 and 5-8 rows."""
    k1, n1 = 64, 4
    s_w4 = _scales(dev, n1, k1, 128, 128 // group, seed=3, dtype=torch.bfloat16)
    rhs4 = torch.full((n1, k1, 128, 64), 0x88, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    span = torch.randint(-10, 11, s_w4.shape, generator=g, device=dev).float().exp2()
    wide = (s_w4.float() * span).to(torch.bfloat16)
    for m in (3, 8):
        s_a = _scales(dev, m, 1, seed=2)
        lhs = torch.full((m, k1 * 128), -128, dtype=torch.int8, device=dev)
        got = mmt4d_q4.fused_gemv_q4(lhs, rhs4, s_a, s_w4, group)
        assert torch.equal(got, mmt4d_q4.fused_gemv_q4_plain(lhs, rhs4, s_a, s_w4, group))
        lhs, nib = _int8(dev, m, k1 * 128, seed=6), _nibbles(dev, n1, k1, 128, 64, seed=7)
        got = mmt4d_q4.fused_gemv_q4(lhs, nib, s_a, wide, group)
        assert torch.equal(got, mmt4d_q4.fused_gemv_q4_plain(lhs, nib, s_a, wide, group))


def test_quantized_gemvs_take_unaligned_views(dev):
    """Rows that arrive as a view off a 16-byte boundary (a column slice,
    as the activation quantizer's output may be) and group scales viewed
    at an offset of one bf16 give the bits of their contiguous copies: the
    wrappers hand the kernels 16-byte aligned bases."""
    n1, k1, m = 4, 3, 5
    big = _int8(dev, m + 1, k1 * 128 + 8, seed=1)
    xq = big[1:, 3:3 + k1 * 128]
    assert not xq.is_contiguous()
    flat = _int8(dev, m * k1 * 128 + 1, seed=2)
    xs = flat[1:].view(m, k1 * 128)
    assert xs.data_ptr() % 16 != 0
    rq, s_a, s_w = _int8(dev, n1, k1, 128, 128, seed=3), _scales(dev, m, 1), _scales(dev, n1, 128)
    for x in (xq, xs):
        assert torch.equal(fused_gemv.fused_gemv_q8(x, rq, s_a, s_w),
                           fused_gemv.fused_gemv_q8(x.contiguous(), rq, s_a, s_w))
    nib = _nibbles(dev, n1, k1, 128, 64, seed=4)
    for group in (16, 32):
        shape = (n1, k1, 128, 128 // group)
        sbuf = _scales(dev, shape[0] * shape[1] * shape[2] * shape[3] + 1, seed=5,
                       dtype=torch.bfloat16)
        s_w4 = sbuf[1:].view(shape)
        assert s_w4.data_ptr() % 16 != 0
        want = mmt4d_q4.fused_gemv_q4(xq.contiguous(), nib, s_a, s_w4.contiguous(), group)
        assert torch.equal(want, mmt4d_q4.fused_gemv_q4_plain(xq.contiguous(), nib, s_a,
                                                               s_w4.contiguous(), group))
        for x in (xq, xs):
            assert torch.equal(mmt4d_q4.fused_gemv_q4(x, nib, s_a, s_w4, group),
                               mmt4d_q4.fused_gemv_q4(x.contiguous(), nib, s_a, s_w4.contiguous(),
                                                      group))


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("m1,m0", [(1, 8), (3, 8), (2, 5), (8, 8), (1, 128), (3, 128), (130, 8)])
def test_mmt4d_q4_kernel(dev, m1, m0, group):
    """The w4a8 GEMM on the skinny body at its plan and with the plan
    forced: 16-column blocks at 1 and 3 K splits, and 64-column blocks at 1
    and 2 where a block holds 57-64 rows; each equal to the plain version
    bit for
    bit (exact f64 sums), a repeat call too, counters reset by each
    launch."""
    n1, k1 = 4, 3
    lhs4, rhs4 = _int8(dev, m1, k1, m0, 128, seed=m1 * m0), _nibbles(dev, n1, k1, 128, 64, seed=1)
    s_a = _scales(dev, m1, m0, seed=2)
    s_w4 = _scales(dev, n1, k1, 128, 128 // group, seed=3, dtype=torch.bfloat16)
    want = mmt4d_q4.mmt4d_q4_plain(lhs4, rhs4, s_a, s_w4, group)
    plans = [None, ("skinny", mmt4d_q4.Q4_BN, 1), ("skinny", mmt4d_q4.Q4_BN, 3)]
    if mmt4d_q4.q4_groups(m1, m0)[0] > 56:
        plans += [("skinny", mmt4d_q4.Q4_WIDE_BN, 1), ("skinny", mmt4d_q4.Q4_WIDE_BN, 2)]
    for plan in plans:
        before = mmt4d_q4.mmt4d_q4.launches
        got = mmt4d_q4.mmt4d_q4(lhs4, rhs4, s_a, s_w4, group, plan=plan)
        assert mmt4d_q4.mmt4d_q4.launches == before + 1
        assert torch.equal(got, want), plan
        assert _counters_zero()
        assert torch.equal(mmt4d_q4.mmt4d_q4(lhs4, rhs4, s_a, s_w4, group, plan=plan), got)


@pytest.mark.parametrize("group", [16, 32])
def test_mmt4d_q4_extreme_sums_and_scales(dev, group):
    """Every row -128 against every nibble -8: each group's sum is 1024 *
    group (32768 at g32, where the f64 term's high word carries into its
    exponent); and group scales spanning 2^-10 .. 2^10 in each weight row,
    at K = 8192 split across blocks: still exact, so equal bit for bit."""
    m1, k1, n1 = 3, 64, 4
    s_a = _scales(dev, m1, 8, seed=2)
    s_w4 = _scales(dev, n1, k1, 128, 128 // group, seed=3, dtype=torch.bfloat16)
    lhs4 = torch.full((m1, k1, 8, 128), -128, dtype=torch.int8, device=dev)
    rhs4 = torch.full((n1, k1, 128, 64), 0x88, dtype=torch.uint8, device=dev)
    for plan in (None, ("skinny", mmt4d_q4.Q4_BN, 5)):
        got = mmt4d_q4.mmt4d_q4(lhs4, rhs4, s_a, s_w4, group, plan=plan)
        assert torch.equal(got, mmt4d_q4.mmt4d_q4_plain(lhs4, rhs4, s_a, s_w4, group))
    g = torch.Generator(device=dev).manual_seed(5)
    span = torch.randint(-10, 11, s_w4.shape, generator=g, device=dev).float().exp2()
    wide = (s_w4.float() * span).to(torch.bfloat16)
    lhs4, rhs4 = _int8(dev, m1, k1, 8, 128, seed=6), _nibbles(dev, n1, k1, 128, 64, seed=7)
    for plan in (None, ("skinny", mmt4d_q4.Q4_BN, 7)):
        got = mmt4d_q4.mmt4d_q4(lhs4, rhs4, s_a, wide, group, plan=plan)
        assert torch.equal(got, mmt4d_q4.mmt4d_q4_plain(lhs4, rhs4, s_a, wide, group))


@pytest.mark.parametrize("wq", ["int8", "int4"])
@pytest.mark.parametrize("config", [dict(), dict(spec_decode=True, draft_k=4),
                                    dict(token_budget=16), dict(slots=10)])
def test_quantized_engine_kernels_match_plain_path(dev, wq, config):
    """The reduced f32 model with int8 or int4 weights, served through the
    quantized kernels (registry routing), emits the tokens of the plain
    ("xla") quantized projections on the card.  Both runs take the attention
    kernels and the same configuration: the activation quantizer turns f32
    differences of one ulp into whole int8 steps, so only the quantized
    projections, which equal their plain versions bit for bit, differ."""
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    params = T.model_init(cfg, EncodingConfig(weight_quant=wq), seed=0, device=dev)
    rng = np.random.RandomState(2)
    prompts = [np.tile(rng.randint(1, cfg.vocab_size, 4), n).astype(np.int32)
               for n in (3, 8, 5, 2, 6, 4)]
    prompts += [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in (5, 17, 30, 9)]
    config = dict(dict(slots=4, max_seq=96, block_size=8), **config)
    want, _ = _serve(params, cfg, EncodingConfig(backend="xla", attn_backend="auto",
                                                 weight_quant=wq), dev, prompts, 8, **config)
    kernels = ((fused_gemv.fused_gemv_q8, mmt4d_q8.mmt4d_q8) if wq == "int8"
               else (mmt4d_q4.fused_gemv_q4, mmt4d_q4.mmt4d_q4))
    before = [k.launches for k in kernels]
    got, _ = _serve(params, cfg, EncodingConfig(backend="auto", attn_backend="auto",
                                                weight_quant=wq), dev, prompts, 8, **config)
    assert got == want
    gemv_ran, gemm_ran = (k.launches > b for k, b in zip(kernels, before))
    assert gemm_ran and (gemv_ran or config.get("slots", 4) > 8)  # > 8 slots: no GEMV rows


# ---------------------------------------------------------------------------
# Quantized KV pools and the dense cache


@pytest.mark.parametrize("kv", ["kv8", "kv4"])
@pytest.mark.parametrize("config", [dict(), dict(spec_decode=True, draft_k=4),
                                    dict(token_budget=16)])
def test_quantized_kv_engine_kernels_match_cpu(dev, kv, config):
    """The reduced f32 model on kv8/kv4 pools, served through the kernels
    on the card, emits the tokens of the same engine on the CPU (the plain
    versions, with the same weights)."""
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    params = T.model_init(cfg, EncodingConfig(), seed=0, device="cpu")
    rng = np.random.RandomState(3)
    prompts = [np.tile(rng.randint(1, cfg.vocab_size, 4), n).astype(np.int32)
               for n in (3, 8, 5, 2)]
    prompts += [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in (5, 17, 30)]
    config = dict(dict(slots=4, max_seq=96, block_size=8, kv_quant=kv), **config)
    enc = EncodingConfig(backend="auto", attn_backend="auto")
    want, _ = _serve(params, cfg, enc, "cpu", prompts, 8, **config)
    before = attn.paged_decode_attention.launches_by_kv[kv]
    got, _ = _serve(_to(params, dev), cfg, enc, dev, prompts, 8, **config)
    assert got == want
    assert attn.paged_decode_attention.launches_by_kv[kv] > before


@pytest.mark.parametrize("config", [dict(cache_mode="dense"), dict(decode_mode="grouped"),
                                    dict(cache_mode="dense", spec_decode=True, draft_k=4),
                                    dict(cache_mode="dense", token_budget=16)])
def test_dense_engine_kernels_match_plain_path(dev, config):
    """The reduced model on the dense cache, served through the kernels,
    emits the tokens of the plain phase-split engine on the card."""
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    params = T.model_init(cfg, EncodingConfig(), seed=0, device=dev)
    rng = np.random.RandomState(4)
    prompts = [np.tile(rng.randint(1, cfg.vocab_size, 4), n).astype(np.int32)
               for n in (3, 8, 5, 2, 6, 4)]
    want, _ = _serve(params, cfg, EncodingConfig(backend="reference", attn_backend="xla"),
                     dev, prompts, 10, slots=4, max_seq=96, block_size=8)
    before = attn.dense_decode_attention.launches
    got, eng = _serve(params, cfg, EncodingConfig(backend="auto", attn_backend="auto"), dev,
                      prompts, 10, max_seq=96, **config)
    assert got == want and eng.stats["cache_mode"] == "dense"
    assert attn.dense_decode_attention.launches > before


def _to(tree, dev):
    """A copy of a parameter tree on `dev`."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


# ---------------------------------------------------------------------------
# pack / unpack, batch_mmt4d, the sampler


def _bits(dev, dtype, *shape, seed=0):
    """Random values of every bit pattern a dtype holds (NaNs included for
    floats: the kernels copy bytes and must not care)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    size = torch.empty((), dtype=dtype).element_size()
    raw = torch.randint(-(2 ** (8 * size - 1)), 2 ** (8 * size - 1), shape, generator=g,
                        device=dev, dtype={1: torch.int8, 2: torch.int16, 4: torch.int32}[size])
    return raw.view(dtype)


def _raw(t):
    size = t.element_size()
    return t.contiguous().view({1: torch.int8, 2: torch.int16, 4: torch.int32}[size])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8, torch.uint8])
@pytest.mark.parametrize("shape,tile", [((256, 512), (128, 128)), ((300, 200), (128, 128)),
                                        ((4, 200), (8, 128)), ((130, 13), (128, 8)),
                                        ((256, 128), (128, 8)), ((37, 100), (16, 64)),
                                        ((5, 7), (2, 4))])
def test_pack_unpack_kernels(dev, dtype, shape, tile):
    """Every element size, the port's tiles and ragged edges (the 16-byte
    chunk path and the per-element path), bit for bit."""
    x = _bits(dev, dtype, *shape)
    before = (pack.pack.launches, pack.unpack.launches)
    got = pack.pack(x, tile)
    assert pack.pack.launches == before[0] + 1
    assert torch.equal(_raw(got), _raw(pack.pack_plain(x, tile)))
    for crop in (shape, (max(1, shape[0] - 1), max(1, shape[1] - 3))):
        back = pack.unpack(got, crop)
        assert back.is_contiguous() and torch.equal(_raw(back), _raw(pack.unpack_plain(got, crop)))
    assert pack.unpack.launches == before[1] + 2


def test_pack_kernel_takes_unaligned_views(dev):
    x = _bits(dev, torch.bfloat16, 65, 264)[1:, 3:259]  # neither contiguous nor aligned
    got = pack.pack(x, (16, 64))
    assert torch.equal(_raw(got), _raw(pack.pack_plain(x, (16, 64))))
    y4 = _bits(dev, torch.float32, 4097)[1:].reshape(2, 2, 8, 128)  # 4-byte offset
    assert torch.equal(_raw(pack.unpack(y4, (13, 250))), _raw(pack.unpack_plain(y4, (13, 250))))


def test_pack_kernels_check_operands(dev):
    with pytest.raises(TypeError, match="4-byte"):
        pack.pack(torch.zeros(4, 4, dtype=torch.float64, device=dev), (2, 2))
    with pytest.raises(ValueError, match="cannot give"):
        pack.unpack(torch.zeros(1, 1, 2, 2, device=dev), (3, 2))
    with pytest.raises(ValueError, match="K tiles differ"):
        batch_mmt4d.batch_mmt4d(torch.zeros(1, 1, 1, 64, 8, device=dev),
                                torch.zeros(1, 1, 2, 64, 8, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 2, 3, 16, 8, 8), (3, 4, 2, 8, 32, 16),
                                   (128, 8, 1, 16, 16, 64), (128, 8, 2, 16, 16, 64),
                                   (2, 2, 3, 64, 64, 40), (3, 3, 2, 5, 7, 13)])
def test_batch_mmt4d_kernel(dev, dtype, shape):
    """The JAX test's shapes, the attention score / context shapes, a 64 x
    64 output tile (past the old kernel's 1024 outputs a tile) and K0 = 13
    (element copies: no 16-byte run)."""
    bsz, m1, k1, m0, n0, k0 = shape
    lhs = _rand(dev, dtype, bsz, m1, k1, m0, k0, seed=1)
    rhs = _rand(dev, dtype, bsz, m1 + 1, k1, n0, k0, seed=2)
    before = batch_mmt4d.batch_mmt4d.launches
    got = batch_mmt4d.batch_mmt4d(lhs, rhs)
    assert batch_mmt4d.batch_mmt4d.launches == before + 1
    torch.testing.assert_close(got, batch_mmt4d.batch_mmt4d_plain(lhs, rhs), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("backend", ["pallas", "fused"])
@pytest.mark.parametrize("wq", ["none", "int8", "int4"])
def test_packed_routes_launch_pack_kernels(dev, backend, wq):
    """The weight pack at load runs the pack kernel (int4: its codes and its
    scales); a projection on any route launches no activation pack and no
    output unpack, the packed routes one launch of their packed GEMM."""
    enc = EncodingConfig(backend=backend, attn_backend="auto", weight_quant=wq)
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    before = pack.pack.launches
    params = T.model_init(cfg, enc, seed=0, device=dev)
    per_weight = 2 if wq == "int4" else 1  # int4 packs its codes and its scales
    assert pack.pack.launches - before == 7 * cfg.num_layers * per_weight
    x = _rand(dev, cfg.activation_dtype, 20, cfg.d_model)
    gemm = {"none": mmt4d.mmt4d, "int8": mmt4d_q8.mmt4d_q8, "int4": mmt4d_q4.mmt4d_q4}[wq]
    counts = (pack.pack.launches, pack.unpack.launches, gemm.launches)
    packed_lib.linear_apply(params["layers"][0]["attn"]["wq"], x, n=cfg.d_model,
                            phase=Phase.DECODE, enc=enc)
    packed_route = backend == "pallas" or wq != "none"  # 20 decode rows: the packed GEMMs
    assert (pack.pack.launches - counts[0], pack.unpack.launches - counts[1],
            gemm.launches - counts[2]) == (0, 0, 1 if packed_route else 0)


# ---- the packed GEMMs' plain-row entries: the packed route bit for bit -------------

# Rows of decode windows (M0 = 8), wide windows and prefill batches (M0 =
# 128), and M0s whose row groups are not a multiple of 8 rows.
_ROWS_CASES = ([(m, 8) for m in (9, 20, 21, 33, 64, 65, 256, 300, 2048)]
               + [(m, 128) for m in (9, 20, 65, 256, 300, 2048)]
               + [(20, 3), (33, 5), (21, 6), (65, 7), (300, 3)])


def _gemm_plans(m1, m0, n1, k1):
    """The plan the route runs and every plan the packed tests force: the
    skinny body at 1, 3 and K1 splits (M0 <= 64), the wide body at each
    tile whose box lands the row blocks."""
    plans = [None]
    if m0 <= mmt4d.SKINNY_ROWS:
        plans += [("skinny", mmt4d.SKINNY_BN, s) for s in sorted({1, min(3, k1), k1})]
    if m0 in mmt4d.WIDE_M0:
        plans += [("wide", bm, bn) for bm, bn in ((64, 64), (128, 64), (128, 128))
                  if bm % m0 == 0 or m0 % bm == 0]
    return plans


def _packed_route(fn, x, m0, n, *args):
    """pack -> the packed entry -> unpack, each a kernel."""
    return pack.unpack(fn(pack.pack(x, (m0, 128)), *args), (x.shape[0], n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,m0", _ROWS_CASES)
def test_mmt4d_rows_equal_packed_route(dev, dtype, m, m0):
    """mmt4d_rows == unpack(mmt4d(pack(x))) bit for bit under every plan,
    one mmt4d launch and no pack or unpack a call; and the plain version
    to the GEMM's tolerance."""
    n1, k1 = 4, 16
    x = _rand(dev, dtype, m, k1 * 128, seed=m * m0)
    rhs4 = _rand(dev, dtype, n1, k1, 128, 128, scale=(k1 * 128) ** -0.5, seed=m0)
    m1 = -(-m // m0)
    plans = _gemm_plans(m1, m0, n1, k1) if dtype == torch.bfloat16 else [None]
    for plan in plans:
        want = _packed_route(lambda l4: mmt4d.mmt4d(l4, rhs4, plan=plan), x, m0, n1 * 128)
        counts = (pack.pack.launches, pack.unpack.launches, mmt4d.mmt4d.launches)
        got = mmt4d.mmt4d_rows(x, rhs4, m0, plan=plan)
        assert (pack.pack.launches, pack.unpack.launches, mmt4d.mmt4d.launches) == (
            counts[0], counts[1], counts[2] + 1)
        assert torch.equal(got, want), plan
        assert _counters_zero()
    torch.testing.assert_close(got, mmt4d.mmt4d_rows_plain(x, rhs4, m0), **_tol(dtype, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k1", [3, 16])
@pytest.mark.parametrize("m", list(range(1, 9)))
def test_mmt4d_gemv_rows_equal_packed_route(dev, dtype, k1, m):
    n1 = 4
    x = _rand(dev, dtype, m, k1 * 128, seed=m + k1)
    rhs4 = _rand(dev, dtype, n1, k1, 128, 128, scale=(k1 * 128) ** -0.5, seed=k1)
    want = _packed_route(mmt4d_gemv.mmt4d_gemv, x, m, n1 * 128, rhs4)
    before = mmt4d_gemv.mmt4d_gemv.launches
    got = mmt4d_gemv.mmt4d_gemv_rows(x, rhs4)
    assert mmt4d_gemv.mmt4d_gemv.launches == before + 1
    assert torch.equal(got, want)
    torch.testing.assert_close(got, mmt4d_gemv.mmt4d_gemv_rows_plain(x, rhs4), **_tol(dtype, True))


@pytest.mark.parametrize("m,m0", _ROWS_CASES)
def test_mmt4d_q8_rows_equal_packed_route(dev, m, m0):
    """int8: bit for bit against the packed route (s_a padded with zeros)
    and against the plain version, under every plan."""
    n1, k1 = 4, 16
    xq, rhs4 = _int8(dev, m, k1 * 128, seed=m * m0), _int8(dev, n1, k1, 128, 128, seed=1)
    s_a, s_w = _scales(dev, m, seed=2), _scales(dev, n1, 128, seed=3)
    sa2 = mmt4d_q8.packed_scales(s_a, m0)
    for plan in _gemm_plans(-(-m // m0), m0, n1, k1):
        want = _packed_route(lambda l4: mmt4d_q8.mmt4d_q8(l4, rhs4, sa2, s_w, plan=plan),
                             xq, m0, n1 * 128)
        before = mmt4d_q8.mmt4d_q8.launches
        got = mmt4d_q8.mmt4d_q8_rows(xq, rhs4, s_a, s_w, m0, plan=plan)
        assert mmt4d_q8.mmt4d_q8.launches == before + 1
        assert torch.equal(got, want), plan
        assert _counters_zero()
    assert torch.equal(got, mmt4d_q8.mmt4d_q8_rows_plain(xq, rhs4, s_a, s_w, m0))


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("m,m0", _ROWS_CASES)
def test_mmt4d_q4_rows_equal_packed_route(dev, m, m0, group):
    """int4: bit for bit against the packed route and the plain version
    (exact f64 sums) at its plan and with the plan forced: 16-column blocks
    at 1 and 3 K splits, 64-column blocks where a block holds 57-64 rows."""
    n1, k1 = 4, 16
    xq, rhs4 = _int8(dev, m, k1 * 128, seed=m * m0), _nibbles(dev, n1, k1, 128, 64, seed=1)
    s_a = _scales(dev, m, seed=2)
    s_w4 = _scales(dev, n1, k1, 128, 128 // group, seed=3, dtype=torch.bfloat16)
    sa2 = mmt4d_q8.packed_scales(s_a, m0)
    plans = [None, ("skinny", mmt4d_q4.Q4_BN, 1), ("skinny", mmt4d_q4.Q4_BN, 3)]
    if mmt4d_q4.q4_groups(-(-m // m0), m0)[0] > 56:
        plans += [("skinny", mmt4d_q4.Q4_WIDE_BN, 1), ("skinny", mmt4d_q4.Q4_WIDE_BN, 2)]
    for plan in plans:
        want = _packed_route(
            lambda l4: mmt4d_q4.mmt4d_q4(l4, rhs4, sa2, s_w4, group, plan=plan), xq, m0, n1 * 128)
        before = mmt4d_q4.mmt4d_q4.launches
        got = mmt4d_q4.mmt4d_q4_rows(xq, rhs4, s_a, s_w4, group, m0, plan=plan)
        assert mmt4d_q4.mmt4d_q4.launches == before + 1
        assert torch.equal(got, want), plan
        assert _counters_zero()
    assert torch.equal(got, mmt4d_q4.mmt4d_q4_rows_plain(xq, rhs4, s_a, s_w4, group, m0))


def test_rows_entries_take_unaligned_views(dev):
    """A window that arrives as a view (a column slice, a base off 16
    bytes) gives the bits of its contiguous copy."""
    n1, k1, m = 4, 3, 20
    rhs4 = _rand(dev, torch.bfloat16, n1, k1, 128, 128, scale=384**-0.5, seed=1)
    big = _rand(dev, torch.bfloat16, m + 1, k1 * 128 + 8, seed=2)
    view = big[1:, 3:3 + k1 * 128]
    assert not view.is_contiguous()
    assert torch.equal(mmt4d.mmt4d_rows(view, rhs4, 8), mmt4d.mmt4d_rows(view.contiguous(), rhs4, 8))
    bq = _int8(dev, m + 1, k1 * 128 + 8, seed=3)
    rq = _int8(dev, n1, k1, 128, 128, seed=4)
    s_a, s_w = _scales(dev, m, seed=5), _scales(dev, n1, 128, seed=6)
    vq = bq[1:, 3:3 + k1 * 128]
    assert torch.equal(mmt4d_q8.mmt4d_q8_rows(vq, rq, s_a, s_w, 8),
                       mmt4d_q8.mmt4d_q8_rows(vq.contiguous(), rq, s_a, s_w, 8))


@pytest.mark.parametrize("seed,step", [(0, 0), (9, 3), (12345, 100000)])
def test_sampler_bits_on_card_equal_cpu(dev, seed, step):
    key = sampling.fold_in(sampling.prng_key(seed), step)
    shape = (4, 128256)
    assert torch.equal(sampling.random_bits(key, shape, dev).cpu(),
                       sampling.random_bits(key, shape))
    u = sampling.uniform(key, shape, minval=sampling.TINY, device=dev).cpu()
    assert torch.equal(u.view(torch.int32),
                       sampling.uniform(key, shape, minval=sampling.TINY).view(torch.int32))
    logits = _rand(dev, torch.float32, *shape, scale=4.0, seed=seed)
    temp = torch.tensor([0.0, 0.5, 1.0, 2.0], device=dev)
    assert torch.equal(sampling.sample_rows(logits, temp, key).cpu(),
                       sampling.sample_rows(logits.cpu(), temp.cpu(), key))


@pytest.mark.parametrize("config", [dict(), dict(decode_mode="grouped")])
def test_sampled_engine_kernels_match_plain_path(dev, config):
    """The reduced model sampled at mixed temperatures through the kernels
    emits the plain backends' tokens on the card; its temperature-0
    requests emit the greedy engine's."""
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    params = T.model_init(cfg, EncodingConfig(), seed=0, device=dev)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in (5, 17, 30, 9)]
    temps = [0.7, 0.0, 0.7, 0.0]

    def serve(enc, sample):
        eng = engine_lib.Engine(params, cfg, enc, device=dev, config=EngineConfig(
            slots=4, max_seq=64, sample=sample, seed=3, **config))
        for i, (p, t) in enumerate(zip(prompts, temps)):
            eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=8, temperature=t))
        return {r.uid: r.generated for r in eng.run()}

    kernels = serve(EncodingConfig(backend="auto", attn_backend="auto"), "temperature")
    plain = serve(EncodingConfig(backend="reference", attn_backend="xla"), "temperature")
    greedy = serve(EncodingConfig(backend="auto", attn_backend="auto"), "greedy")
    assert kernels == plain
    assert all(kernels[i] == greedy[i] for i, t in enumerate(temps) if t == 0)


# ---------------------------------------------------------------------------
# The dense family's shapes: head dim 128 at G = 5, 6, 8; K1 = 12 and the
# untied heads


# (query heads, kv heads) of each group size: Qwen2.5 40/8 (G = 5),
# Qwen2-1.5B 12/2 (G = 6), Yi-9B 32/4 (G = 8).
_HEADS_128 = {5: (40, 8), 6: (12, 2), 8: (32, 4)}


@pytest.mark.parametrize("g", sorted(_HEADS_128))
@pytest.mark.parametrize("kv", ["bf16", "kv8", "kv4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 3, 5, 16, 256])
def test_paged_decode_kernel_head_dim_128(dev, dtype, L, kv, g):
    """D = 128 at G = 5, 6 and 8: L * G query rows that are no multiple of
    the group in a 64-row tile (L = 3 and 5 at G = 5, 6: 15-30 rows, the
    tensor cores in bf16 from 16), on bf16, kv8 and kv4 pools (kv4: 64
    bytes a row)."""
    h, kvh = _HEADS_128[g]
    rng = np.random.RandomState(L + g)
    b, d, bs, pages = 3, 128, 16, 40
    nb = 8 + L // bs
    q = _rand(dev, dtype, b, L, h, d, seed=4)
    k_pool, k_scale = _kv_pages(dev, kv, dtype, pages, bs, kvh, d, seed=5)
    v_pool, v_scale = _kv_pages(dev, kv, dtype, pages, bs, kvh, d, seed=6)
    table = torch.from_numpy(rng.randint(1, pages, (b, nb)).astype(np.int32)).to(dev)
    table[1, :2] = table[0, :2]
    pos = torch.tensor([0, 37, nb * bs - L], dtype=torch.int32, device=dev)
    kw = dict(k_scale=k_scale, v_scale=v_scale, kv_quant=kv)
    before = attn.paged_decode_attention.launches_by_kv[kv]
    got = attn.paged_decode_attention(q, k_pool, v_pool, table, pos, **kw)
    assert attn.paged_decode_attention.launches_by_kv[kv] == before + 1
    want = attn.paged_decode_attention_plain(q, k_pool, v_pool, table, pos, **kw)
    torch.testing.assert_close(got, want, **_tol(dtype, False))
    assert torch.equal(attn.paged_decode_attention(q, k_pool, v_pool, table, pos, **kw), got)


@pytest.mark.parametrize("g", sorted(_HEADS_128))
@pytest.mark.parametrize("kv", ["bf16", "kv8", "kv4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 3, 16])
def test_dense_decode_kernel_head_dim_128(dev, dtype, L, kv, g):
    b, d, s_c = 3, 128, 1024
    h, kvh = _HEADS_128[g]
    q = _rand(dev, dtype, b, L, h, d, seed=7)
    k, k_scale = _kv_pages(dev, kv, dtype, b, s_c, kvh, d, seed=8)
    v, v_scale = _kv_pages(dev, kv, dtype, b, s_c, kvh, d, seed=9)
    pos = torch.tensor([0, 300, s_c - L], dtype=torch.int32, device=dev)
    kw = dict(k_scale=k_scale, v_scale=v_scale, kv_quant=kv)
    got = attn.dense_decode_attention(q, k, v, pos, **kw)
    want = attn.dense_decode_attention_plain(q, k, v, pos, **kw)
    torch.testing.assert_close(got, want, **_tol(dtype, False))


@pytest.mark.parametrize("g", sorted(_HEADS_128))
@pytest.mark.parametrize("kv,dtype", [("bf16", torch.bfloat16), ("bf16", torch.float32),
                                      ("kv8", torch.bfloat16), ("kv4", torch.bfloat16)])
@pytest.mark.parametrize("L", [1, 5, 16])
def test_identity_table_head_dim_128(dev, kv, dtype, L, g):
    """Paged == dense through the identity table, bit for bit, at D = 128."""
    h, kvh = _HEADS_128[g]
    b, d, bs, nb = 4, 128, 16, 64
    s_c = nb * bs
    q = _rand(dev, dtype, b, L, h, d, seed=10)
    k, k_scale = _kv_pages(dev, kv, dtype, b, s_c, kvh, d, seed=11)
    v, v_scale = _kv_pages(dev, kv, dtype, b, s_c, kvh, d, seed=12)
    pos = torch.tensor([37, 300, 511, s_c - L], dtype=torch.int32, device=dev)
    table = torch.arange(b * nb, dtype=torch.int32, device=dev).reshape(b, nb)

    def pages(a):
        return None if a is None else a.reshape(b * nb, bs, *a.shape[2:])

    dense = attn.dense_decode_attention(q, k, v, pos, k_scale=k_scale, v_scale=v_scale,
                                        kv_quant=kv)
    paged = attn.paged_decode_attention(q, pages(k), pages(v), table, pos,
                                        k_scale=pages(k_scale), v_scale=pages(v_scale),
                                        kv_quant=kv)
    assert torch.equal(paged, dense)


@pytest.mark.parametrize("g", sorted(_HEADS_128))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,q_offset", [(512, 512, 0), (256, 512, 256), (7, 100, 93),
                                            (65, 65, 0)])
def test_flash_prefill_head_dim_128(dev, dtype, sq, sk, q_offset, g):
    h, kvh = _HEADS_128[g]
    q, k, v = _prefill_qkv(dev, dtype, 2, sq, sk, h, kvh, 128)
    got = attn.flash_prefill_attention(q, k, v, q_offset=q_offset)
    torch.testing.assert_close(got, attn.flash_prefill_attention_plain(q, k, v, q_offset=q_offset),
                               **_tol(dtype, False))
    assert torch.equal(got, attn.dense_decode_attention(q, k, v, q_offset))


# K x N of Qwen2-1.5B's projections (K1 = 12: fewer K tiles than the GEMVs'
# 16 warps) and of the untied heads (Yi-9B's N = 64000).
_DENSE_KN = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536), (4096, 64000)]


@pytest.mark.parametrize("k,n", _DENSE_KN)
def test_projection_kernels_at_dense_family_shapes(dev, k, n):
    """bf16: fused_gemv (1, 4, 8 rows), mmt4d_rows (20 rows at M0 = 8, 300
    at M0 = 128) and fused_pack_mmt4d (300 rows) against their plain
    versions; w8a8 and w4a8 g16: the GEMVs and the plain-row GEMMs bit for
    bit, the weights quantized as the model does."""
    from repro_torch.kernels import ops, ref

    w_t = _rand(dev, torch.bfloat16, n, k, scale=k**-0.5, seed=1)
    rhs4 = ref.pack(w_t, (128, 128))
    for m in (1, 4, 8):
        x = _rand(dev, torch.bfloat16, m, k, seed=m)
        torch.testing.assert_close(fused_gemv.fused_gemv(x, rhs4),
                                   fused_gemv.fused_gemv_plain(x, rhs4), rtol=1e-3, atol=1e-3)
    for m, m0 in ((20, 8), (300, 128)):
        x = _rand(dev, torch.bfloat16, m, k, seed=m)
        torch.testing.assert_close(mmt4d.mmt4d_rows(x, rhs4, m0),
                                   mmt4d.mmt4d_rows_plain(x, rhs4, m0), rtol=1e-3, atol=1e-3)
    x = _rand(dev, torch.bfloat16, 300, k, seed=5)
    torch.testing.assert_close(fused_pack_mmt4d.fused_pack_mmt4d(x, rhs4),
                               fused_pack_mmt4d.fused_pack_mmt4d_plain(x, rhs4),
                               rtol=1e-3, atol=1e-3)
    del rhs4
    rhs4_q, s_w = ops.pack_rhs_q8(w_t)
    rhs4_p, s_w4 = ops.pack_rhs_q4(w_t, group=16)
    del w_t
    for m in (1, 4, 8, 20):
        xq, s_a = ref.quantize_rows(_rand(dev, torch.bfloat16, m, k, seed=10 + m))
        if m <= 8:
            sa1 = s_a[:, None]
            assert torch.equal(fused_gemv.fused_gemv_q8(xq, rhs4_q, sa1, s_w),
                               fused_gemv.fused_gemv_q8_plain(xq, rhs4_q, sa1, s_w))
            assert torch.equal(mmt4d_q4.fused_gemv_q4(xq, rhs4_p, sa1, s_w4, 16),
                               mmt4d_q4.fused_gemv_q4_plain(xq, rhs4_p, sa1, s_w4, 16))
        else:
            assert torch.equal(mmt4d_q8.mmt4d_q8_rows(xq, rhs4_q, s_a, s_w, 8),
                               mmt4d_q8.mmt4d_q8_rows_plain(xq, rhs4_q, s_a, s_w, 8))
            assert torch.equal(mmt4d_q4.mmt4d_q4_rows(xq, rhs4_p, s_a, s_w4, 16, 8),
                               mmt4d_q4.mmt4d_q4_rows_plain(xq, rhs4_p, s_a, s_w4, 16, 8))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2.5-14b", "yi-9b"])
def test_dense_family_engine_kernels_match_plain_path(dev, arch):
    """The head-kept reduced model (G = 6, 5, 8 at D = 128; nonzero QKV
    biases; Qwen2.5 and Yi untied heads) served through the kernels emits
    the plain backends' tokens: phase-split and spec decode."""
    full = cfg_registry.get_config(arch)
    cfg = cfg_registry.get_reduced(arch, num_heads=full.num_heads,
                                   num_kv_heads=full.num_kv_heads, head_dim=128)
    params = T.model_init(cfg, EncodingConfig(), seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for layer in params["layers"]:
        for proj in layer["attn"].values():
            if "b" in proj:
                proj["b"].normal_(0.0, 0.5, generator=g)
    rng = np.random.RandomState(7)
    prompts = [np.tile(rng.randint(1, cfg.vocab_size, 3), n).astype(np.int32) for n in (3, 6)]
    prompts += [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in (5, 17, 30)]

    def serve(enc, **config):
        eng = engine_lib.Engine(params, cfg, enc, device=dev, config=EngineConfig(
            slots=3, max_seq=64, block_size=8, **config))
        for i, p in enumerate(prompts):
            eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=8))
        out = {r.uid: r.generated for r in eng.run()}
        assert not eng.stats["degraded"] and eng.stats["pages_in_use"] == 0
        return out

    plain = serve(EncodingConfig(backend="reference", attn_backend="xla"))
    assert serve(EncodingConfig(backend="fused", attn_backend="auto")) == plain
    assert serve(EncodingConfig(backend="auto", attn_backend="auto"), spec_decode=True,
                 draft_k=4) == plain


def test_train_step_card_matches_cpu(dev):
    """One train step of the reduced f32 Llama on the card and on the CPU
    from the same params (made on the CPU) and batch, TF32 off: the loss
    within 1e-5 relative, the grad norm within 1e-4 relative, every updated
    param within 1e-6 abs except where |g| < 1e-6 x max|g| of its leaf
    (Adam's first step is the sign of noise there) or where the clipped
    gradient Adam sees, |g| x min(1, clip_norm / grad_norm), is below 10 x eps
    (Adam's eps region, where its first step g / (|g| + eps) turns steeply
    with g): there within 2 x lr.  No kernel launches inside the step."""
    from repro_torch.core import tree
    from repro_torch.data import pipeline as data_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer as trainer_lib

    cfg = cfg_registry.get_reduced("llama3.2-1b")
    enc = EncodingConfig(backend="xla")
    params = T.model_init(cfg, enc, seed=0, device="cpu")
    batch = data_lib.SyntheticPacked(data_lib.DataConfig(cfg.vocab_size, 32, 4)).batch(0)
    opt_cfg = opt_lib.OptimizerConfig(peak_lr=1e-3)
    step = trainer_lib.make_train_step(cfg, enc, opt_cfg)
    runs = {}
    fns = (fused_gemv.fused_gemv, fused_pack_mmt4d.fused_pack_mmt4d, mmt4d.mmt4d,
           attn.flash_prefill_attention, pack.pack)
    before = [f.launches for f in fns]
    for device in ("cpu", dev):
        p = tree.tree_map(lambda t: t.to(device), params)
        runs[device] = step(p, opt_lib.init(p), data_lib.to_torch(batch, device))
    assert [f.launches for f in fns] == before
    grads = trainer_lib.value_and_grad(tree.tree_map(lambda t: t.to(dev), params),
                                       data_lib.to_torch(batch, dev), cfg, enc)[2]
    (p_cpu, _, m_cpu, _), (p_dev, _, m_dev, _) = runs["cpu"], runs[dev]
    torch.testing.assert_close(m_dev["loss"].cpu(), m_cpu["loss"], rtol=1e-5, atol=0)
    torch.testing.assert_close(m_dev["grad_norm"].cpu(), m_cpu["grad_norm"], rtol=1e-4, atol=0)
    lr = float(m_cpu["lr"])
    clip = min(1.0, opt_cfg.clip_norm / float(m_dev["grad_norm"]))
    for (path, a), b, g in zip(tree.leaves_with_path(p_dev), tree.leaves(p_cpu),
                               tree.leaves(grads)):
        g = g.float().abs().cpu()
        small = (g < 1e-6 * g.max()) | (g * clip < 10 * opt_cfg.eps)
        diff = (a.cpu() - b).abs()
        assert float(torch.where(small, 0.0, diff).max()) <= 1e-6, tree.keystr(path)
        assert float(torch.where(small, diff, 0.0).max()) <= 2 * lr, tree.keystr(path)
