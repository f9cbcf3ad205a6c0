"""The port's kernels (repro_torch.kernels) against the JAX package's Pallas
kernels run in interpret mode, on the same numpy inputs.

On the CPU every wrapper runs its plain PyTorch version, so these tests pin
the arithmetic each CUDA kernel must reproduce.  Tolerance: atol = rtol =
1e-5, for f32 inputs and for bf16 ones (bf16 x bf16 products are exact in
f32 and both sides sum in f32; only the order of the sums differs).  The
kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.encoding import Phase as JPhase
from repro.kernels import attn as jattn
from repro.kernels import fused_gemv as jgemv
from repro.kernels import fused_pack_mmt4d as jgemm
from repro.kernels import mmt4d as jmmt4d
from repro.kernels import mmt4d_gemv as jmmt4d_gemv
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import to_torch
from repro_torch.core.encoding import Phase
from repro_torch.kernels import attn
from repro_torch.kernels import fused_gemv
from repro_torch.kernels import fused_pack_mmt4d
from repro_torch.kernels import mmt4d
from repro_torch.kernels import mmt4d_gemv
from repro_torch.kernels import ops
from repro_torch.kernels import ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# pack / unpack


@pytest.mark.parametrize("shape,tile", [((5, 7), (2, 4)), ((128, 256), (128, 128)),
                                        ((37, 200), (8, 128))])
def test_pack_unpack_exact_against_jax(shape, tile):
    x = _np(np.random.RandomState(0), *shape)
    got = ref.pack(_t(x), tile).numpy()
    want = np.asarray(jref.pack(jnp.asarray(x), tile))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ref.unpack(_t(got), shape).numpy(),
                                  np.asarray(jref.unpack(jnp.asarray(want), shape)))


# ---------------------------------------------------------------------------
# Decode GEMV


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("n1,k1", [(1, 1), (2, 3)])
def test_fused_gemv_plain_matches_pallas(m, n1, k1):
    rng = np.random.RandomState(m + 10 * n1)
    lhs = _np(rng, m, k1 * 128)
    rhs4 = _np(rng, n1, k1, 128, 128) * (k1 * 128) ** -0.5  # unit-scale outputs
    want = jgemv.fused_gemv_pallas(jnp.asarray(lhs), jnp.asarray(rhs4), bn1=1, interpret=True)
    got = fused_gemv.fused_gemv(_t(lhs), _t(rhs4))
    assert got.dtype == torch.float32 and fused_gemv.fused_gemv.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# Prefill GEMM


@pytest.mark.parametrize("m,n1,k1", [(128, 1, 1), (256, 2, 3)])
def test_fused_pack_mmt4d_plain_matches_pallas(m, n1, k1):
    rng = np.random.RandomState(m + n1)
    lhs = _np(rng, m, k1 * 128)
    rhs4 = _np(rng, n1, k1, 128, 128) * (k1 * 128) ** -0.5  # unit-scale outputs
    want = jgemm.fused_pack_mmt4d_pallas(jnp.asarray(lhs), jnp.asarray(rhs4),
                                         blocks=(1, 1, 1), interpret=True)
    got = fused_pack_mmt4d.fused_pack_mmt4d(_t(lhs), _t(rhs4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# Packed GEMM and packed decode GEMV


def _packed_operands(rng, m1, m0, n1, k1, dtype):
    """Packed lhs4 / rhs4 as numpy arrays in `dtype` ("f32" or "bf16"),
    unit-scale outputs."""
    lhs4 = _np(rng, m1, k1, m0, 128)
    rhs4 = _np(rng, n1, k1, 128, 128) * (k1 * 128) ** -0.5
    if dtype == "bf16":
        lhs4, rhs4 = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (lhs4, rhs4))
    return lhs4, rhs4


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m1", [1, 3])
@pytest.mark.parametrize("m0", [8, 128])
def test_mmt4d_plain_matches_pallas(m0, m1, dtype):
    lhs4, rhs4 = _packed_operands(np.random.RandomState(m0 + m1), m1, m0, 2, 2, dtype)
    want = jmmt4d.mmt4d_pallas(jnp.asarray(lhs4), jnp.asarray(rhs4), blocks=(1, 1, 1),
                               interpret=True)
    got = mmt4d.mmt4d(to_torch(lhs4, "cpu"), to_torch(rhs4, "cpu"))
    assert got.dtype == torch.float32 and got.shape == (m1, 2, m0, 128)
    assert mmt4d.mmt4d.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m0", [1, 4, 8])
def test_mmt4d_gemv_plain_matches_pallas(m0, dtype):
    lhs4, rhs4 = _packed_operands(np.random.RandomState(m0), 1, m0, 3, 2, dtype)
    want = jmmt4d_gemv.mmt4d_gemv_pallas(jnp.asarray(lhs4), jnp.asarray(rhs4), bn1=1,
                                         interpret=True)
    got = mmt4d_gemv.mmt4d_gemv(to_torch(lhs4, "cpu"), to_torch(rhs4, "cpu"))
    assert got.shape == (1, 3, m0, 128) and mmt4d_gemv.mmt4d_gemv.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mmt4d_gemv_takes_one_row_block():
    with pytest.raises(AssertionError, match="M1=2"):
        mmt4d_gemv.mmt4d_gemv(torch.zeros(2, 1, 8, 128), torch.zeros(1, 1, 128, 128))


# ---------------------------------------------------------------------------
# encoded_matmul: ragged M, K padding, every backend and phase


@pytest.mark.parametrize("backend", ["reference", "xla", "fused"])
@pytest.mark.parametrize("phase,m", [("decode", 1), ("decode", 5), ("prefill", 37)])
def test_encoded_matmul_matches_jax(backend, phase, m):
    rng = np.random.RandomState(m)
    n, k = 200, 72  # N and K both ragged against the 128 pack tile
    x = _np(rng, m, k)
    w_t = _np(rng, n, k)
    rhs4 = np.asarray(jops.pack_rhs(jnp.asarray(w_t)))
    want = jops.encoded_matmul(jnp.asarray(x), jnp.asarray(rhs4), n=n,
                               phase=JPhase(phase), backend=backend, interpret=True)
    got = ops.encoded_matmul(_t(x), ops.pack_rhs(_t(w_t)), n=n, phase=Phase(phase),
                             backend=backend)
    np.testing.assert_array_equal(ops.pack_rhs(_t(w_t)).numpy(), rhs4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("phase,m", [("decode", 4), ("decode", 20), ("prefill", 130)])
def test_encoded_matmul_pallas_matches_jax(phase, m):
    """backend="pallas": the packed GEMV for one decode row block (M=4), the
    packed GEMM for more decode rows (M=20: three 8-row blocks) and prefill."""
    rng = np.random.RandomState(m)
    n, k = 300, 200
    x, w_t = _np(rng, m, k), _np(rng, n, k) * k**-0.5  # unit-scale outputs
    rhs4 = np.asarray(jops.pack_rhs(jnp.asarray(w_t)))
    want = jops.encoded_matmul(jnp.asarray(x), jnp.asarray(rhs4), n=n, phase=JPhase(phase),
                               backend="pallas", interpret=True)
    got = ops.encoded_matmul(_t(x), _t(rhs4), n=n, phase=Phase(phase), backend="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encoded_matmul_pallas_backend_is_the_next_slice():
    """The packed path serves: 40 decode rows route to the packed GEMM and
    agree with the oracle path."""
    rng = np.random.RandomState(40)
    x, w_t = _t(_np(rng, 40, 128)), _t(_np(rng, 128, 128))
    rhs4 = ops.pack_rhs(w_t)
    got = ops.encoded_matmul(x, rhs4, n=128, phase=Phase.DECODE, backend="pallas")
    want = ops.encoded_matmul(x, rhs4, n=128, phase=Phase.DECODE, backend="xla")
    torch.testing.assert_close(got, want, **TOL)


# ---------------------------------------------------------------------------
# Flash prefill


@pytest.mark.parametrize("h,kv", [(4, 1), (4, 2)])
@pytest.mark.parametrize("sq,sk,q_offset", [(13, 13, 0), (7, 20, 13), (16, 16, 0)])
def test_flash_prefill_plain_matches_pallas(h, kv, sq, sk, q_offset):
    rng = np.random.RandomState(sq + sk + h * kv)
    b, d = 2, 16
    q, k, v = _np(rng, b, sq, h, d), _np(rng, b, sk, kv, d), _np(rng, b, sk, kv, d)
    want = jattn.flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=q_offset,
        q_chunk=8, kv_chunk=8, interpret=True,
    )
    got = attn.flash_prefill_attention(_t(q), _t(k), _t(v), q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_prefill_rows_without_keys_are_zero():
    """A query before every key (non-causal window pushed past all keys)
    gets 0, not NaN."""
    q = torch.randn(1, 3, 2, 16)
    k = torch.randn(1, 4, 1, 16)
    out = attn.flash_prefill_attention(q, k, k, causal=True, window=1, q_offset=10)
    assert torch.equal(out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# Paged decode


def _paged_case(rng, L, b=3, h=4, kv=1, d=16, bs=4, nb=6, pages=14):
    nb = max(nb, -(-(L + 9) // bs))  # room for the window of every row
    q = _np(rng, b, L, h, d)
    k_pool = _np(rng, pages, bs, kv, d)
    v_pool = _np(rng, pages, bs, kv, d)
    table = rng.randint(1, pages, (b, nb)).astype(np.int32)
    table[1, :2] = table[0, :2]  # rows 0 and 1 share their two leading pages
    pos = np.array([1, 9, nb * bs - L], np.int32)  # ragged, last row fills its table
    return q, k_pool, v_pool, table, pos


@pytest.mark.parametrize("L", [1, 3, 16, 64])
def test_paged_decode_plain_matches_pallas(L):
    """G = 4, so L = 16 and 64 make 64 and 256 query rows per (row, kv head):
    past the 32 rows one block of the CUDA kernel holds."""
    q, k_pool, v_pool, table, pos = _paged_case(np.random.RandomState(L), L)
    want = jattn.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(table),
        jnp.asarray(pos), interpret=True,
    )
    got = attn.paged_decode_attention(_t(q), _t(k_pool), _t(v_pool), _t(table), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_decode_idle_slot_on_scratch_page_is_finite():
    """An idle slot decodes at pos 0 against scratch page 0 and stays finite."""
    q = torch.randn(2, 1, 4, 16)
    pool = torch.zeros(5, 4, 1, 16)
    table = torch.zeros(2, 3, dtype=torch.int32)
    out = attn.paged_decode_attention(q, pool, pool, table, torch.zeros(2, dtype=torch.int32))
    assert torch.isfinite(out).all()
