"""tensor.pack / tensor.unpack and batch_mmt4d in the port against the JAX
package, on the same numpy inputs, and the packed routes that now pack and
unpack through the pack kernels.

On the CPU the wrappers run their plain versions (ref.pack, ref.unpack,
ref.batch_mmt4d), so these tests pin what the CUDA kernels must reproduce:
- pack and unpack equal JAX's pack_pallas / unpack_pallas (interpret mode)
  bit for bit at the JAX test's shapes, tiles and dtypes, and JAX's
  ref.pack / ref.unpack on ragged shapes (the CUDA pack masks the ragged
  edge itself, where JAX's ops pads first);
- batch_mmt4d within rtol 1e-5, atol 1e-4 of batch_mmt4d_pallas (f32 sums
  of the same exact products in another order), in f32 and bf16;
- encoded_matmul on the "pallas" route with bf16 activations, for bf16,
  int8 (w8a8) and int4 (w4a8) weights, against JAX's: f32 outputs within
  1e-5 (bf16 products are exact in f32), int8 bit for bit, int4 within
  1e-5 of the largest output (JAX sums the exact terms in f32).
The kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.encoding import Phase as JPhase
from repro.kernels import batch_mmt4d as jbatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import to_torch
from repro_torch.core.encoding import Phase
from repro_torch.kernels import batch_mmt4d
from repro_torch.kernels import ops
from repro_torch.kernels import pack

DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}


def _x(shape, dname, seed=0):
    rng = np.random.RandomState(seed)
    if dname == "int8":
        return np.asarray(rng.randint(-127, 127, shape), np.int8)
    return np.asarray(jnp.asarray(rng.randn(*shape).astype(np.float32), DTYPES[dname]))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    if got.dtype == torch.bfloat16:  # compare the raw 16-bit words
        np.testing.assert_array_equal(got.contiguous().view(torch.int16).numpy(),
                                      want.view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# pack / unpack


@pytest.mark.parametrize("shape,tile", [((128, 256), (8, 128)), ((64, 128), (16, 64)),
                                        ((256, 512), (128, 128))])
@pytest.mark.parametrize("dname", ["f32", "bf16", "int8"])
def test_pack_unpack_match_pallas(shape, tile, dname):
    """The JAX test's shapes, tiles and dtypes (tests/test_kernels.py)."""
    x = _x(shape, dname)
    want = jops.pack_pallas(jnp.asarray(x), tile=tile, interpret=True)
    got = pack.pack(to_torch(x, "cpu"), tile)
    _same(got, want)
    _same(pack.unpack(got, shape), jops.unpack_pallas(want, interpret=True))
    assert pack.pack.launches == pack.unpack.launches == 0  # CPU: the plain versions


@pytest.mark.parametrize("shape,tile", [((5, 7), (2, 4)), ((300, 200), (128, 128)),
                                        ((4, 200), (8, 128)), ((130, 13), (128, 8)),
                                        ((37, 100), (16, 64))])
@pytest.mark.parametrize("dname", ["f32", "bf16", "int8"])
def test_pack_unpack_ragged_match_ref(shape, tile, dname):
    """Ragged rows and columns: zero padding on pack, a crop on unpack."""
    x = _x(shape, dname, seed=1)
    want = jref.pack(jnp.asarray(x), tile)
    got = pack.pack(to_torch(x, "cpu"), tile)
    _same(got, want)
    _same(pack.unpack(got, shape), jref.unpack(want, shape))
    # A crop narrower than the padded block, as the ops routes take it.
    crop = (max(1, shape[0] - 1), max(1, shape[1] - 3))
    _same(pack.unpack(got, crop), jref.unpack(want, crop))


def test_wrappers_refuse_other_devices():
    """CPU tensors take the plain versions; anything else but CUDA raises
    (the operand checks of the CUDA path are in tests/test_torch_cuda.py)."""
    meta = dict(device="meta")
    with pytest.raises(RuntimeError, match="runs on cuda"):
        pack.pack(torch.zeros(4, 4, **meta), (2, 2))
    with pytest.raises(RuntimeError, match="runs on cuda"):
        pack.unpack(torch.zeros(1, 1, 2, 2, **meta), (2, 2))
    with pytest.raises(RuntimeError, match="runs on cuda"):
        batch_mmt4d.batch_mmt4d(torch.zeros(1, 1, 1, 4, 8, **meta),
                                torch.zeros(1, 1, 1, 4, 8, **meta))


def test_ops_exports_jax_names():
    assert ops.pack_pallas is pack.pack and ops.unpack_pallas is pack.unpack
    assert ops.batch_mmt4d_pallas is batch_mmt4d.batch_mmt4d


# ---------------------------------------------------------------------------
# batch_mmt4d


@pytest.mark.parametrize("shape", [(2, 2, 3, 16, 8, 8), (3, 4, 2, 8, 32, 16)])
@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_batch_mmt4d_plain_matches_pallas(shape, dname):
    """tests/test_chunked_prefill.py's shapes and block choices."""
    bsz, m1, k1, m0, n0, k0 = shape
    n1 = m1 + 1
    rng = np.random.RandomState(0)
    lhs = np.asarray(jnp.asarray(rng.randn(bsz, m1, k1, m0, k0), DTYPES[dname]))
    rhs = np.asarray(jnp.asarray(rng.randn(bsz, n1, k1, n0, k0), DTYPES[dname]))
    got = batch_mmt4d.batch_mmt4d(to_torch(lhs, "cpu"), to_torch(rhs, "cpu"))
    assert got.dtype == torch.float32 and got.shape == (bsz, m1, n1, m0, n0)
    assert batch_mmt4d.batch_mmt4d.launches == 0
    for blocks in ((1, 1, 1), (m1, 1, k1)):
        want = jbatch.batch_mmt4d_pallas(jnp.asarray(lhs), jnp.asarray(rhs), blocks=blocks,
                                         interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jbatch.batch_mmt4d_ref(lhs, rhs)),
                               rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# encoded_matmul on the "pallas" route, bf16 activations


def _unit(rng, n, k):
    return rng.randn(n, k).astype(np.float32) * k**-0.5


@pytest.mark.parametrize("phase,m", [("decode", 4), ("decode", 20), ("prefill", 130)])
def test_encoded_matmul_pallas_bf16_matches_jax(phase, m):
    rng = np.random.RandomState(m)
    n, k = 300, 200  # ragged N and K: the pack masks the last K tile
    x = np.asarray(jnp.asarray(rng.randn(m, k), jnp.bfloat16))
    w_t = np.asarray(jnp.asarray(_unit(rng, n, k), jnp.bfloat16))
    rhs4 = jops.pack_rhs(jnp.asarray(w_t))
    want = jops.encoded_matmul(jnp.asarray(x), rhs4, n=n, phase=JPhase(phase),
                               backend="pallas", out_dtype=jnp.float32, interpret=True)
    got_rhs4 = ops.pack_rhs(to_torch(w_t, "cpu"))
    _same(got_rhs4, rhs4)
    got = ops.encoded_matmul(to_torch(x, "cpu"), got_rhs4, n=n, phase=Phase(phase),
                             backend="pallas", out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", ["w8a8", "w4a8"])
@pytest.mark.parametrize("phase,m", [("decode", 4), ("decode", 20), ("prefill", 37)])
def test_encoded_matmul_quantized_pallas_bf16_matches_jax(quant, phase, m):
    rng = np.random.RandomState(m + 1)
    n, k = 300, 200
    x = np.asarray(jnp.asarray(rng.randn(m, k), jnp.bfloat16))
    w_t = _unit(rng, n, k)
    kw = dict(n=n, backend="pallas", out_dtype=torch.float32)
    jkw = dict(n=n, phase=JPhase(phase), backend="pallas", out_dtype=jnp.float32,
               interpret=True)
    if quant == "w8a8":
        rhs4, s_w = jops.pack_rhs_q8(jnp.asarray(w_t))
        got_rhs4, got_s = ops.pack_rhs_q8(to_torch(w_t, "cpu"))
        want = jops.encoded_matmul_q8(jnp.asarray(x), rhs4, s_w, **jkw)
        got = ops.encoded_matmul_q8(to_torch(x, "cpu"), got_rhs4, got_s, phase=Phase(phase), **kw)
        _same(got, want)
    else:
        rhs4, s_w = jops.pack_rhs_q4(jnp.asarray(w_t), group=16)
        got_rhs4, got_s = ops.pack_rhs_q4(to_torch(w_t, "cpu"), group=16)
        want = jops.encoded_matmul_q4(jnp.asarray(x), rhs4, s_w, group=16, **jkw)
        got = ops.encoded_matmul_q4(to_torch(x, "cpu"), got_rhs4, got_s, phase=Phase(phase),
                                    group=16, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(want)).max())
    _same(got_rhs4, rhs4)  # the weight pack at load, bit for bit
    _same(got_s, s_w)
