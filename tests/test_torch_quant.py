"""Quantized-weight serving in the port (w8a8, w4a8) against the JAX package,
on the same numpy inputs.

- The quantizers (per-row int8 absmax, per-row int8 MSE clip, per-group
  int4 MSE clip) and the nibble packing give the JAX package's codes and
  scales bit for bit.
- The four kernels' plain versions (what the wrappers run on CPU tensors)
  against the JAX Pallas kernels in interpret mode: the int8 ones exactly
  (an integer sum, then the same f32 epilogue in the same order); the int4
  ones within 1e-5 * max|out| (every term is exact; the port sums exactly in
  float64 and rounds once, JAX sums in f32), at group 16 and 32.
- encoded_matmul_q8/_q4 under every backend, the weight bridge, the reduced
  Llama-3.2-1B's logits (atol = rtol = 1e-4, as tests/test_torch_model.py)
  and the serving engine's tokens (identical to the JAX engine's, JAX on
  its plain "xla" paths) with int8 and int4 weights.
The kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jcfg_registry
from repro.core.encoding import Phase as JPhase
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.kernels import fused_gemv as jgemv
from repro.kernels import mmt4d_q4 as jq4
from repro.kernels import mmt4d_q8 as jq8
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.convert import to_torch
from repro_torch.core import encoding
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import fused_gemv
from repro_torch.kernels import mmt4d_q4
from repro_torch.kernels import mmt4d_q8
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import registry
from repro_torch.models import transformer as T
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.config import EngineConfig

QUANTS = ["int8", "int4"]


def _np(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a):
    return to_torch(np.asarray(a), "cpu")


def _q4_close(got, want):
    """int4 tolerance: 1e-5 of the largest output (the rounding of JAX's f32 sums)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.fixture(autouse=True)
def _clean_quarantine():
    registry.clear_quarantine()
    yield
    registry.clear_quarantine()


# ---------------------------------------------------------------------------
# Quantizers and nibbles: bit for bit


@pytest.mark.parametrize("shape", [(64, 384), (37, 200)])
@pytest.mark.parametrize("name", ["quantize_rows", "quantize_rows_mse"])
def test_int8_quantizers_bit_identical_to_jax(name, shape):
    x = _np(np.random.RandomState(shape[0]), *shape)
    x[3] = 0.0  # an all-zero row takes the 1e-8 floor
    q, s = getattr(ref, name)(_t(x))
    jq, js = getattr(jref, name)(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("shape", [(64, 384), (37, 200)])
def test_int4_quantizer_and_nibbles_bit_identical_to_jax(shape, group):
    """C = 200 is ragged against both groups (the last group is padded)."""
    x = _np(np.random.RandomState(shape[1] + group), *shape)
    q, s = ref.quantize_rows_q4_grouped(_t(x), group=group)
    jq, js = jref.quantize_rows_q4_grouped(jnp.asarray(x), group=group)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    packed = ref.pack_nibbles(q)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jref.pack_nibbles(jq)))
    np.testing.assert_array_equal(ref.unpack_nibbles(packed).numpy(),
                                  np.asarray(jref.unpack_nibbles(jnp.asarray(packed.numpy()))))
    assert torch.equal(ref.unpack_nibbles(packed).to(torch.int8), q)


@pytest.mark.parametrize("group", [16, 32])
def test_pack_rhs_q4_and_q8_bit_identical_to_jax(group):
    w_t = _np(np.random.RandomState(group), 200, 300)  # N and K ragged against 128
    rhs4, s_w = ops.pack_rhs_q8(_t(w_t))
    jrhs4, js_w = jops.pack_rhs_q8(jnp.asarray(w_t))
    np.testing.assert_array_equal(rhs4.numpy(), np.asarray(jrhs4))
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(js_w))
    rhs4_p, s_w4 = ops.pack_rhs_q4(_t(w_t), group=group)
    jrhs4_p, js_w4 = jops.pack_rhs_q4(jnp.asarray(w_t), group=group)
    assert rhs4_p.dtype == torch.uint8 and s_w4.dtype == torch.bfloat16
    assert tuple(s_w4.shape) == (2, 3, 128, 128 // group)
    np.testing.assert_array_equal(rhs4_p.numpy(), np.asarray(jrhs4_p))
    np.testing.assert_array_equal(s_w4.view(torch.int16).numpy(),
                                  np.asarray(js_w4).view(np.int16))


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels (interpret mode)


def _q8_operands(rng, m, n1, k1):
    xq, s_a = jref.quantize_rows(jnp.asarray(_np(rng, m, k1 * 128)))
    rhs4, s_w = jops.pack_rhs_q8(jnp.asarray(_np(rng, n1 * 128, k1 * 128)))
    return np.asarray(xq), np.asarray(s_a), np.asarray(rhs4), np.asarray(s_w)


def _q4_operands(rng, n1, k1, group):
    rhs4_p, s_w4 = jops.pack_rhs_q4(jnp.asarray(_np(rng, n1 * 128, k1 * 128)), group=group)
    return np.asarray(rhs4_p), np.asarray(s_w4)


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("n1,k1", [(1, 1), (2, 3)])
def test_fused_gemv_q8_plain_equals_pallas(m, n1, k1):
    xq, s_a, rhs4, s_w = _q8_operands(np.random.RandomState(m + 7 * k1), m, n1, k1)
    want = jgemv.fused_gemv_q8_pallas(jnp.asarray(xq), jnp.asarray(rhs4),
                                      jnp.asarray(s_a[:, None]), jnp.asarray(s_w), bn1=1,
                                      interpret=True)
    got = fused_gemv.fused_gemv_q8(_t(xq), _t(rhs4), _t(s_a[:, None]), _t(s_w))
    assert got.dtype == torch.float32 and fused_gemv.fused_gemv_q8.launches == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m1,m0", [(1, 8), (3, 8), (2, 5), (1, 128)])
def test_mmt4d_q8_plain_equals_pallas(m1, m0):
    rng = np.random.RandomState(m1 * m0)
    xq, s_a, rhs4, s_w = _q8_operands(rng, m1 * m0, 2, 2)
    lhs4 = np.asarray(jref.pack(jnp.asarray(xq), (m0, 128)))
    sa2 = s_a.reshape(m1, m0)
    want = jq8.mmt4d_q8_pallas(jnp.asarray(lhs4), jnp.asarray(rhs4), jnp.asarray(sa2),
                               jnp.asarray(s_w), blocks=(1, 1, 1), interpret=True)
    got = mmt4d_q8.mmt4d_q8(_t(lhs4), _t(rhs4), _t(sa2), _t(s_w))
    assert got.shape == (m1, 2, m0, 128) and mmt4d_q8.mmt4d_q8.launches == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("m", [1, 5, 8])
def test_fused_gemv_q4_plain_matches_pallas(m, group):
    rng = np.random.RandomState(m + group)
    rhs4_p, s_w4 = _q4_operands(rng, 2, 3, group)
    xq, s_a = (np.asarray(a) for a in jref.quantize_rows(jnp.asarray(_np(rng, m, 384))))
    want = jq4.fused_gemv_q4_pallas(jnp.asarray(xq), jnp.asarray(rhs4_p),
                                    jnp.asarray(s_a[:, None]), jnp.asarray(s_w4), bn1=1,
                                    group=group, interpret=True)
    got = mmt4d_q4.fused_gemv_q4(_t(xq), _t(rhs4_p), _t(s_a[:, None]), _t(s_w4), group)
    assert mmt4d_q4.fused_gemv_q4.launches == 0
    _q4_close(got.numpy(), want)


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("m1,m0", [(1, 8), (3, 8), (2, 5), (1, 128)])
def test_mmt4d_q4_plain_matches_pallas(m1, m0, group):
    rng = np.random.RandomState(m1 * m0 + group)
    rhs4_p, s_w4 = _q4_operands(rng, 2, 2, group)
    xq, s_a = (np.asarray(a) for a in jref.quantize_rows(jnp.asarray(_np(rng, m1 * m0, 256))))
    lhs4 = np.asarray(jref.pack(jnp.asarray(xq), (m0, 128)))
    sa2 = s_a.reshape(m1, m0)
    want = jq4.mmt4d_q4_pallas(jnp.asarray(lhs4), jnp.asarray(rhs4_p), jnp.asarray(sa2),
                               jnp.asarray(s_w4), blocks=(1, 1, 1), group=group,
                               interpret=True)
    got = mmt4d_q4.mmt4d_q4(_t(lhs4), _t(rhs4_p), _t(sa2), _t(s_w4), group)
    assert got.shape == (m1, 2, m0, 128) and mmt4d_q4.mmt4d_q4.launches == 0
    _q4_close(got.numpy(), want)


def test_q4_plain_takes_any_group_and_checks_scale_shape():
    """Group 64 (no CUDA kernel) runs in the plain version on the CPU and
    equals the oracle; scales of another group's shape are refused."""
    rng = np.random.RandomState(64)
    rhs4_p, s_w4 = ops.pack_rhs_q4(_t(_np(rng, 128, 128)), group=64)
    xq, s_a = ref.quantize_rows(_t(_np(rng, 2, 128)))
    got = mmt4d_q4.fused_gemv_q4(xq, rhs4_p, s_a[:, None], s_w4, 64)
    want = ref.unpack(ref.mmt4d_q4(ref.pack(xq, (2, 128)), rhs4_p, s_a[None], s_w4, 64),
                      (2, 128))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    with pytest.raises(ValueError, match="does not match"):
        mmt4d_q4.fused_gemv_q4(xq, rhs4_p, s_a[:, None], s_w4, 32)


# ---------------------------------------------------------------------------
# encoded_matmul_q8 / _q4: every backend, decode and prefill, ragged N and K


@pytest.mark.parametrize("backend", ["xla", "fused", "pallas", "auto"])
@pytest.mark.parametrize("phase,m", [("decode", 4), ("decode", 20), ("prefill", 37)])
def test_encoded_matmul_q8_equals_jax(backend, phase, m):
    rng = np.random.RandomState(m)
    n, k = 300, 200
    x, w_t = _np(rng, m, k), _np(rng, n, k)
    rhs4, s_w = jops.pack_rhs_q8(jnp.asarray(w_t))
    want = jops.encoded_matmul_q8(jnp.asarray(x), rhs4, s_w, n=n, phase=JPhase(phase),
                                  backend=backend, interpret=True)
    got = ops.encoded_matmul_q8(_t(x), _t(rhs4), _t(s_w), n=n, phase=Phase(phase),
                                backend=backend)
    assert got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("backend", ["xla", "fused", "pallas", "auto"])
@pytest.mark.parametrize("phase,m", [("decode", 4), ("decode", 20), ("prefill", 37)])
def test_encoded_matmul_q4_matches_jax(backend, phase, m, group):
    rng = np.random.RandomState(m + group)
    n, k = 300, 200
    x, w_t = _np(rng, m, k), _np(rng, n, k)
    rhs4_p, s_w4 = jops.pack_rhs_q4(jnp.asarray(w_t), group=group)
    want = jops.encoded_matmul_q4(jnp.asarray(x), rhs4_p, s_w4, n=n, phase=JPhase(phase),
                                  group=group, backend=backend, interpret=True)
    got = ops.encoded_matmul_q4(_t(x), _t(rhs4_p), _t(s_w4), n=n, phase=Phase(phase),
                                group=group, backend=backend)
    assert got.shape == (m, n)
    _q4_close(got.numpy(), want)


def test_quant_weight_stream_bytes():
    """Llama-3.2-1B's 16 layers hold P = 973.1 M projection weights: a decode
    step streams 2P bytes in bf16, P plus the f32 channel scales in int8, P/2
    plus one bf16 scale per 16 weights in int4 (0.608 GB)."""
    cfg = cfg_registry.get_config("llama3.2-1b")
    d, f, kvd = cfg.d_model, cfg.d_ff, cfg.num_kv_heads * cfg.head_dim
    shapes = [(d, d), (kvd, d), (kvd, d), (d, d), (f, d), (f, d), (d, f)]
    total = {q: cfg.num_layers * sum(encoding.quant_weight_stream_bytes(n, k, quant=q)
                                     for n, k in shapes)
             for q in ("none", "w8a8", "w4a8")}
    p = cfg.num_layers * sum(n * k for n, k in shapes)
    channels = cfg.num_layers * sum(n for n, _ in shapes)
    assert round(p / 1e6, 1) == 973.1
    assert total["none"] == 2 * p
    assert total["w8a8"] == p + 4 * channels
    assert total["w4a8"] == p // 2 + 2 * (p // 16)
    assert round(total["w4a8"] / 1e9, 3) == 0.608
    with pytest.raises(ValueError, match="quant"):
        encoding.quant_weight_stream_bytes(1, 1, quant="int2")


# ---------------------------------------------------------------------------
# Model: weights converted bit for bit, logits against JAX


def _jenc(wq, **kw):
    return JEncodingConfig(enabled=True, weight_quant=wq, **kw)


@pytest.fixture(scope="module")
def models():
    jcfg = jcfg_registry.get_reduced("llama3.2-1b")
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    out = {}
    for wq in QUANTS:
        jparams = JT.model_init(jax.random.PRNGKey(0), jcfg, _jenc(wq, backend="xla"))
        np_params = jax.tree.map(np.asarray, jparams)
        params = convert.params_from_jax(np_params, cfg, EncodingConfig(weight_quant=wq), "cpu")
        out[wq] = (jcfg, jparams, np_params, cfg, params)
    return out


@pytest.mark.parametrize("wq", QUANTS)
def test_params_from_jax_carries_quantized_leaves_bit_for_bit(models, wq):
    _, _, np_params, cfg, params = models[wq]
    want = {"int8": {"w_q": "int8", "w_scale": "float32"},
            "int4": {"w_q4": "uint8", "w_scale4": "bfloat16"}}[wq]
    seen = set()
    for i, layer in enumerate(params["layers"]):
        for block, projs in layer.items():
            if not isinstance(projs, dict):
                continue
            for name, proj in projs.items():
                if not isinstance(proj, dict) or not set(want) <= set(proj):
                    continue
                for key, dt in want.items():
                    got, src = proj[key], np_params["groups"][0][block][name][key][i]
                    assert str(got.dtype).endswith(dt) and src.dtype.name == dt
                    np.testing.assert_array_equal(got.view(torch.int16 if dt == "bfloat16"
                                                           else got.dtype).numpy(),
                                                  src.view(np.int16) if dt == "bfloat16"
                                                  else src)
                    seen.add(name)
    assert seen >= {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
    with pytest.raises(ValueError, match="weight format"):
        convert.params_from_jax(np_params, cfg, EncodingConfig(), "cpu")


@pytest.mark.parametrize("backend", ["fused", "auto"])
@pytest.mark.parametrize("wq", QUANTS)
def test_quantized_prefill_logits_match_jax(models, wq, backend):
    """Prefill of 2 x 13 tokens through the port's routing (plain versions
    on the CPU) and JAX's Pallas kernels (interpret mode)."""
    jcfg, jparams, _, cfg, params = models[wq]
    jenc = _jenc(wq, backend=backend, attn_backend="xla", interpret=True)
    enc = EncodingConfig(backend=backend, attn_backend="xla", weight_quant=wq)
    toks = np.random.RandomState(0).randint(1, cfg.vocab_size, (2, 13)).astype(np.int32)
    want, _, _ = JT.forward(jparams, {"tokens": jnp.asarray(toks)}, cfg=jcfg, enc=jenc,
                            phase=JPhase.PREFILL, caches=JT.cache_init(jcfg, 2, 16))
    got = T.forward(params, torch.from_numpy(toks), cfg=cfg, enc=enc, phase=Phase.PREFILL,
                    caches=T.cache_init(cfg, 2, 16, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("wq", QUANTS)
def test_quantized_paged_decode_logits_match_jax(models, wq, L):
    """A paged decode step (L = 1: 3 rows, the GEMVs) and a verify-width
    window (L = 4: 12 rows, the packed GEMMs), every row at its own
    position."""
    jcfg, jparams, _, cfg, params = models[wq]
    jenc = _jenc(wq, backend="fused", attn_backend="xla", interpret=True)
    enc = EncodingConfig(backend="fused", attn_backend="xla", weight_quant=wq)
    rng = np.random.RandomState(L)
    b, bs, nb, pages = 3, 4, 6, 19
    kv_shape = (cfg.num_layers, pages, bs, cfg.num_kv_heads, cfg.head_dim)
    k_pool = (0.5 * rng.randn(*kv_shape)).astype(np.float32)
    v_pool = (0.5 * rng.randn(*kv_shape)).astype(np.float32)
    table = rng.permutation(np.arange(1, pages))[: b * nb].reshape(b, nb).astype(np.int32)
    pos = np.array([5, 9, 17], np.int32)
    toks = rng.randint(1, cfg.vocab_size, (b, L)).astype(np.int32)
    jcaches = {"groups": ({"k": jnp.asarray(k_pool), "v": jnp.asarray(v_pool),
                           "table": jnp.asarray(np.broadcast_to(table, (cfg.num_layers, b, nb)))},)}
    want, _, _ = JT.forward(jparams, {"tokens": jnp.asarray(toks)}, cfg=jcfg, enc=jenc,
                            phase=JPhase.DECODE, caches=jcaches, pos=jnp.asarray(pos))
    caches = T.cache_init(cfg, b, nb * bs, cache_mode="paged", block_size=bs,
                          num_pages=pages, device="cpu")
    for i, layer in enumerate(caches["layers"]):
        layer["k"].copy_(torch.from_numpy(k_pool[i]))
        layer["v"].copy_(torch.from_numpy(v_pool[i]))
        layer["table"] = torch.from_numpy(table)
    got = T.forward(params, torch.from_numpy(toks), cfg=cfg, enc=enc, phase=Phase.DECODE,
                    caches=caches, pos=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Engine: the JAX engine's tokens with int8 and int4 weights


def _trace(name, vocab):
    rng = np.random.RandomState(11)
    if name == "mixed":
        return ([rng.randint(1, vocab, n).astype(np.int32) for n in (3, 17, 9, 30, 12, 5)], 6,
                dict(slots=4, max_seq=64, block_size=8))
    if name == "shared_prefix":
        prefix = rng.randint(1, vocab, 16).astype(np.int32)
        return ([np.concatenate([prefix, rng.randint(1, vocab, n).astype(np.int32)])
                 for n in (3, 9, 5, 12, 1)], 5, dict(slots=2, max_seq=64, block_size=8))
    if name == "preemption":
        return ([rng.randint(1, vocab, n).astype(np.int32) for n in (9, 11, 10, 12)], 10,
                dict(slots=3, max_seq=32, block_size=4, pool_pages=12))
    prompts = [np.tile(rng.randint(1, vocab, 3), n).astype(np.int32) for n in (2, 5, 3, 7)]
    prompts += [rng.randint(1, vocab, n).astype(np.int32) for n in (9, 4, 13, 6)]
    extra = dict(spec_decode=True) if name == "spec" else dict(token_budget=16)
    return prompts, 6, dict(slots=4, max_seq=64, block_size=8, **extra)


@pytest.mark.parametrize("trace", ["mixed", "shared_prefix", "preemption", "spec", "budget16"])
@pytest.mark.parametrize("wq", QUANTS)
def test_quantized_engine_tokens_match_jax(models, wq, trace):
    jcfg, jparams, _, cfg, params = models[wq]
    prompts, max_new, config = _trace(trace, cfg.vocab_size)
    jeng = jengine.Engine(jparams, jcfg, _jenc(wq, backend="xla", attn_backend="xla"),
                          **config)
    enc = EncodingConfig(backend="auto", attn_backend="auto", weight_quant=wq)
    eng = engine_lib.Engine(params, cfg, enc, config=EngineConfig(**config), device="cpu")
    for e, req in ((jeng, jengine.Request), (eng, engine_lib.Request)):
        for i, p in enumerate(prompts):
            e.submit(req(uid=i, prompt=p, max_new_tokens=max_new))
    want = {r.uid: r.generated for r in jeng.run()}
    got = {r.uid: r.generated for r in eng.run()}
    assert got == want and all(r.status == "ok" for r in eng.finished)
    eng.audit()
    st, js = eng.stats, jeng.stats
    assert st["pages_in_use"] == 0 and not st["degraded"]
    assert st["weight_quant"] == wq and st["preemptions"] == js["preemptions"]
    assert st["prefix_cache"]["hit_tokens"] == js["prefix_cache"]["hit_tokens"]
    if trace == "shared_prefix":
        assert st["prefix_cache"]["hit_tokens"] > 0
    if trace == "preemption":
        assert st["preemptions"] > 0
    if trace == "spec":
        assert st["spec"]["proposed"] > 0 and eng.dispatches["verify"] > 0
    if trace == "budget16":
        assert st["continuous"] == js["continuous"]


def test_quantized_model_init_matches_packing_the_same_draw():
    """model_init with int8/int4 quantizes the weights it draws (on the
    given device): the same seed's bf16-free f32 draw, packed by
    ops.pack_rhs_q8 / pack_rhs_q4, gives the same leaves."""
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    plain = T.model_init(cfg, EncodingConfig(enabled=False), seed=3, device="cpu")
    for wq, pack, keys in (("int8", ops.pack_rhs_q8, ("w_q", "w_scale")),
                           ("int4", ops.pack_rhs_q4, ("w_q4", "w_scale4"))):
        params = T.model_init(cfg, EncodingConfig(weight_quant=wq), seed=3, device="cpu")
        for proj in ("wq", "wo"):
            got = params["layers"][1]["attn"][proj]
            want = pack(plain["layers"][1]["attn"][proj]["w_t"])
            for key, w in zip(keys, want):
                assert torch.equal(got[key], w), (wq, proj, key)
    with pytest.raises(ValueError, match="weight_quant"):
        EncodingConfig(weight_quant="int2")
