"""The dense KV cache of the port against the JAX package, on the CPU: the
dense decode kernel's plain version against the Pallas kernel in interpret
mode (full attention with ragged and scalar positions, L = 4 verify
windows, ring windows at wrapped positions, kv8/kv4 caches), the paged and
dense plain versions equal bit for bit through an identity page table, the
EngineConfig.resolve downgrades against JAX's, and the serving engine on
the dense cache (vectorized and grouped decode, spec decode, the token
budget) against the JAX engine on the reduced Llama-3.2-1B with converted
weights.

Tolerance: attention outputs atol = rtol = 1e-5 (f32 inputs, f32 sums in
another order); the identity-table comparison is exact.  Tokens: equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jcfg_registry
from repro.core import encoding as jencoding
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.kernels import attn as jattn
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro.serving.config import EngineConfig as JEngineConfig
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core import encoding
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import attn
from repro_torch.kernels import registry
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.config import EngineConfig

TOL = dict(rtol=1e-5, atol=1e-5)
JENC = JEncodingConfig(enabled=True, backend="fused", attn_backend="pallas", interpret=True)
ENC = EncodingConfig(enabled=True, backend="fused", attn_backend="pallas")
JXLA = JEncodingConfig(enabled=True, backend="xla", attn_backend="xla")
AUTO = EncodingConfig(backend="auto", attn_backend="auto")


def _t(a):
    return torch.from_numpy(np.array(a))


def _cache(rng, kv, b, s_c, kvh, d):
    """K/V caches (and their scales, for kv8/kv4) quantized by the JAX codec."""
    k, v = (rng.randn(b, s_c, kvh, d).astype(np.float32) for _ in range(2))
    if kv == "bf16":
        return k, v, None, None
    lay = jencoding.kv_layout(kv)
    (kq, ks), (vq, vs) = lay.quantize(jnp.asarray(k)), lay.quantize(jnp.asarray(v))
    return tuple(np.asarray(a) for a in (kq, vq, ks, vs))


# ---------------------------------------------------------------------------
# The dense decode kernel's plain version


@pytest.mark.parametrize("case", [
    # (kv, L, window, S_c, pos): pos None = a scalar position
    ("bf16", 1, 0, 40, [3, 17, 39]),
    ("bf16", 4, 0, 40, [0, 20, 36]),
    ("bf16", 1, 0, 40, None),
    ("bf16", 1, 8, 24, [5, 30, 61]),    # ring: one row in its first window, two wrapped
    ("bf16", 1, 8, 8, [3, 8, 19]),      # ring as the engine sizes it (S_c = window)
    ("kv8", 1, 0, 40, [3, 17, 39]),
    ("kv8", 4, 0, 40, [0, 20, 36]),
    ("kv4", 1, 0, 40, [3, 17, 39]),
    ("kv4", 4, 0, 40, None),
])
@pytest.mark.parametrize("h,kvh", [(4, 1), (8, 2)])
def test_dense_decode_plain_matches_pallas(case, h, kvh):
    kv, L, window, s_c, pos = case
    rng = np.random.RandomState(s_c + L + h)
    b, d = 3, 16
    q = rng.randn(b, L, h, d).astype(np.float32)
    k, v, ks, vs = _cache(rng, kv, b, s_c, kvh, d)
    posv = np.int32(11) if pos is None else np.array(pos, np.int32)
    scales = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    want = jattn.dense_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(posv), window=window,
        kv_chunk=8, kv_quant=kv, interpret=True,
        **{n: jnp.asarray(a) for n, a in scales.items()},
    )
    got = attn.dense_decode_attention(_t(q), _t(k), _t(v), _t(posv), window=window,
                                      kv_quant=kv, **{n: _t(a) for n, a in scales.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_decode_refuses_what_jax_refuses():
    q = torch.zeros(1, 2, 4, 16)
    cache = torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError, match="window"):
        attn.dense_decode_attention(q, cache, cache, 3, window=4)  # ring with L > 1
    scale = torch.ones(1, 8, 1, 1)
    q8 = cache.to(torch.int8)
    with pytest.raises(ValueError, match="window"):
        attn.dense_decode_attention(q[:, :1], q8, q8, 3, window=4, k_scale=scale,
                                    v_scale=scale, kv_quant="kv8")


@pytest.mark.parametrize("kv,dtype", [("bf16", torch.float32), ("bf16", torch.bfloat16),
                                      ("kv8", torch.float32), ("kv4", torch.bfloat16)])
@pytest.mark.parametrize("L", [1, 4])
def test_identity_table_paged_equals_dense_bit_for_bit(kv, dtype, L):
    """A pool whose pages are the dense cache's blocks, read through the
    identity table, gives the dense version's output bit for bit."""
    rng = np.random.RandomState(L)
    b, h, kvh, d, bs, nb = 3, 8, 2, 16, 4, 6
    s_c = nb * bs
    q = _t(rng.randn(b, L, h, d).astype(np.float32)).to(dtype)
    k, v, ks, vs = (None if a is None else _t(a) for a in _cache(rng, kv, b, s_c, kvh, d))
    if kv == "bf16":
        k, v = k.to(dtype), v.to(dtype)
    pos = torch.tensor([1, 13, s_c - L], dtype=torch.int32)
    table = torch.arange(b * nb, dtype=torch.int32).reshape(b, nb)

    def pages(a):
        return None if a is None else a.reshape(b * nb, bs, *a.shape[2:])

    dense = attn.dense_decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs, kv_quant=kv)
    paged = attn.paged_decode_attention(q, pages(k), pages(v), table, pos, k_scale=pages(ks),
                                        v_scale=pages(vs), kv_quant=kv)
    assert dense.dtype == dtype and torch.equal(paged, dense)


# ---------------------------------------------------------------------------
# EngineConfig.resolve


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(cache_mode="dense"),
    dict(decode_mode="grouped"),
    dict(decode_mode="grouped", spec_decode=True, token_budget=32),
    dict(cache_mode="dense", kv_quant="kv8"),
    dict(decode_mode="grouped", kv_quant="kv4"),
    dict(kv_quant="kv4", spec_decode=True),
    dict(sample="temperature", spec_decode=True, token_budget=16),
    dict(spec_decode=True, draft_k=0),
])
def test_resolve_downgrades_match_jax(window, kw):
    cfg = cfg_registry.get_reduced("llama3.2-1b", sliding_window=window)
    jcfg = jcfg_registry.get_reduced("llama3.2-1b", sliding_window=window)
    got = EngineConfig(**kw).resolve(cfg)
    want = JEngineConfig(**kw).resolve(jcfg)
    assert got.downgrades == want.downgrades
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


# ---------------------------------------------------------------------------
# The serving engine on the dense cache


@pytest.fixture(scope="module")
def model():
    jcfg = jcfg_registry.get_reduced("llama3.2-1b")
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    jparams = JT.model_init(jax.random.PRNGKey(0), jcfg, JENC)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, ENC, "cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(autouse=True)
def _clean_quarantine():
    registry.clear_quarantine()
    yield
    registry.clear_quarantine()


@pytest.mark.parametrize("mode", ["vectorized", "grouped", "spec", "budget"])
def test_engine_dense_tokens_match_jax(model, mode):
    """Vectorized and grouped decode against the JAX engine's Pallas kernels
    in interpret mode; spec decode and the token budget against its plain
    paths, as its own harnesses run them."""
    jcfg, jparams, cfg, params = model
    rng = np.random.RandomState(21)
    vocab = cfg.vocab_size
    prompts = [np.tile(rng.randint(1, vocab, 3), n).astype(np.int32) for n in (2, 5, 3, 7)]
    prompts += [rng.randint(1, vocab, n).astype(np.int32) for n in (9, 4, 13, 6)]
    config = dict(slots=4, max_seq=64, cache_mode="dense")
    jenc, enc = JENC, ENC
    if mode == "grouped":  # the paged default resolves to the dense cache
        config = dict(slots=4, max_seq=64, decode_mode="grouped")
    elif mode == "spec":
        config, jenc, enc = dict(config, spec_decode=True), JXLA, AUTO
    elif mode == "budget":
        config, jenc, enc = dict(config, token_budget=16), JXLA, AUTO
    jeng = jengine.Engine(jparams, jcfg, jenc, **config)
    eng = engine_lib.Engine(params, cfg, enc, config=EngineConfig(**config), device="cpu")
    for e, req in ((jeng, jengine.Request), (eng, engine_lib.Request)):
        for i, p in enumerate(prompts):
            e.submit(req(uid=i, prompt=p, max_new_tokens=6))
    want = {r.uid: r.generated for r in jeng.run()}
    got = {r.uid: r.generated for r in eng.run()}
    assert got == want and all(r.status == "ok" for r in eng.finished)
    js, s = jeng.stats, eng.stats
    assert set(s) - {"dispatches"} == set(js)
    for key in ("cache_mode", "decode_mode", "kv_quant"):
        assert s[key] == js[key], key
    if jenc is JENC:
        assert s["attn_backend"] == js["attn_backend"] == "pallas"
    assert s["cache_mode"] == "dense" and not s["degraded"]
    if mode == "grouped":
        assert s["config_downgrades"] == js["config_downgrades"] == ["cache_mode:dense(grouped_decode)"]
        assert eng.dispatches["decode"] > eng.stats["steps"] - eng.dispatches["prefill"]
    if mode == "spec":
        assert s["spec"]["proposed"] > 0 and eng.dispatches["verify"] > 0
        for key in ("steps", "proposed", "accepted", "committed"):
            assert s["spec"][key] == js["spec"][key], key
    if mode == "budget":
        assert s["continuous"] == js["continuous"]


def test_slot_gather_and_merge():
    layer = {"k": torch.arange(4.0).reshape(4, 1, 1, 1).expand(4, 3, 1, 2).clone()}
    caches = {"layers": [layer, {"k": layer["k"].clone()}]}
    part = engine_lib.slot_gather(caches, [2, 0])
    assert part["layers"][0]["k"][:, 0, 0, 0].tolist() == [2.0, 0.0]
    part["layers"][1]["k"] += 10
    engine_lib.slot_merge(caches, part, [3], [1])
    assert caches["layers"][1]["k"][:, 0, 0, 0].tolist() == [0.0, 1.0, 2.0, 10.0]
    assert caches["layers"][0]["k"][:, 0, 0, 0].tolist() == [0.0, 1.0, 2.0, 0.0]
    assert engine_lib.slot_slice(caches, 1)["layers"][0]["k"].shape == (1, 3, 1, 2)
