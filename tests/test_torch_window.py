"""Sliding-window ring caches in the port (models/layers.py: the ring write
and read) against the JAX package, on the reduced Mixtral-8x22B with
capacity 8.0 (no MoE drops, so a cached and an uncached forward route the
same rows) and a window of 6.

The ring holds S_c = min(max_seq, window) slots and position p lives in
slot p mod S_c.  JAX's ring prefill of a prompt longer than the ring and
not a multiple of it writes its last S_c keys to slots 0..S_c-1 instead, so
its next decodes read and overwrite the wrong keys; there the port follows
JAX's uncached windowed forward, and this file keeps the JAX fault on
record.  f32 throughout; logits to 1e-4, as in tests/test_torch_archs.py."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jcfg_registry
from repro.core.encoding import Phase as JPhase
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import engine as engine_lib

TOL = dict(rtol=1e-4, atol=1e-4)
WINDOW = 6
TOTAL = 16  # prompt + decoded tokens, far past the window
JENC = JEncodingConfig(enabled=True, backend="xla", attn_backend="xla")
ENC = EncodingConfig(backend="fused", attn_backend="pallas")


@functools.lru_cache(maxsize=None)
def _model(window: int = WINDOW):
    kw = dict(capacity_factor=8.0, sliding_window=window)
    jcfg = jcfg_registry.get_reduced("mixtral-8x22b", **kw)
    cfg = cfg_registry.get_reduced("mixtral-8x22b", **kw)
    init = jax.jit(functools.partial(JT.model_init, cfg=jcfg, enc=JENC))
    jparams = init(jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, ENC, "cpu")
    return jcfg, jparams, cfg, params


def _tokens(b=1, seed=1):
    return np.random.RandomState(seed).randint(1, 256, (b, TOTAL)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_fns(jcfg):
    def prefill(params, toks, caches):
        return JT.forward(params, {"tokens": toks}, cfg=jcfg, enc=JENC, phase=JPhase.PREFILL,
                          caches=caches)

    def decode(params, toks, caches, pos):
        return JT.forward(params, {"tokens": toks}, cfg=jcfg, enc=JENC, phase=JPhase.DECODE,
                          caches=caches, pos=pos)

    return jax.jit(prefill), jax.jit(decode)


def _jax_uncached(jcfg, jparams, toks):
    """JAX's windowed forward over every token at once: the reference."""
    prefill, _ = _jax_fns(jcfg)
    logits, _, _ = prefill(jparams, jnp.asarray(toks), None)
    return np.asarray(logits)


def _jax_cached(jcfg, jparams, toks, sp):
    """JAX's ring path: prefill toks[:, :sp], then decode one token at a time;
    the decode logits of positions sp .. TOTAL-1 and the caches after each."""
    prefill, decode = _jax_fns(jcfg)
    caches = JT.cache_init(jcfg, toks.shape[0], max_seq=TOTAL)
    _, caches, _ = prefill(jparams, jnp.asarray(toks[:, :sp]), caches)
    out, rings = [], []
    for i in range(sp, TOTAL):
        logits, caches, _ = decode(jparams, jnp.asarray(toks[:, i:i + 1]), caches,
                                   jnp.asarray(i, jnp.int32))
        out.append(np.asarray(logits[:, 0]))
        rings.append(jax.tree.map(np.asarray, caches))
    return np.stack(out, 1), rings


def _port_cached(cfg, params, toks, sp, pos_vector=False):
    """The port's ring path, as _jax_cached; `pos_vector` decodes with a (B,)
    position (the vectorized engine's) instead of a shared int."""
    caches = T.cache_init(cfg, toks.shape[0], TOTAL, device="cpu")
    assert caches["layers"][0]["k"].shape[1] == min(TOTAL, cfg.sliding_window)
    out, rings = [], []
    with torch.no_grad():
        T.forward(params, torch.from_numpy(toks[:, :sp]), cfg=cfg, enc=ENC, phase=Phase.PREFILL,
                  caches=caches)
        for i in range(sp, TOTAL):
            pos = torch.full((toks.shape[0],), i) if pos_vector else i
            logits = T.forward(params, torch.from_numpy(toks[:, i:i + 1]), cfg=cfg, enc=ENC,
                               phase=Phase.DECODE, caches=caches, pos=pos)
            out.append(logits[:, 0].numpy())
            rings.append([{n: t.clone().numpy() for n, t in lc.items()}
                          for lc in caches["layers"]])
    return np.stack(out, 1), rings


def _ring_equal(jring, ring):
    """JAX's stacked (layers, B, S_c, KV, D) caches == the port's per layer."""
    (group,) = jring["groups"]
    for i, layer in enumerate(ring):
        for name in ("k", "v"):
            np.testing.assert_allclose(layer[name], group[name][i], **TOL)


@pytest.mark.parametrize("pos_vector", [False, True], ids=["shared_pos", "row_pos"])
@pytest.mark.parametrize("sp", [4, 6])
def test_ring_decode_past_the_window_matches_jax(sp, pos_vector):
    """Prompts within the window, then decode to position 15 (two wraps of a
    6-slot ring): logits and every ring slot equal JAX's cached path, the
    ring read (layers.attention_decode) equals JAX's attention_decode on
    each step's ring, and the logits equal JAX's uncached windowed
    forward."""
    jcfg, jparams, cfg, params = _model()
    toks = _tokens(b=2)
    got, rings = _port_cached(cfg, params, toks, sp, pos_vector)
    want, jrings = _jax_cached(jcfg, jparams, toks, sp)
    np.testing.assert_allclose(got, want, **TOL)
    q = np.random.RandomState(sp).randn(2, 1, cfg.num_heads, cfg.head_dim).astype(np.float32)
    for i, (jring, ring) in enumerate(zip(jrings, rings)):
        _ring_equal(jring, ring)
        pos = sp + i
        k, v = ring[0]["k"], ring[0]["v"]
        read = L.attention_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  torch.full((2,), pos) if pos_vector else pos, WINDOW)
        jread = JL.attention_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    pos=jnp.full((2,), pos) if pos_vector else jnp.asarray(pos),
                                    window=WINDOW)
        np.testing.assert_allclose(read.numpy(), np.asarray(jread), **TOL)
    np.testing.assert_allclose(got, _jax_uncached(jcfg, jparams, toks)[:, sp:], **TOL)


@pytest.mark.parametrize("sp", [8, 12])
def test_ring_prefill_longer_than_the_window(sp):
    """Prompts of 8 and 12 under a 6-slot ring.  The port writes position p
    to slot p mod 6 and matches JAX's uncached windowed forward at both.
    JAX's cached path agrees at 12 (a multiple of the ring) and not at 8,
    where its prefill wrote positions 2..7 to slots 0..5: the reference
    fault this port does not copy."""
    jcfg, jparams, cfg, params = _model()
    toks = _tokens()
    want = _jax_uncached(jcfg, jparams, toks)[:, sp:]
    got, rings = _port_cached(cfg, params, toks, sp)
    np.testing.assert_allclose(got, want, **TOL)
    jgot, _ = _jax_cached(jcfg, jparams, toks, sp)
    if sp % WINDOW == 0:
        np.testing.assert_allclose(jgot, want, **TOL)
    else:
        assert np.abs(jgot - want).max() > 0.1


def test_ring_prefill_write_rolls_onto_slots():
    """_prefill_write keeps the last S_c positions, each at slot p mod S_c,
    from a prompt longer than the ring, a chunk at an offset, and a short
    chunk that wraps."""
    s_c = 6
    for pos, s in ((0, 8), (0, 12), (0, 4), (9, 6), (4, 5), (7, 13)):
        cache = {"k": torch.full((1, s_c, 1, 1), -1.0), "v": torch.full((1, s_c, 1, 1), -1.0)}
        kv = torch.arange(pos, pos + s, dtype=torch.float32).reshape(1, s, 1, 1)
        L._prefill_write(cache, kv, kv, pos, window=s_c)
        for p in range(max(pos, pos + s - s_c), pos + s):
            assert cache["k"][0, p % s_c, 0, 0] == p and cache["v"][0, p % s_c, 0, 0] == p


def test_attn_cache_init_ring_width_matches_jax():
    for window, max_seq in ((6, 16), (6, 4), (0, 16)):
        kw = dict(sliding_window=window)
        jc = JL.attn_cache_init(jcfg_registry.get_reduced("mixtral-8x22b", **kw), 2, max_seq)
        c = L.attn_cache_init(cfg_registry.get_reduced("mixtral-8x22b", **kw), 2, max_seq,
                              device="cpu")
        assert tuple(c["k"].shape) == jc["k"].shape and tuple(c["v"].shape) == jc["v"].shape


@pytest.mark.parametrize("chunk", [6, 8])
@pytest.mark.parametrize("s", [12, 14])
def test_chunked_prefill_equals_single_shot_under_a_window(s, chunk):
    """make_chunked_prefill_step with chunks of at least the window: the same
    last logits as a single-shot prefill (and as JAX's, whose prefill logits
    are right at any length), the same ring, and the same next decode."""
    jcfg, jparams, cfg, params = _model()
    toks = _tokens()[:, :s]
    c1 = T.cache_init(cfg, 1, TOTAL, device="cpu")
    c2 = T.cache_init(cfg, 1, TOTAL, device="cpu")
    with torch.no_grad():
        l1 = T.forward(params, torch.from_numpy(toks), cfg=cfg, enc=ENC, phase=Phase.PREFILL,
                       caches=c1, last_logits_only=True)
    l2, c2 = engine_lib.make_chunked_prefill_step(cfg, ENC, chunk=chunk)(
        params, torch.from_numpy(toks), c2)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), **TOL)
    np.testing.assert_allclose(l1.numpy()[:, 0], _jax_uncached(jcfg, jparams, toks)[:, -1], **TOL)
    for a, b in zip(c1["layers"], c2["layers"]):
        np.testing.assert_allclose(b["k"].numpy(), a["k"].numpy(), **TOL)
        np.testing.assert_allclose(b["v"].numpy(), a["v"].numpy(), **TOL)
    nxt = torch.from_numpy(_tokens()[:, s:s + 1])
    with torch.no_grad():
        d1, d2 = (T.forward(params, nxt, cfg=cfg, enc=ENC, phase=Phase.DECODE, caches=c,
                            pos=s) for c in (c1, c2))
    np.testing.assert_allclose(d2.numpy(), d1.numpy(), **TOL)
    np.testing.assert_allclose(d1.numpy()[:, 0],
                               _jax_uncached(jcfg, jparams, _tokens()[:, :s + 1])[:, -1], **TOL)


def test_chunked_prefill_refuses_a_chunk_below_the_window():
    cfg = cfg_registry.get_reduced("mixtral-8x22b", sliding_window=16)
    jcfg = jcfg_registry.get_reduced("mixtral-8x22b", sliding_window=16)
    for mod, c, e in ((engine_lib, cfg, ENC), (jengine, jcfg, JENC)):
        with pytest.raises(ValueError, match="sliding_window <= chunk: window 16 > chunk 8"):
            mod.make_chunked_prefill_step(c, e, chunk=8)
        mod.make_chunked_prefill_step(c, e, chunk=16)
        mod.make_chunked_prefill_step(c, e, chunk=0)


def test_chunked_prefill_full_attention_matches_jax():
    """Window 0 (Llama-3.2-1B reduced): the port's chunked prefill == JAX's."""
    jcfg = jcfg_registry.get_reduced("llama3.2-1b")
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    jparams = JT.model_init(jax.random.PRNGKey(2), jcfg, JENC)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, ENC, "cpu")
    toks = np.random.RandomState(3).randint(1, 256, (2, 20)).astype(np.int32)
    jl, _ = jengine.make_chunked_prefill_step(jcfg, JENC, chunk=8)(
        jparams, jnp.asarray(toks), JT.cache_init(jcfg, 2, max_seq=24))
    l, caches = engine_lib.make_chunked_prefill_step(cfg, ENC, chunk=8)(
        params, torch.from_numpy(toks), T.cache_init(cfg, 2, 24, device="cpu"))
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), **TOL)
