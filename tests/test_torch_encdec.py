"""The encoder-decoder family in the port (Whisper-tiny: models/blocks.py
enc_attn and encdec_attn, transformer._run_encoder, the cross cache) against
the JAX package, on the reduced config (2 encoder and 2 decoder layers, d
64, 4 heads of 16, 8 frames) with JAX's own weights carried across by
convert.params_from_jax.

Frames and tokens are drawn from a seed with numpy (frames N(0, 0.1^2), as
JAX's tests/test_archs.py).  JAX runs on two backends: "xla" (its plain
paths: the chunked reference for cross attention, attention_decode) and
"pallas" (its fused and flash kernels in interpret mode; cross attention
stays on its reference there, as JAX routes it).  The port runs registry
routing ("fused" projections, "pallas" attention), the kernels' plain
versions on the CPU.  Tolerances:
  * f32: encoder output, prefill logits, the caches and cached-decode
    logits within 1e-4 abs (and rel), the port's tolerance elsewhere: the
    same operations, f32 sums in another order;
  * greedy tokens: identical, in f32 and in bf16;
  * converted weights: bit for bit;
  * bf16 (JAX compiled with XLA's excess precision off, so that a bf16 cast
    rounds where the program says): logits within 1e-4 abs (and rel), the
    f32 bound: the bf16 hidden states agree with JAX's, and the logits of
    the untied head, f32 sums of bf16 products, differ only in the order of
    their sums (4.8e-7 at most here).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jcfg_registry
from repro.core.encoding import Phase as JPhase
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import attn
from repro_torch.models import transformer as T
from repro_torch.serving import engine as engine_lib

ARCH = "whisper-tiny"
TOL = dict(rtol=1e-4, atol=1e-4)
STRICT = {"xla_allow_excess_precision": False}
ENC = EncodingConfig(enabled=True, backend="fused", attn_backend="pallas")
JENCS = {
    "xla": JEncodingConfig(enabled=True, backend="xla", attn_backend="xla"),
    "pallas": JEncodingConfig(enabled=True, backend="fused", attn_backend="pallas",
                              interpret=True),
}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@functools.lru_cache(maxsize=None)
def _model(dtype: str = "float32"):
    jcfg = jcfg_registry.get_reduced(ARCH, dtype=dtype)
    cfg = cfg_registry.get_reduced(ARCH, dtype=dtype)
    jparams = jax.jit(functools.partial(JT.model_init, cfg=jcfg, enc=JENCS["xla"]))(
        jax.random.PRNGKey(3))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, EncodingConfig(),
                                     "cpu")
    return jcfg, jparams, cfg, params


def _frames(cfg, b, seed=0):
    rng = np.random.RandomState(seed)
    return (0.1 * rng.randn(b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def _tokens(b, s, seed=1):
    return np.random.RandomState(seed).randint(1, 256, (b, s)).astype(np.int32)


def _jax_fns(jcfg, jenc, options=None):
    """Jitted JAX prefill and decode through JT.forward, returning (logits,
    caches)."""
    def prefill(p, batch, caches, idx):
        return JT.forward(p, batch, cfg=jcfg, enc=jenc, phase=JPhase.PREFILL, caches=caches,
                          logits_idx=idx)[:2]

    def decode(p, tok, caches, pos):
        return JT.forward(p, {"tokens": tok}, cfg=jcfg, enc=jenc, phase=JPhase.DECODE,
                          caches=caches, pos=pos)[:2]

    return (jax.jit(prefill, compiler_options=options),
            jax.jit(decode, compiler_options=options))


def jax_greedy(jcfg, jparams, jenc, prompts, *, max_new, max_seq, extra, options=None):
    """JAX's tokens by the algorithm of transformer.greedy_generate: one
    right-padded prefill (`extra`: {"frames": ...} or {"patches": ...}), the
    first token from each row's last prompt position, then cached decode
    steps of one token a row at (B,) positions."""
    lens = np.array([len(p) for p in prompts])
    toks = np.zeros((len(prompts), lens.max()), np.int32)
    for row, p in enumerate(prompts):
        toks[row, :len(p)] = p
    off = extra["patches"].shape[1] if "patches" in extra else 0
    pos = jnp.asarray(off + lens, jnp.int32)
    prefill, decode = _jax_fns(jcfg, jenc, options)
    caches = JT.cache_init(jcfg, len(prompts), max_seq)
    batch = {"tokens": jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in extra.items()}}
    logits, caches = prefill(jparams, batch, caches, (pos - 1)[:, None])
    out = [jnp.argmax(logits[:, 0], axis=-1)]
    for _ in range(max_new - 1):
        logits, caches = decode(jparams, out[-1][:, None].astype(jnp.int32), caches, pos)
        out.append(jnp.argmax(logits[:, 0], axis=-1))
        pos = pos + 1
    return np.stack([np.asarray(t) for t in out], axis=1).tolist()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# Config and weights


def test_config_matches_jax():
    """The full config field for field, and reduced() as JAX's: 2 encoder
    layers, 8 frames."""
    for get in ("get_config", "get_reduced"):
        jcfg, cfg = getattr(jcfg_registry, get)(ARCH), getattr(cfg_registry, get)(ARCH)
        for f in jcfg.__dataclass_fields__:
            if f != "dtype":
                assert getattr(cfg, f) == getattr(jcfg, f), (get, f)
        assert cfg.dtype == str(jcfg.dtype if get == "get_reduced" else "bfloat16")
    red = cfg_registry.get_reduced(ARCH)
    assert (red.encoder_layers, red.frontend_tokens, red.num_layers) == (2, 8, 2)
    full = cfg_registry.get_config(ARCH)
    assert (full.family, full.block_pattern, full.frontend_tokens, full.tie_embeddings) == (
        "encdec", ("encdec_attn",), 1500, False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_bit_for_bit(dtype):
    """Every leaf: the decoder layers (self, cross, MLP), the stacked
    encoder split layer by layer, enc_final_norm, dec_pos_embed, the head."""
    jcfg, jparams, cfg, params = _model(dtype)
    assert len(params["layers"]) == cfg.num_layers
    assert len(params["enc_layers"]) == cfg.encoder_layers
    pairs = [(params["layers"][li], jax.tree.map(lambda a: a[li], jparams["groups"][0]))
             for li in range(cfg.num_layers)]
    pairs += [(params["enc_layers"][li], jax.tree.map(lambda a: a[li], jparams["enc_layers"][0]))
              for li in range(cfg.encoder_layers)]
    pairs += [(params[k], jparams[k]) for k in ("embed", "final_norm", "head", "enc_final_norm",
                                                "dec_pos_embed")]
    n = 0
    for ours, theirs in pairs:
        got, want = dict(_leaves(ours)), dict(_leaves(theirs))
        assert sorted(got) == sorted(want)
        for key, leaf in got.items():
            w = np.asarray(want[key])
            assert convert.to_torch(w, "cpu").dtype == leaf.dtype, key
            assert np.array_equal(leaf.view(torch.int16 if leaf.element_size() == 2
                                            else torch.int32).numpy(),
                                  w.view(np.int16 if w.dtype.itemsize == 2 else np.int32)), key
            n += 1
    assert n > 40
    assert set(params) == {"embed", "final_norm", "layers", "head", "enc_layers",
                           "enc_final_norm", "dec_pos_embed"}


def test_model_init_and_cache_shapes():
    """The port's own init and caches: the encoder blocks, dec_pos_embed
    (max_pos_embed, d), and per decoder layer the self K/V rows and the
    cross K/V of frontend_tokens rows (JAX's encdec_cache_init); the paged
    cache is refused (not attention-only), as in JAX."""
    cfg = cfg_registry.get_reduced(ARCH, dtype="bfloat16")
    params = T.model_init(cfg, EncodingConfig(), seed=0, device="cpu")
    assert len(params["enc_layers"]) == 2 and sorted(params["enc_layers"][0]) == [
        "attn", "ln1", "ln2", "mlp"]
    assert sorted(params["layers"][0]) == ["cross_attn", "ln1", "ln2", "ln_x", "mlp",
                                           "self_attn"]
    assert params["dec_pos_embed"].shape == (cfg.max_pos_embed, cfg.d_model)
    caches = T.cache_init(cfg, 3, 20, device="cpu")
    jcache = jax.eval_shape(lambda: JT.cache_init(
        jcfg_registry.get_reduced(ARCH, dtype="bfloat16"), 3, 20))["groups"][0]
    for layer in caches["layers"]:
        assert sorted(layer) == ["cross_k", "cross_v", "k", "v"]
        for name, want in (("k", jcache["self"]["k"]), ("v", jcache["self"]["v"]),
                           ("cross_k", jcache["cross_k"]), ("cross_v", jcache["cross_v"])):
            assert tuple(layer[name].shape) == want.shape[1:]
            assert layer[name].dtype == torch.bfloat16
    per_layer = 2 * 3 * (20 + cfg.frontend_tokens) * cfg.num_kv_heads * cfg.head_dim * 2
    assert T.cache_bytes(caches) == cfg.num_layers * per_layer
    with pytest.raises(ValueError, match="attention-only"):
        T.cache_init(cfg, 2, 16, cache_mode="paged", device="cpu")


def test_decode_weight_stream_skips_the_encoder_and_cross_kv():
    """A decode step streams the decoder's self q/k/v/o, cross q/o and MLP,
    and the head; not the encoder, nor the cross wk/wv (cached)."""
    cfg = cfg_registry.get_config(ARCH)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    got = T.decode_weight_stream_bytes(cfg, EncodingConfig())
    assert got == {"projections": cfg.num_layers * (6 * d * d + 2 * d * f) * 2,
                   "head": v * d * 2}
    assert T.layer_weight_shapes(cfg, "encdec_attn") == [(d, d)] * 8 + [(f, d), (d, f)]
    assert T.layer_weight_shapes(cfg, "enc_attn") == [(d, d)] * 4 + [(f, d), (d, f)]


@pytest.mark.parametrize("b,kvh,L,g,keys", [(4, 6, 1, 1, 1500), (4, 6, 1500, 1, 1500),
                                             (4, 6, 64, 1, 1500), (4, 6, 448, 1, 1500)])
def test_split_plan_covers_the_cross_keys(b, kvh, L, g, keys):
    """The key-split plan at Whisper's shapes (the cross decode, the
    encoder, cross prefill at 64 and 448 rows): the splits' ranges cover
    keys 0 .. 1499 once each, the last 64-key tile partial."""
    splits, per = attn.decode_split_plan(b, kvh, L, g, keys)
    ranges = [attn.decode_split_range(i, splits, per, keys) for i in range(splits)]
    covered = [t for lo, hi in ranges for t in range(lo, hi)]
    assert covered == list(range(keys))
    assert per % attn.DECODE_KEY_TILE == 0 and splits <= attn.DECODE_MAX_SPLITS
    if L >= 1500:
        assert splits == 1  # 24 query tiles x 24 (row, kv head) pairs fill the card


# ---------------------------------------------------------------------------
# Forward against JAX, f32


@pytest.mark.parametrize("jbackend", list(JENCS))
def test_encoder_output_matches_jax(jbackend):
    jcfg, jparams, cfg, params = _model()
    frames = _frames(cfg, 2)
    want = jax.jit(lambda p, x: JT._run_encoder(p, x, jcfg, JENCS[jbackend], JPhase.PREFILL))(
        jparams, jnp.asarray(frames))
    got = T._run_encoder(params, torch.from_numpy(frames), cfg, ENC, Phase.PREFILL)
    assert got.shape == (2, cfg.frontend_tokens, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_sinusoid_matches_jax():
    """The encoder's f32 positions at Whisper's width and 1500 frames.  The
    only difference from XLA's table is the denominator 10000^(2i/d): the
    port's torch.pow is within one ulp of the float64 power of the same f32
    exponent, XLA's pow on the CPU up to 9 ulps from it.  Given
    the same angles, the sines and cosines are within one ulp of XLA's;
    and the whole table within |angle difference| + one ulp of XLA's (sin
    and cos move by at most the angle's change)."""
    cfg = cfg_registry.get_config(ARCH)
    t, d = cfg.frontend_tokens, cfg.d_model

    def jparts():
        pos = jnp.arange(t)[:, None]
        i = jnp.arange(d // 2)[None, :]
        den = jnp.power(10000.0, 2 * i / d)
        ang = pos / den
        return den, ang, jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)

    jden, jang, want = (np.asarray(a) for a in jax.jit(jparts)())
    got = T.sinusoids(t, d, "cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (t, d)
    i = np.arange(d // 2)[None, :]
    expo = (2 * i).astype(np.float32) / np.float32(d)  # the f32 exponent both compute
    exact = (10000.0 ** expo.astype(np.float64)).astype(np.float32)
    port = torch.pow(10000.0, 2 * torch.from_numpy(i).float() / d).numpy()
    assert np.all(np.abs(port - exact) <= np.spacing(exact))
    assert np.all(np.abs(jden - exact) <= 10 * np.spacing(exact))
    ang = np.arange(t, dtype=np.float32)[:, None] / port
    same = torch.from_numpy(np.array(jang))
    for fn, half in ((torch.sin, want[:, : d // 2]), (torch.cos, want[:, d // 2:])):
        assert np.all(np.abs(fn(same).numpy() - half) <= np.spacing(np.abs(half)))
    moved = np.abs(np.concatenate([ang - jang] * 2, axis=-1))
    assert np.all(np.abs(got - want) <= moved + np.spacing(np.abs(want)))


@pytest.mark.parametrize("mode,phase", [("cross", "prefill"), ("cross", "decode"),
                                        ("encoder", "prefill"), ("no_rope_cached", "prefill"),
                                        ("no_rope_cached", "decode")])
def test_attention_apply_modes_match_jax(mode, phase):
    """layers.attention_apply's new arguments against JAX's, on one layer's
    weights: kv_src (cross attention: K/V from the source, no mask, no RoPE,
    no cache), causal=False with use_rope=False (the encoder, no cache), and
    use_rope=False on the cached self attention (the decoder: a 6-token
    prefill, then at DECODE one token at pos 6)."""
    from repro.models import layers as JL
    from repro_torch.models import layers as L

    jcfg, jparams, cfg, params = _model()
    jp = jax.tree.map(lambda a: a[0], jparams["groups"][0])["cross_attn"]
    p = params["layers"][0]["cross_attn"]
    rng = np.random.RandomState(21)
    s = 6 if phase == "prefill" else 1
    x = rng.randn(2, s, cfg.d_model).astype(np.float32)
    src = rng.randn(2, cfg.frontend_tokens, cfg.d_model).astype(np.float32)
    jph, ph = (JPhase.PREFILL, Phase.PREFILL) if phase == "prefill" else (JPhase.DECODE,
                                                                          Phase.DECODE)
    jenc = JENCS["xla"]
    if mode == "cross":
        want, _ = JL.attention_apply(jp, jnp.asarray(x), cfg=jcfg, enc=jenc, phase=jph,
                                     kv_src=jnp.asarray(src), use_rope=False)
        got = L.attention_apply(p, torch.from_numpy(x), cfg=cfg, enc=ENC, phase=ph,
                                kv_src=torch.from_numpy(src), use_rope=False)
    elif mode == "encoder":
        want, _ = JL.attention_apply(jp, jnp.asarray(x), cfg=jcfg, enc=jenc, phase=jph,
                                     causal=False, use_rope=False)
        got = L.attention_apply(p, torch.from_numpy(x), cfg=cfg, enc=ENC, phase=ph,
                                causal=False, use_rope=False)
    else:
        first = rng.randn(2, 6, cfg.d_model).astype(np.float32)
        jcache = JL.attn_cache_init(jcfg, 2, 8)
        cache = L.attn_cache_init(cfg, 2, 8, device="cpu")
        want, jcache = JL.attention_apply(jp, jnp.asarray(first), cfg=jcfg, enc=jenc,
                                          phase=JPhase.PREFILL, cache=jcache, use_rope=False)
        got = L.attention_apply(p, torch.from_numpy(first), cfg=cfg, enc=ENC,
                                phase=Phase.PREFILL, cache=cache, use_rope=False)
        if phase == "decode":
            want, jcache = JL.attention_apply(jp, jnp.asarray(x), cfg=jcfg, enc=jenc, phase=jph,
                                              cache=jcache, pos=6, use_rope=False)
            got = L.attention_apply(p, torch.from_numpy(x), cfg=cfg, enc=ENC, phase=ph,
                                    cache=cache, pos=6, use_rope=False)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(cache[name]), np.asarray(jcache[name]), **TOL)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("jbackend", list(JENCS))
def test_prefill_logits_and_caches_match_jax(jbackend):
    """A cached prefill of 2 rows of 11 tokens over 8 frames: logits at
    every position, each layer's self K/V (no RoPE) and cross K/V."""
    jcfg, jparams, cfg, params = _model()
    frames, toks = _frames(cfg, 2), _tokens(2, 11)
    jcaches = JT.cache_init(jcfg, 2, 16)
    want, jnew, _ = jax.jit(lambda p, bt, c: JT.forward(
        p, bt, cfg=jcfg, enc=JENCS[jbackend], phase=JPhase.PREFILL, caches=c))(
        jparams, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}, jcaches)
    caches = T.cache_init(cfg, 2, 16, device="cpu")
    got = T.forward(params, torch.from_numpy(toks), cfg=cfg, enc=ENC, phase=Phase.PREFILL,
                    caches=caches, frames=torch.from_numpy(frames))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for li, layer in enumerate(caches["layers"]):
        jl = jax.tree.map(lambda a: np.asarray(a[li]), jnew["groups"][0])
        for name, w in (("k", jl["self"]["k"]), ("v", jl["self"]["v"]),
                        ("cross_k", jl["cross_k"]), ("cross_v", jl["cross_v"])):
            np.testing.assert_allclose(_np(layer[name]), w, **TOL)


@pytest.mark.parametrize("pos_kind", ["scalar", "vector"])
@pytest.mark.parametrize("jbackend", list(JENCS))
def test_cached_decode_logits_match_jax(jbackend, pos_kind):
    """Prefill 9 tokens, then 4 cached decode steps (no frames: the cross
    K/V come from the cache), the position a scalar or a (B,) vector;
    every step's logits."""
    jcfg, jparams, cfg, params = _model()
    jenc = JENCS[jbackend]
    frames, toks = _frames(cfg, 2, seed=5), _tokens(2, 13, seed=6)
    prefill, decode = _jax_fns(jcfg, jenc)
    jcaches = JT.cache_init(jcfg, 2, 16)
    idx = jnp.full((2, 1), 8, jnp.int32)
    jlog, jcaches = prefill(jparams, {"tokens": jnp.asarray(toks[:, :9]),
                                      "frames": jnp.asarray(frames)}, jcaches, idx)
    caches = T.cache_init(cfg, 2, 16, device="cpu")
    log = T.forward(params, torch.from_numpy(toks[:, :9]), cfg=cfg, enc=ENC, phase=Phase.PREFILL,
                    caches=caches, frames=torch.from_numpy(frames),
                    logits_idx=torch.full((2, 1), 8))
    np.testing.assert_allclose(_np(log), np.asarray(jlog), **TOL)
    for i in range(9, 13):
        jpos = jnp.full((2,), i, jnp.int32) if pos_kind == "vector" else jnp.asarray(i, jnp.int32)
        pos = torch.full((2,), i) if pos_kind == "vector" else i
        jlog, jcaches = decode(jparams, jnp.asarray(toks[:, i:i + 1]), jcaches, jpos)
        log = T.forward(params, torch.from_numpy(toks[:, i:i + 1]), cfg=cfg, enc=ENC,
                        phase=Phase.DECODE, caches=caches, pos=pos)
        np.testing.assert_allclose(_np(log), np.asarray(jlog), **TOL)


def test_staggered_rows_decode_matches_jax():
    """Rows at different depths ((B,) pos 9 and 12) through the self cache
    and the shared cross cache."""
    jcfg, jparams, cfg, params = _model()
    frames, toks = _frames(cfg, 2, seed=7), _tokens(2, 12, seed=8)
    prefill, decode = _jax_fns(jcfg, JENCS["xla"])
    jcaches = JT.cache_init(jcfg, 2, 16)
    _, jcaches = prefill(jparams, {"tokens": jnp.asarray(toks),
                                   "frames": jnp.asarray(frames)}, jcaches,
                         jnp.full((2, 1), 11, jnp.int32))
    caches = T.cache_init(cfg, 2, 16, device="cpu")
    T.forward(params, torch.from_numpy(toks), cfg=cfg, enc=ENC, phase=Phase.PREFILL,
              caches=caches, frames=torch.from_numpy(frames), logits_idx=torch.full((2, 1), 11))
    step = np.array([[5], [7]], np.int32)
    jlog, _ = decode(jparams, jnp.asarray(step), jcaches, jnp.asarray([9, 12], jnp.int32))
    log = T.forward(params, torch.from_numpy(step), cfg=cfg, enc=ENC, phase=Phase.DECODE,
                    caches=caches, pos=torch.tensor([9, 12]))
    np.testing.assert_allclose(_np(log), np.asarray(jlog), **TOL)


def _prompts(n, lo, hi, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, int(k)).astype(np.int32) for k in rng.randint(lo, hi + 1, n)]


@pytest.mark.parametrize("jbackend", list(JENCS))
def test_greedy_tokens_match_jax(jbackend):
    """greedy_generate: 3 prompts of 3-9 tokens, right-padded, 8 tokens each."""
    jcfg, jparams, cfg, params = _model()
    frames, prompts = _frames(cfg, 3, seed=9), _prompts(3, 3, 9, seed=10)
    want = jax_greedy(jcfg, jparams, JENCS[jbackend], prompts, max_new=8, max_seq=20,
                      extra={"frames": frames})
    calls = []
    got = T.greedy_generate(params, prompts, cfg=cfg, enc=ENC, max_new=8, max_seq=20,
                            frames=torch.from_numpy(frames), device="cpu",
                            on_step=lambda: calls.append(len(calls)))
    assert got == want
    assert len(calls) == 1 + 8  # before the prefill, then after every forward


# ---------------------------------------------------------------------------
# bf16 against strict JAX


def test_bf16_logits_and_tokens_match_strict_jax():
    """bf16 weights and activations: prefill and decode logits within 1e-4,
    and 8 greedy tokens identical, against JAX compiled with excess
    precision off."""
    jcfg, jparams, cfg, params = _model("bfloat16")
    frames, toks = _frames(cfg, 2, seed=11), _tokens(2, 10, seed=12)
    prefill, decode = _jax_fns(jcfg, JENCS["xla"], STRICT)
    jcaches = JT.cache_init(jcfg, 2, 16)
    jlog, jcaches = prefill(jparams, {"tokens": jnp.asarray(toks[:, :7]),
                                      "frames": jnp.asarray(frames)}, jcaches,
                            jnp.full((2, 1), 6, jnp.int32))
    caches = T.cache_init(cfg, 2, 16, device="cpu")
    log = T.forward(params, torch.from_numpy(toks[:, :7]), cfg=cfg, enc=ENC,
                    phase=Phase.PREFILL, caches=caches, frames=torch.from_numpy(frames),
                    logits_idx=torch.full((2, 1), 6))

    def close(got, want):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **TOL)

    close(log, jlog)
    for i in range(7, 10):
        jlog, jcaches = decode(jparams, jnp.asarray(toks[:, i:i + 1]), jcaches,
                               jnp.full((2,), i, jnp.int32))
        log = T.forward(params, torch.from_numpy(toks[:, i:i + 1]), cfg=cfg, enc=ENC,
                        phase=Phase.DECODE, caches=caches, pos=torch.full((2,), i))
        close(log, jlog)
    prompts = _prompts(2, 3, 8, seed=13)
    want = jax_greedy(jcfg, jparams, JENCS["xla"], prompts, max_new=8, max_seq=20,
                      extra={"frames": frames}, options=STRICT)
    got = T.greedy_generate(params, prompts, cfg=cfg, enc=ENC, max_new=8, max_seq=20,
                            frames=torch.from_numpy(frames), device="cpu")
    assert got == want


# ---------------------------------------------------------------------------
# The engine takes tokens only


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-26b"])
def test_engine_refuses_encdec_and_vlm(arch):
    """As the JAX engine (token batches only): constructing an engine on
    either family raises NotImplementedError naming forward as the path."""
    cfg = cfg_registry.get_reduced(arch)
    params = T.model_init(cfg, EncodingConfig(), seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="takes tokens only.*transformer.forward"):
        engine_lib.Engine(params, cfg, EncodingConfig(backend="auto", attn_backend="auto"),
                          device="cpu", slots=2, max_seq=32)
