"""The VLM family in the port (InternVL2-26B: the patch projector of
models/transformer.forward and its image-prefix prefill) against the JAX
package, on the reduced config (2 layers, d 64, 4 query heads on one kv
head of 16, 8 patches of width 32) with JAX's own weights carried across by
convert.params_from_jax.

Patches and tokens are drawn from a seed with numpy (patches N(0, 0.1^2),
as JAX's tests/test_archs.py).  JAX runs "xla" (its plain paths) and
"pallas" (its kernels in interpret mode); the port registry routing, the
kernels' plain versions on the CPU.  The tolerances are
tests/test_torch_encdec.py's: f32 within 1e-4 abs (and rel); greedy tokens
identical in f32 and in bf16; weights bit for bit; bf16 logits (JAX compiled
with excess precision off) within 1e-4, only the f32 head's order of sums
differing.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro.configs import registry as jcfg_registry
from repro.core import packed as jpacked
from repro.core.encoding import Phase as JPhase
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.models import transformer as T

from test_torch_encdec import ENC, JENCS, STRICT, TOL, _jax_fns, _leaves, _np, jax_greedy

ARCH = "internvl2-26b"


@functools.lru_cache(maxsize=None)
def _model(dtype: str = "float32"):
    jcfg = jcfg_registry.get_reduced(ARCH, dtype=dtype)
    cfg = cfg_registry.get_reduced(ARCH, dtype=dtype)
    jparams = jax.jit(functools.partial(JT.model_init, cfg=jcfg, enc=JENCS["xla"]))(
        jax.random.PRNGKey(4))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, EncodingConfig(),
                                     "cpu")
    return jcfg, jparams, cfg, params


def _patches(cfg, b, seed=0):
    rng = np.random.RandomState(seed)
    return (0.1 * rng.randn(b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)


def _tokens(b, s, seed=1):
    return np.random.RandomState(seed).randint(1, 256, (b, s)).astype(np.int32)


def test_config_matches_jax():
    """The full config field for field, and reduced() as JAX's: 8 patches
    of width 32."""
    for get in ("get_config", "get_reduced"):
        jcfg, cfg = getattr(jcfg_registry, get)(ARCH), getattr(cfg_registry, get)(ARCH)
        for f in jcfg.__dataclass_fields__:
            if f != "dtype":
                assert getattr(cfg, f) == getattr(jcfg, f), (get, f)
    red = cfg_registry.get_reduced(ARCH)
    assert (red.frontend_tokens, red.frontend_dim, red.encoder_layers) == (8, 32, 0)
    full = cfg_registry.get_config(ARCH)
    assert (full.family, full.frontend_tokens, full.frontend_dim, full.rope_theta) == (
        "vlm", 256, 3200, 1e6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_bit_for_bit(dtype):
    """Every leaf of every layer, the embedding, the head and the projector
    (its norm over frontend_dim, fc1, fc2)."""
    jcfg, jparams, cfg, params = _model(dtype)
    pairs = [(params["layers"][li], jax.tree.map(lambda a: a[li], jparams["groups"][0]))
             for li in range(cfg.num_layers)]
    pairs += [(params[k], jparams[k]) for k in ("embed", "final_norm", "head", "projector")]
    n = 0
    for ours, theirs in pairs:
        got, want = dict(_leaves(ours)), dict(_leaves(theirs))
        assert sorted(got) == sorted(want)
        for key, leaf in got.items():
            w = np.asarray(want[key])
            assert convert.to_torch(w, "cpu").dtype == leaf.dtype, key
            wide = leaf.element_size() == 4
            assert np.array_equal(leaf.view(torch.int32 if wide else torch.int16).numpy(),
                                  w.view(np.int32 if wide else np.int16)), key
            n += 1
    assert n > 20
    assert params["projector"]["ln"]["scale"].shape == (cfg.frontend_dim,)
    assert set(params) == {"embed", "final_norm", "layers", "head", "projector"}


def test_gelu_matches_xla():
    """The projector's tanh GELU in f32 against jax.nn.gelu's (XLA's) on
    [-12, 12]: not within one ulp everywhere, as XLA's 1 + tanh(...)
    cancels to 0 below x = -4.88 where the value is ~-6e-7; both are within
    1e-6 abs of the float64 GELU and of each other, the port's no farther
    from float64 than XLA's."""
    x = np.linspace(-12.0, 12.0, 200001, dtype=np.float32)
    want = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x)))
    got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    xd = x.astype(np.float64)
    exact = 0.5 * xd * (1 + np.tanh(np.sqrt(2 / np.pi) * (xd + 0.044715 * xd**3)))
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(got - exact).max() <= np.abs(want - exact).max() <= 1e-6


@pytest.mark.parametrize("jbackend", list(JENCS))
def test_projector_output_matches_jax(jbackend):
    """norm -> fc1 -> GELU -> fc2 over the patches, JAX's lines of
    transformer.forward on JAX's own layers."""
    jcfg, jparams, cfg, params = _model()
    patches = _patches(cfg, 2)
    jenc = JENCS[jbackend]

    def jproj(p, x):
        pj, d = p["projector"], jcfg.d_model
        y = JL.norm_apply(pj["ln"], x, jcfg)
        y = jpacked.linear_apply(pj["fc1"], y, n=d, phase=JPhase.PREFILL, enc=jenc)
        y = jax.nn.gelu(y.astype(jnp.float32)).astype(x.dtype)
        return jpacked.linear_apply(pj["fc2"], y, n=d, phase=JPhase.PREFILL, enc=jenc)

    want = jax.jit(jproj)(jparams, jnp.asarray(patches))
    got = T._project_patches(params, torch.from_numpy(patches), cfg, ENC, Phase.PREFILL)
    assert got.shape == (2, cfg.frontend_tokens, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("jbackend", list(JENCS))
def test_prefill_logits_and_caches_match_jax(jbackend):
    """A cached prefill of 8 patches + 11 tokens: logits at all 19
    positions, each layer's K/V rows (RoPE at theta 1e6 from position 0,
    the image prefix included)."""
    jcfg, jparams, cfg, params = _model()
    patches, toks = _patches(cfg, 2), _tokens(2, 11)
    jcaches = JT.cache_init(jcfg, 2, 24)
    want, jnew, _ = jax.jit(lambda p, bt, c: JT.forward(
        p, bt, cfg=jcfg, enc=JENCS[jbackend], phase=JPhase.PREFILL, caches=c))(
        jparams, {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)}, jcaches)
    caches = T.cache_init(cfg, 2, 24, device="cpu")
    got = T.forward(params, torch.from_numpy(toks), cfg=cfg, enc=ENC, phase=Phase.PREFILL,
                    caches=caches, patches=torch.from_numpy(patches))
    assert got.shape == (2, cfg.frontend_tokens + 11, cfg.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for li, layer in enumerate(caches["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(layer[name]),
                                       np.asarray(jnew["groups"][0][name][li]), **TOL)


@pytest.mark.parametrize("pos_kind", ["scalar", "vector"])
@pytest.mark.parametrize("jbackend", list(JENCS))
def test_cached_decode_logits_match_jax(jbackend, pos_kind):
    """Prefill 8 patches + 7 tokens, then 4 cached decode steps at
    positions P + 7 .. P + 10 (no patches), the position a scalar or a (B,)
    vector."""
    jcfg, jparams, cfg, params = _model()
    patches, toks = _patches(cfg, 2, seed=5), _tokens(2, 11, seed=6)
    p = cfg.frontend_tokens
    prefill, decode = _jax_fns(jcfg, JENCS[jbackend])
    jcaches = JT.cache_init(jcfg, 2, 24)
    idx = np.full((2, 1), p + 6, np.int32)
    jlog, jcaches = prefill(jparams, {"tokens": jnp.asarray(toks[:, :7]),
                                      "patches": jnp.asarray(patches)}, jcaches,
                            jnp.asarray(idx))
    caches = T.cache_init(cfg, 2, 24, device="cpu")
    log = T.forward(params, torch.from_numpy(toks[:, :7]), cfg=cfg, enc=ENC,
                    phase=Phase.PREFILL, caches=caches, patches=torch.from_numpy(patches),
                    logits_idx=torch.from_numpy(idx))
    np.testing.assert_allclose(_np(log), np.asarray(jlog), **TOL)
    for i in range(7, 11):
        at = p + i
        jpos = jnp.full((2,), at, jnp.int32) if pos_kind == "vector" else jnp.asarray(at)
        pos = torch.full((2,), at) if pos_kind == "vector" else at
        jlog, jcaches = decode(jparams, jnp.asarray(toks[:, i:i + 1]), jcaches, jpos)
        log = T.forward(params, torch.from_numpy(toks[:, i:i + 1]), cfg=cfg, enc=ENC,
                        phase=Phase.DECODE, caches=caches, pos=pos)
        np.testing.assert_allclose(_np(log), np.asarray(jlog), **TOL)


def _prompts(n, lo, hi, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, int(k)).astype(np.int32) for k in rng.randint(lo, hi + 1, n)]


@pytest.mark.parametrize("jbackend", list(JENCS))
def test_greedy_tokens_match_jax(jbackend):
    """greedy_generate: 3 prompts of 2-9 tokens after 8 patches, right-padded,
    rows decoding at their own positions, 8 tokens each."""
    jcfg, jparams, cfg, params = _model()
    patches, prompts = _patches(cfg, 3, seed=9), _prompts(3, 2, 9, seed=10)
    want = jax_greedy(jcfg, jparams, JENCS[jbackend], prompts, max_new=8, max_seq=32,
                      extra={"patches": patches})
    got = T.greedy_generate(params, prompts, cfg=cfg, enc=ENC, max_new=8, max_seq=32,
                            patches=torch.from_numpy(patches), device="cpu")
    assert got == want


def test_bf16_logits_and_tokens_match_strict_jax():
    """bf16: prefill and decode logits within 1e-4, and 8 greedy tokens
    identical, against JAX compiled with excess precision off."""
    jcfg, jparams, cfg, params = _model("bfloat16")
    patches, toks = _patches(cfg, 2, seed=11), _tokens(2, 9, seed=12)
    p = cfg.frontend_tokens
    prefill, decode = _jax_fns(jcfg, JENCS["xla"], STRICT)
    jcaches = JT.cache_init(jcfg, 2, 24)
    idx = np.full((2, 1), p + 5, np.int32)
    jlog, jcaches = prefill(jparams, {"tokens": jnp.asarray(toks[:, :6]),
                                      "patches": jnp.asarray(patches)}, jcaches,
                            jnp.asarray(idx))
    caches = T.cache_init(cfg, 2, 24, device="cpu")
    log = T.forward(params, torch.from_numpy(toks[:, :6]), cfg=cfg, enc=ENC,
                    phase=Phase.PREFILL, caches=caches, patches=torch.from_numpy(patches),
                    logits_idx=torch.from_numpy(idx))

    def close(got, want):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **TOL)

    close(log, jlog)
    for i in range(6, 9):
        jlog, jcaches = decode(jparams, jnp.asarray(toks[:, i:i + 1]), jcaches,
                               jnp.full((2,), p + i, jnp.int32))
        log = T.forward(params, torch.from_numpy(toks[:, i:i + 1]), cfg=cfg, enc=ENC,
                        phase=Phase.DECODE, caches=caches, pos=torch.full((2,), p + i))
        close(log, jlog)
    prompts = _prompts(2, 3, 8, seed=13)
    want = jax_greedy(jcfg, jparams, JENCS["xla"], prompts, max_new=8, max_seq=32,
                      extra={"patches": patches}, options=STRICT)
    got = T.greedy_generate(params, prompts, cfg=cfg, enc=ENC, max_new=8, max_seq=32,
                            patches=torch.from_numpy(patches), device="cpu")
    assert got == want


def test_decode_weight_stream_at_full_size():
    """A decode step streams the 48 layers and the untied head, not the
    projector: ~38.6 GB in bf16, 11.5 ms at 3.35 TB/s."""
    cfg = cfg_registry.get_config(ARCH)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    kvd = cfg.num_kv_heads * cfg.head_dim
    got = T.decode_weight_stream_bytes(cfg, EncodingConfig())
    assert got == {"projections": cfg.num_layers * (2 * d * d + 2 * kvd * d + 3 * d * f) * 2,
                   "head": v * d * 2}
    assert round(sum(got.values()) / 1e9, 1) == 38.6
    assert round(1e3 * sum(got.values()) / 3.35e12, 1) == 11.5
    params = T.model_init(cfg_registry.get_reduced(ARCH), EncodingConfig(), seed=0,
                          device="cpu")
    assert sorted(params["projector"]) == ["fc1", "fc2", "ln"]
    with pytest.raises(ValueError, match="needs `patches`"):
        T.forward(params, torch.ones((1, 3), dtype=torch.int64),
                  cfg=cfg_registry.get_reduced(ARCH), enc=ENC, phase=Phase.PREFILL)
