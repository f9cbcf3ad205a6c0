"""The dense family in the port (Qwen2-1.5B, Qwen2.5-14B/32B, Yi-9B) against
the JAX package, on weights converted from its pytree.

Every arch runs at two sizes: the registry's reduced config (4 query heads,
head dim 16, G = 4 for each of them), and "heads": the reduced config with
the real head structure kept through get_reduced overrides (12/2, 40/8,
40/8 and 32/4 heads of dim 128: G = 6, 5, 5, 8).  The QKV biases, zero at
init on both sides, are set to random values in the JAX pytree before the
conversion, and the untied heads of Qwen2.5 and Yi are distinct draws from
the embedding, so a dropped bias or a head read from the wrong leaf shows.
The engines and the quantized weights are in tests/test_torch_archs_engine.py.

The JAX side runs its plain paths (backend and attn_backend "xla"); the
port runs registry routing ("fused" at prefill and decode, "auto" in the
engines), the kernels' plain versions on the CPU.  f32 throughout; logits
atol = rtol = 1e-4, the port's tolerance elsewhere; engine tokens
identical."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jcfg_registry
from repro.core import packed as jpacked
from repro.core.encoding import Phase as JPhase
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core import packed
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import registry
from repro_torch.models import transformer as T

ARCHS = ("qwen2-1.5b", "qwen2.5-14b", "qwen2.5-32b", "yi-9b")
SIZES = ("reduced", "heads")
CASES = [(a, s) for a in ARCHS for s in SIZES]
IDS = [f"{a}-{s}" for a, s in CASES]
TOL = dict(rtol=1e-4, atol=1e-4)
JENC = JEncodingConfig(enabled=True, backend="xla", attn_backend="xla")
ENC = EncodingConfig(enabled=True, backend="fused", attn_backend="pallas")
AUTO = EncodingConfig(enabled=True, backend="auto", attn_backend="auto")


def _overrides(arch: str, size: str) -> dict:
    if size == "reduced":
        return {}
    full = cfg_registry.get_config(arch)
    return dict(num_heads=full.num_heads, num_kv_heads=full.num_kv_heads,
                head_dim=full.head_dim)


def _with_biases(jparams, seed: int):
    """The JAX pytree with every bias leaf ("b") set to N(0, 0.5^2)."""
    rng = np.random.RandomState(seed)

    def one(path, leaf):
        if getattr(path[-1], "key", None) == "b":
            return jnp.asarray((0.5 * rng.randn(*leaf.shape)).astype(leaf.dtype))
        return leaf

    return jax.tree_util.tree_map_with_path(one, jparams)


@functools.lru_cache(maxsize=None)
def _model(arch: str, size: str, wq: str = "none"):
    """(jcfg, jparams, cfg, params): random JAX weights with nonzero biases,
    converted to the port."""
    kw = _overrides(arch, size)
    jcfg = jcfg_registry.get_reduced(arch, **kw)
    cfg = cfg_registry.get_reduced(arch, **kw)
    jenc = JEncodingConfig(enabled=True, backend="xla", weight_quant=wq)
    jparams = _with_biases(JT.model_init(jax.random.PRNGKey(1), jcfg, jenc), seed=2)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     EncodingConfig(weight_quant=wq), "cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(autouse=True)
def _clean_quarantine():
    registry.clear_quarantine()
    yield
    registry.clear_quarantine()


# ---------------------------------------------------------------------------
# Configs


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax_field_by_field(arch):
    cfg, jcfg = cfg_registry.get_config(arch), jcfg_registry.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for size in SIZES:
        kw = _overrides(arch, size)
        assert (dataclasses.asdict(cfg_registry.get_reduced(arch, **kw))
                == dataclasses.asdict(jcfg_registry.get_reduced(arch, **kw)))
    heads = cfg_registry.get_reduced(arch, **_overrides(arch, "heads"))
    assert heads.gqa_groups == cfg.gqa_groups == {"qwen2-1.5b": 6, "qwen2.5-14b": 5,
                                                  "qwen2.5-32b": 5, "yi-9b": 8}[arch]
    assert heads.head_dim == 128 and cfg_registry.get_reduced(arch).gqa_groups == 4
    assert cfg.qkv_bias == arch.startswith("qwen")
    assert cfg.tie_embeddings == (arch == "qwen2-1.5b")


def test_mixtral_config_matches_jax_and_its_assignment():
    """Mixtral-8x22B: the JAX config field by field, reduced too, and its
    assigned hyperparameters (arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1)."""
    arch = "mixtral-8x22b"
    cfg, jcfg = cfg_registry.get_config(arch), jcfg_registry.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (dataclasses.asdict(cfg_registry.get_reduced(arch))
            == dataclasses.asdict(jcfg_registry.get_reduced(arch)))
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
            cfg.vocab_size, cfg.num_experts, cfg.experts_per_token,
            cfg.sliding_window) == (56, 6144, 48, 8, 16384, 32768, 8, 2, 4096)
    assert cfg.family == "moe" and cfg.head_dim == 128 and not cfg.tie_embeddings
    assert cfg.capacity_factor == 1.25 and cfg.rope_theta == 1e6


# Each arch's assigned hyperparameters: (layers, d_model, heads, kv heads,
# head dim, d_ff, vocab, pattern, window, tied head).
ASSIGNED = {
    "grok-1-314b": (64, 6144, 48, 8, 128, 32768, 131072, ("attn",), 0, False),
    "rwkv6-1.6b": (24, 2048, 32, 32, 64, 7168, 65536, ("rwkv",), 0, False),
    "recurrentgemma-9b": (38, 4096, 16, 1, 256, 12288, 256000, ("rec", "rec", "attn"), 2048,
                          True),
}


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_recurrent_and_grok_configs_match_jax(arch):
    """Grok-1-314B (hf:xai-org/grok-1), RWKV6-1.6B (arXiv:2404.05892) and
    RecurrentGemma-9B (arXiv:2402.19427): the JAX config field by field,
    reduced too, and the assigned hyperparameters.  RecurrentGemma's
    reduced() keeps the tail remainder: 38 = 12 x 3 + 2 at full size, 8 =
    2 x 3 + 2 reduced."""
    cfg, jcfg = cfg_registry.get_config(arch), jcfg_registry.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (dataclasses.asdict(cfg_registry.get_reduced(arch))
            == dataclasses.asdict(jcfg_registry.get_reduced(arch)))
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.block_pattern, cfg.sliding_window,
            cfg.tie_embeddings) == ASSIGNED[arch]
    if arch == "grok-1-314b":
        assert (cfg.num_experts, cfg.experts_per_token, cfg.rope_theta) == (8, 2, 1e4)
    if arch == "rwkv6-1.6b":
        assert (cfg.rwkv_head_dim, cfg.norm_kind) == (64, "layernorm")
    if arch == "recurrentgemma-9b":
        assert (cfg.rnn_width, cfg.conv_width) == (4096, 4)
        assert cfg_registry.get_reduced(arch).num_layers == 8


def test_registry_refuses_unknown_arch():
    with pytest.raises(KeyError, match="unknown arch 'gpt-7'; ported so far"):
        cfg_registry.get_config("gpt-7")


# ---------------------------------------------------------------------------
# Weights: biases and the untied head carried across


@pytest.mark.parametrize("arch,size", CASES, ids=IDS)
def test_params_from_jax_carries_biases_and_head(arch, size):
    _, jparams, cfg, params = _model(arch, size)
    np_params = jax.tree.map(np.asarray, jparams)
    attn = np_params["groups"][0]["attn"]
    for i, layer in enumerate(params["layers"]):
        for name in ("wq", "wk", "wv"):
            if cfg.qkv_bias:
                got = layer["attn"][name]["b"].numpy()
                np.testing.assert_array_equal(got, attn[name]["b"][i])
                assert np.abs(got).max() > 0.1
            else:
                assert "b" not in layer["attn"][name]
        assert "b" not in layer["attn"]["wo"]
    if cfg.tie_embeddings:
        assert "head" not in params and "head" not in np_params
    else:
        np.testing.assert_array_equal(params["head"]["w_packed"].numpy(),
                                      np_params["head"]["w_packed"])
        head = packed.linear_out_dim(params["head"])
        assert head == cfg.vocab_size + (-cfg.vocab_size) % 128


# ---------------------------------------------------------------------------
# Logits: prefill (with its cache) and paged decode


def _prefill(arch, size, params=None):
    jcfg, jparams, cfg, port_params = _model(arch, size)
    toks = np.random.RandomState(0).randint(1, cfg.vocab_size, (2, 13)).astype(np.int32)
    want, jnew, _ = JT.forward(jparams, {"tokens": jnp.asarray(toks)}, cfg=jcfg, enc=JENC,
                               phase=JPhase.PREFILL, caches=JT.cache_init(jcfg, 2, 16))
    caches = T.cache_init(cfg, 2, 16, device="cpu")
    got = T.forward(params or port_params, torch.from_numpy(toks), cfg=cfg, enc=ENC,
                    phase=Phase.PREFILL, caches=caches)
    return got, np.asarray(want), caches, jnew


@pytest.mark.parametrize("arch,size", CASES, ids=IDS)
def test_prefill_logits_and_cache_match_jax(arch, size):
    got, want, caches, jnew = _prefill(arch, size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for i, layer in enumerate(caches["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(layer[name].numpy(),
                                       np.asarray(jnew["groups"][0][name][i]), **TOL)


def test_dropped_bias_or_wrong_head_fails():
    """The comparison above catches the faults it is there for: the port
    with its QKV biases dropped, or with the tied embedding read where the
    untied head belongs, leaves the JAX logits by far more than the
    tolerance; so do JAX's own logits with the biases zeroed."""
    arch, size = "qwen2.5-14b", "heads"
    jcfg, jparams, cfg, params = _model(arch, size)
    _, want, _, _ = _prefill(arch, size)
    no_bias = dict(params, layers=[
        dict(layer, attn={k: {n: t for n, t in v.items() if n != "b"}
                          for k, v in layer["attn"].items()})
        for layer in params["layers"]])
    got, _, _, _ = _prefill(arch, size, params=no_bias)
    assert np.abs(got.numpy() - want).max() > 100 * TOL["atol"]
    tied = {k: v for k, v in params.items() if k != "head"}
    got = T.forward(tied, torch.ones((2, 13), dtype=torch.long), cfg=dataclasses.replace(
        cfg, tie_embeddings=True), enc=ENC, phase=Phase.PREFILL)
    right = T.forward(params, torch.ones((2, 13), dtype=torch.long), cfg=cfg, enc=ENC,
                      phase=Phase.PREFILL)
    assert (got - right).abs().max().item() > 100 * TOL["atol"]
    toks = jnp.asarray(np.random.RandomState(0).randint(1, cfg.vocab_size, (2, 13)))
    zero = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.zeros_like(a) if getattr(p[-1], "key", None) == "b" else a, jparams)
    jzero, _, _ = JT.forward(zero, {"tokens": toks}, cfg=jcfg, enc=JENC, phase=JPhase.PREFILL)
    assert np.abs(np.asarray(jzero) - want).max() > 100 * TOL["atol"]


@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("arch,size", CASES, ids=IDS)
def test_paged_decode_matches_jax(arch, size, L):
    """One paged decode step (L = 1) or a verify-width window (L = 3: 9 rows,
    the packed GEMM; with G = 5 or 6 the tensor-core tiles of the card hold
    rows that are not a multiple of the group), every row at its own
    position, rows 0 and 1 sharing their leading pages: logits and pool
    writes."""
    jcfg, jparams, cfg, params = _model(arch, size)
    rng = np.random.RandomState(10 + L)
    b, bs, nb, pages = 3, 4, 6, 19
    kv_shape = (cfg.num_layers, pages, bs, cfg.num_kv_heads, cfg.head_dim)
    k_pool = (0.5 * rng.randn(*kv_shape)).astype(np.float32)
    v_pool = (0.5 * rng.randn(*kv_shape)).astype(np.float32)
    table = rng.permutation(np.arange(1, pages))[: b * nb].reshape(b, nb).astype(np.int32)
    table[1, :2] = table[0, :2]
    pos = np.array([5, 9, 17], np.int32)
    toks = rng.randint(1, cfg.vocab_size, (b, L)).astype(np.int32)
    jcaches = {"groups": ({"k": jnp.asarray(k_pool), "v": jnp.asarray(v_pool),
                           "table": jnp.asarray(np.broadcast_to(table, (cfg.num_layers, b, nb)))},)}
    want, jnew, _ = JT.forward(jparams, {"tokens": jnp.asarray(toks)}, cfg=jcfg, enc=JENC,
                               phase=JPhase.DECODE, caches=jcaches, pos=jnp.asarray(pos))
    caches = T.cache_init(cfg, b, nb * bs, cache_mode="paged", block_size=bs,
                          num_pages=pages, device="cpu")
    for i, layer in enumerate(caches["layers"]):
        layer["k"].copy_(torch.from_numpy(k_pool[i]))
        layer["v"].copy_(torch.from_numpy(v_pool[i]))
        layer["table"] = torch.from_numpy(table)
    got = T.forward(params, torch.from_numpy(toks), cfg=cfg, enc=ENC, phase=Phase.DECODE,
                    caches=caches, pos=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i, layer in enumerate(caches["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(layer[name].numpy(),
                                       np.asarray(jnew["groups"][0][name][i]), **TOL)


@pytest.mark.parametrize("kv_quant", ["kv8", "kv4"])
def test_quantized_pool_at_head_dim_128(kv_quant):
    """kv8/kv4 pools at D = 128 (kv4: 64 bytes a row) with the G = 6 heads
    of Qwen2-1.5B: one decode step through the paged kernel's plain version
    equals the plain attention on the dequantized pool."""
    _, _, cfg, params = _model("qwen2-1.5b", "heads")
    caches = T.cache_init(cfg, 2, 32, cache_mode="paged", block_size=8, kv_quant=kv_quant,
                          device="cpu")
    layer = caches["layers"][0]
    assert layer["k"].shape[-1] == (128 if kv_quant == "kv8" else 64)
    assert layer["k_scale"].shape == (*layer["k"].shape[:3], 1)
    out = {}
    for attn in ("pallas", "xla"):
        cs = T.cache_init(cfg, 2, 32, cache_mode="paged", block_size=8, kv_quant=kv_quant,
                          device="cpu")
        for c in cs["layers"]:
            c["table"].copy_(torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32))
        enc = EncodingConfig(backend="fused", attn_backend=attn)
        for step in range(3):
            toks = torch.tensor([[3 + step], [7 + step]])
            out[attn] = T.forward(params, toks, cfg=cfg, enc=enc, phase=Phase.DECODE,
                                  caches=cs, pos=torch.tensor([step, 9 + step]))
    torch.testing.assert_close(out["pallas"], out["xla"], **TOL)


# ---------------------------------------------------------------------------
# The bias add in bf16, and the decode weight stream of an untied head


@pytest.mark.parametrize("phase", [Phase.PREFILL, Phase.DECODE])
def test_bf16_bias_rounds_where_jax_rounds(phase):
    """y + b.astype(out_dtype): the product rounded to bf16 first, then the
    bf16 bias added and the sum rounded, as in JAX's linear_apply; equal to
    JAX's bit for bit on the same packed bf16 weight."""
    rng = np.random.RandomState(4)
    w = jnp.asarray(rng.randn(256, 192).astype(np.float32) / 14).astype(jnp.bfloat16)
    x = jnp.asarray(rng.randn(5, 192).astype(np.float32)).astype(jnp.bfloat16)
    b = jnp.asarray(rng.randn(256).astype(np.float32)).astype(jnp.bfloat16)
    jparams = {"w_packed": jpacked.ops.pack_rhs(w), "b": b}
    jphase = JPhase.PREFILL if phase is Phase.PREFILL else JPhase.DECODE
    want = jpacked.linear_apply(jparams, x, n=256, phase=jphase, enc=JENC)
    params = {k: convert.to_torch(np.asarray(v), "cpu") for k, v in jparams.items()}
    xt = convert.to_torch(np.asarray(x), "cpu")
    got = packed.linear_apply(params, xt, n=256, phase=phase,
                              enc=EncodingConfig(backend="fused"))
    bare = packed.linear_apply({"w_packed": params["w_packed"]}, xt, n=256, phase=phase,
                               enc=EncodingConfig(backend="fused"))
    assert got.dtype == bare.dtype == torch.bfloat16
    assert torch.equal(got, bare + params["b"])
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("wq", ["none", "int8", "int4"])
def test_decode_weight_stream_counts_the_head(arch, wq):
    """An untied head streams in the weight format (N = vocab, K = d_model);
    a tied one is the bf16 embedding (vocab padded to 256 rows)."""
    from repro_torch.core import encoding

    cfg = cfg_registry.get_config(arch)
    enc = EncodingConfig(weight_quant=wq)
    got = T.decode_weight_stream_bytes(cfg, enc)
    quant = packed.QUANT_KEYS[wq]
    if cfg.tie_embeddings:
        want = (cfg.vocab_size + (-cfg.vocab_size) % 256) * cfg.d_model * 2
    else:
        want = encoding.quant_weight_stream_bytes(cfg.vocab_size, cfg.d_model, quant=quant,
                                                  weight_itemsize=2, group=16)
    assert got["head"] == want
    d, hd = cfg.d_model, cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    n_k = [(hd, d), (kvd, d), (kvd, d), (d, hd), (cfg.d_ff, d), (cfg.d_ff, d), (d, cfg.d_ff)]
    per_layer = sum(encoding.quant_weight_stream_bytes(n, k, quant=quant, weight_itemsize=2,
                                                       group=16) for n, k in n_k)
    assert got["projections"] == cfg.num_layers * per_layer
