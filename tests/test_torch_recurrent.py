"""The recurrent token mixers of the port (models/recurrent.py: RWKV-6 and
RG-LRU) and the two recurrent models (RWKV6-1.6B, RecurrentGemma-9B) against
the JAX package, on the reduced configs and on weights converted from the
JAX pytree.

Inputs and states are drawn from a seed with numpy.  The port runs its
projections through registry routing ("fused", the kernels' plain versions
on the CPU); the JAX side runs its plain paths ("xla").  Tolerances, stated
where they apply:
  * f32 modules and models: rtol = atol = 1e-5 for a block's outputs and
    state, 1e-4 for model logits (as tests/test_torch_archs.py): the port
    keeps JAX's operations in JAX's order (the chunked wkv of 16, the clip
    and the -5 floor, associative_scan's recursion), so what remains is f32
    summation order inside einsums and matmuls;
  * the causal conv: 1e-6 (the same products added in the same order);
  * converted weights: bit for bit in every weight format;
  * bf16 (JAX compiled with XLA's excess precision off, so that a bf16
    cast rounds where the program says): the RWKV and RG-LRU blocks' bf16
    outputs and states bit for bit, their f32 states to 1e-5; RWKV6's logits within 2 bf16 ulps of their
    magnitude (|diff| <= 2 * 2^-8 * max(|logit|, 1); the head's f32 sums
    in another order).  RecurrentGemma's bf16 logits are not compared end
    to end: its attention layers (the port's attention, not this slice's
    code) differ from JAX's bf16 attention by one ulp at ~0.2% of their
    outputs, which the following layers carry to several ulps of a logit.
  * int4 weights end to end: not compared in logits.  w4a8 quantizes each
    projection's input rows to int8, and an input one f32 ulp from JAX's
    can move a code by one step (tests/test_torch_archs_quant.py); int4's
    conversion is held bit for bit below, int8's prefill logits to 1e-4.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jcfg_registry
from repro.core.encoding import Phase as JPhase
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.models import blocks as JB
from repro.models import recurrent as JR
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.models import blocks as B
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T

ARCHS = ("rwkv6-1.6b", "recurrentgemma-9b")
MOD_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STRICT = {"xla_allow_excess_precision": False}
ENC = EncodingConfig(enabled=True, backend="fused", attn_backend="pallas")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: the plain versions run many small
    ops, which more threads only slow down where the suite's workers already
    share every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jenc(wq="none"):
    return JEncodingConfig(enabled=True, backend="xla", attn_backend="xla", weight_quant=wq)


def _t(a) -> torch.Tensor:
    return convert.to_torch(np.asarray(a), "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@functools.lru_cache(maxsize=None)
def _model(arch: str, wq: str = "none", dtype: str = "float32"):
    jcfg = jcfg_registry.get_reduced(arch, dtype=dtype)
    cfg = cfg_registry.get_reduced(arch, dtype=dtype)
    jenc = _jenc(wq)
    jparams = jax.jit(functools.partial(JT.model_init, cfg=jcfg, enc=jenc))(
        jax.random.PRNGKey(1))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     EncodingConfig(weight_quant=wq), "cpu")
    return jcfg, jparams, cfg, params


# ---------------------------------------------------------------------------
# The chunked wkv core and the conv


@pytest.mark.parametrize("s", [1, 15, 16, 17, 40])
def test_wkv_chunked_matches_jax(s):
    """Chunks of 16 (the last zero-padded), from a nonzero state, with
    log-decays down to the -5 floor.  There a chunk's ratios exp(+-Λ) span
    up to e^80, so f32 ordering differences scale with the largest output:
    atol = 1e-5 x max|out| (and the same for the state)."""
    rng = np.random.RandomState(s)
    b, h, hd = 2, 4, 16
    r, k, v = (rng.randn(b, s, h, hd).astype(np.float32) for _ in range(3))
    logw = -rng.uniform(0.0, 5.0, (b, s, h, hd)).astype(np.float32)
    u = (0.1 * rng.randn(h, hd)).astype(np.float32)
    state = rng.randn(b, h, hd, hd).astype(np.float32)
    jout, jstate = JR._wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u, state)))
    out, new_state = R._wkv_chunked(*(torch.from_numpy(a) for a in (r, k, v, logw, u, state)))
    assert out.shape == (b, s, h, hd) and new_state.dtype == torch.float32
    for got, want in ((out, np.asarray(jout)), (new_state, np.asarray(jstate))):
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("s", [1, 7])
def test_causal_conv1d_matches_jax(s, dtype):
    rng = np.random.RandomState(3)
    b, w, c = 2, 4, 64
    x = rng.randn(b, s, c).astype(dtype)
    wt = (0.1 * rng.randn(w, c)).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    state = rng.randn(b, w - 1, c).astype(dtype)
    jout, jst = JR._causal_conv1d(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
                                  jnp.asarray(state))
    out, st = R._causal_conv1d(_t(x), _t(wt), _t(bias), _t(state))
    assert out.dtype == _t(x).dtype and st.dtype == _t(state).dtype
    np.testing.assert_allclose(_np(out), np.asarray(jout, np.float32), rtol=1e-6, atol=1e-6)
    assert np.array_equal(_np(st), np.asarray(jst, np.float32))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_associative_scan_matches_jax(n):
    """The RG-LRU prefill's scan: JAX's recursion over time, whole tensors."""
    rng = np.random.RandomState(n)
    a = rng.uniform(0.5, 1.0, (2, n, 8)).astype(np.float32)
    b = rng.randn(2, n, 8).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    ja, jb = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    pa, pb = R.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(_np(pa), np.asarray(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(pb), np.asarray(jb), rtol=1e-6, atol=1e-6)
    seq = np.zeros_like(b[:, 0])  # the recurrence it computes: h = a h + b
    for t in range(n):
        seq = a[:, t] * seq + b[:, t]
    np.testing.assert_allclose(_np(pb[:, -1]), seq, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The blocks: outputs and new state, at prefill and at decode


def _block(arch):
    """(jcfg, cfg, JAX block params, port block params) of the reduced
    model's first layer."""
    jcfg, jparams, cfg, params = _model(arch)
    jblock = jax.tree.map(lambda a: a[0], jparams["groups"][0])
    return jcfg, cfg, jblock, params["layers"][0]


def _state(arch, cfg, b, rng):
    if arch == "rwkv6-1.6b":
        h = cfg.d_model // cfg.rwkv_head_dim
        return {"S": rng.randn(b, h, cfg.rwkv_head_dim, cfg.rwkv_head_dim),
                "shift_tm": rng.randn(b, cfg.d_model), "shift_cm": rng.randn(b, cfg.d_model)}
    return {"h": rng.randn(b, cfg.rnn_width), "conv": rng.randn(b, cfg.conv_width - 1,
                                                                 cfg.rnn_width)}


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_apply_matches_jax(arch, phase):
    jcfg, cfg, jblock, block = _block(arch)
    rng = np.random.RandomState(11)
    b, s = 2, (1 if phase == "decode" else 19)
    x = rng.randn(b, s, cfg.d_model).astype(np.float32)
    state = {k: v.astype(np.float32) for k, v in _state(arch, cfg, b, rng).items()}
    jph, ph = ((JPhase.DECODE, Phase.DECODE) if phase == "decode"
               else (JPhase.PREFILL, Phase.PREFILL))
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    pstate = {k: torch.from_numpy(v) for k, v in state.items()}
    if arch == "rwkv6-1.6b":
        jout, jnew = JR.rwkv_apply(jblock, jnp.asarray(x), cfg=jcfg, enc=_jenc(), phase=jph,
                                   state=jstate)
        out, new = R.rwkv_apply(block, torch.from_numpy(x), cfg=cfg, enc=ENC, phase=ph,
                                state=pstate)
    else:
        jout, jnew = JR.rglru_apply(jblock["rglru"], jnp.asarray(x), cfg=jcfg, enc=_jenc(),
                                    phase=jph, state=jstate)
        out, new = R.rglru_apply(block["rglru"], torch.from_numpy(x), cfg=cfg, enc=ENC,
                                 phase=ph, state=pstate)
    np.testing.assert_allclose(_np(out), np.asarray(jout), **MOD_TOL)
    assert sorted(new) == sorted(jnew)
    for name in new:
        assert new[name].shape == jnew[name].shape and new[name].dtype == torch.float32
        np.testing.assert_allclose(_np(new[name]), np.asarray(jnew[name]), **MOD_TOL)
    # The input state is read, never written.
    assert all(np.array_equal(pstate[k].numpy(), state[k]) for k in state)


def test_rwkv_decay_is_clipped_then_floored():
    """w = exp(-exp(clip(w0 + lora, -20, 1.6))), the log-decay floored at
    -5: a large pre-activation gives log-decay -exp(1.6) exactly (the clip
    binds; the floor lies below it), a very negative one -exp(-20)."""
    jcfg, cfg, jblock, block = _block("rwkv6-1.6b")
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 3, cfg.d_model).astype(np.float32))
    seen = []
    orig = R._wkv_chunked

    def spy(r, k, v, logw, u, state):
        seen.append(logw)
        return orig(r, k, v, logw, u, state)

    R._wkv_chunked = spy
    try:
        for w0 in (10.0, -40.0):
            R.rwkv_apply(dict(block, w0=torch.full_like(block["w0"], w0)), x, cfg=cfg,
                         enc=ENC, phase=Phase.PREFILL, state=None)
    finally:
        R._wkv_chunked = orig
    assert torch.all(seen[0] == -torch.exp(torch.tensor(1.6)))
    assert torch.all(seen[1] == -torch.exp(torch.tensor(-20.0)))
    assert R._LOG_DECAY_FLOOR == -5.0 and R.RWKV_CHUNK == 16


# ---------------------------------------------------------------------------
# The models


def _tokens(b, s, seed=1):
    return np.random.RandomState(seed).randint(1, 256, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_state_match_jax(arch):
    jcfg, jparams, cfg, params = _model(arch)
    toks = _tokens(2, 13)
    jcaches = JT.cache_init(jcfg, 2, 32)
    jlogits, jcaches, _ = JT.forward(jparams, {"tokens": jnp.asarray(toks)}, cfg=jcfg,
                                     enc=_jenc(), phase=JPhase.PREFILL, caches=jcaches)
    caches = T.cache_init(cfg, 2, 32, device="cpu")
    logits = T.forward(params, torch.from_numpy(toks), cfg=cfg, enc=ENC,
                       phase=Phase.PREFILL, caches=caches)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **LOGIT_TOL)
    # Layer g * len(pattern) + i of the port is position i of JAX's group g;
    # the tail follows.
    pat = cfg.block_pattern
    n_groups = cfg.num_layers // len(pat)
    assert T.layer_types(cfg) == list(pat) * n_groups + list(pat[:cfg.num_layers % len(pat)])
    for li, layer in enumerate(caches["layers"]):
        if li < n_groups * len(pat):
            jl = jax.tree.map(lambda a: a[li // len(pat)], jcaches["groups"][li % len(pat)])
        else:
            jl = jcaches["tail"][li - n_groups * len(pat)]
        assert sorted(layer) == sorted(jl)
        for name, leaf in layer.items():
            np.testing.assert_allclose(_np(leaf), np.asarray(jl[name], np.float32), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_continuity(arch):
    """As JAX's test_serving._continuity: prefill 8 tokens, decode 4 one at
    a time; every logit row equals JAX's uncached forward over all 12."""
    jcfg, jparams, cfg, params = _model(arch)
    toks = _tokens(2, 12, seed=4)
    jfull, _, _ = JT.forward(jparams, {"tokens": jnp.asarray(toks)}, cfg=jcfg, enc=_jenc(),
                             phase=JPhase.PREFILL)
    jfull = np.asarray(jfull)
    caches = T.cache_init(cfg, 2, 12, device="cpu")
    logits = T.forward(params, torch.from_numpy(toks[:, :8]), cfg=cfg, enc=ENC,
                       phase=Phase.PREFILL, caches=caches)
    np.testing.assert_allclose(_np(logits), jfull[:, :8], **LOGIT_TOL)
    for i in range(8, 12):
        step = T.forward(params, torch.from_numpy(toks[:, i:i + 1]), cfg=cfg, enc=ENC,
                         phase=Phase.DECODE, caches=caches, pos=i)
        np.testing.assert_allclose(_np(step[:, 0]), jfull[:, i], **LOGIT_TOL)


@pytest.mark.parametrize("wq", ["none", "int8", "int4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_every_format(arch, wq):
    """bf16 weights (the activation dtype the card serves), int8 and int4:
    every leaf of every layer is JAX's, bit for bit, in layer order; the
    recurrent leaves (mu, w0, w_lora_*, u, cm_mu, conv_w, conv_b, lam) as
    they are."""
    jcfg, jparams, cfg, params = _model(arch, wq, "bfloat16")
    pat = cfg.block_pattern
    n_groups = cfg.num_layers // len(pat)
    assert len(params["layers"]) == cfg.num_layers

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, prefix + (k,))
        else:
            yield prefix, tree

    names = set()
    for li, layer in enumerate(params["layers"]):
        if li < n_groups * len(pat):
            jl = jax.tree.map(lambda a: np.asarray(a[li // len(pat)]),
                              jparams["groups"][li % len(pat)])
        else:
            jl = jax.tree.map(np.asarray, jparams["tail"][li - n_groups * len(pat)])
        got, want = dict(leaves(layer)), dict(leaves(jl))
        assert sorted(got) == sorted(want)
        for path, leaf in got.items():
            ref = want[path]
            names.add(path[-1])
            assert tuple(leaf.shape) == ref.shape
            if ref.dtype.name == "bfloat16":
                assert torch.equal(leaf.view(torch.int16),
                                   torch.from_numpy(ref.view(np.int16)))
            else:
                assert np.array_equal(leaf.numpy(), ref), path
    recurrent = ({"mu", "w0", "w_lora_a", "w_lora_b", "u", "cm_mu"} if arch == "rwkv6-1.6b"
                 else {"conv_w", "conv_b", "lam"})
    weight = {"none": "w_packed", "int8": "w_q", "int4": "w_q4"}[wq]
    assert recurrent | {weight} <= names


@pytest.mark.parametrize("wq", ["int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_prefill_matches_jax(arch, wq):
    """f32 activations on int8 weights: the w8a8 projections (the quantizer
    bit for bit, tests/test_torch_quant.py) inside the recurrent blocks,
    logits to 1e-4."""
    jcfg, jparams, cfg, params = _model(arch, wq)
    toks = _tokens(2, 13, seed=6)
    jlogits, _, _ = JT.forward(jparams, {"tokens": jnp.asarray(toks)}, cfg=jcfg,
                               enc=_jenc(wq), phase=JPhase.PREFILL)
    enc = EncodingConfig(backend="fused", attn_backend="pallas", weight_quant=wq)
    logits = T.forward(params, torch.from_numpy(toks), cfg=cfg, enc=enc, phase=Phase.PREFILL)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **LOGIT_TOL)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_blocks_match_strict_jax(arch, phase):
    """Every recurrent block of the bf16 reduced model on JAX's own input
    (its hidden states after a 10-token prefill, then one decode step from
    the prefill's state), against JAX compiled with excess precision off:
    the bf16 output and the bf16 shift / conv states bit for bit, the f32
    states S and h to 1e-5."""
    jcfg, jparams, cfg, params = _model(arch, "none", "bfloat16")
    jenc = _jenc()
    toks = jnp.asarray(_tokens(2, 11, seed=8))
    pat = cfg.block_pattern
    n_groups = cfg.num_layers // len(pat)

    def apply(t, prm, xx, st, ph):
        return JB.BLOCKS[t][1](prm, xx, cfg=jcfg, enc=jenc, phase=ph, cache=st, pos=10)[:2]

    x = jparams["embed"][toks[:, :10]].astype(jnp.bfloat16)
    xd = jparams["embed"][toks[:, 10:]].astype(jnp.bfloat16)
    checked = 0
    for li, t in enumerate(T.layer_types(cfg)):
        jl = (jax.tree.map(lambda a: a[li // len(pat)], jparams["groups"][li % len(pat)])
              if li < n_groups * len(pat) else jparams["tail"][li - n_groups * len(pat)])
        jst = JB.BLOCKS[t][2](jcfg, 2, 16)
        pre = jax.jit(functools.partial(apply, t, ph=JPhase.PREFILL), compiler_options=STRICT)
        dec = jax.jit(functools.partial(apply, t, ph=JPhase.DECODE), compiler_options=STRICT)
        jy, jst1 = pre(jl, x, jst)
        jyd, jst2 = dec(jl, xd, jst1)
        if t != "attn":
            if phase == "prefill":
                inp, state, want, want_state = x, jst, jy, jst1
                ph = Phase.PREFILL
            else:
                inp, state, want, want_state = xd, jst1, jyd, jst2
                ph = Phase.DECODE
            cache = {k: _t(v) for k, v in state.items()}
            got = B.BLOCKS[t][1](params["layers"][li], _t(inp), cfg=cfg, enc=ENC, phase=ph,
                                cache=cache, pos=10)
            assert torch.equal(got.view(torch.int16), _t(want).view(torch.int16)), (li, t)
            for name, leaf in cache.items():
                ref = _t(want_state[name])
                if leaf.dtype == torch.bfloat16:
                    assert torch.equal(leaf, ref), (li, t, name)
                else:  # S and h: f32 sums (einsums, the scan) in XLA's order
                    np.testing.assert_allclose(_np(leaf), _np(ref), **MOD_TOL)
            checked += 1
        x, xd = jy, jyd
    assert checked == sum(t != "attn" for t in T.layer_types(cfg))


def test_bf16_forward_matches_strict_jax():
    """The bf16 reduced RWKV6 (the dtype the card serves), prefill then two
    decode steps, against JAX compiled with excess precision off: logits
    within 2 bf16 ulps of their magnitude."""
    arch = "rwkv6-1.6b"
    jcfg, jparams, cfg, params = _model(arch, "none", "bfloat16")
    toks = _tokens(2, 12, seed=8)

    def run(params_, toks_, caches_, pos, phase):
        return JT.forward(params_, {"tokens": toks_}, cfg=jcfg, enc=_jenc(), phase=phase,
                          caches=caches_, pos=pos)

    prefill = jax.jit(functools.partial(run, pos=0, phase=JPhase.PREFILL),
                      compiler_options=STRICT)
    decode = jax.jit(functools.partial(run, phase=JPhase.DECODE), compiler_options=STRICT)
    jlogits, jcaches, _ = prefill(jparams, jnp.asarray(toks[:, :10]), JT.cache_init(jcfg, 2, 16))
    jrows = [np.asarray(jlogits, np.float32)]
    caches = T.cache_init(cfg, 2, 16, device="cpu")
    rows = [_np(T.forward(params, torch.from_numpy(toks[:, :10]), cfg=cfg, enc=ENC,
                          phase=Phase.PREFILL, caches=caches))]
    for i in (10, 11):
        jl, jcaches, _ = decode(jparams, jnp.asarray(toks[:, i:i + 1]), jcaches, i)
        jrows.append(np.asarray(jl, np.float32))
        rows.append(_np(T.forward(params, torch.from_numpy(toks[:, i:i + 1]), cfg=cfg,
                                  enc=ENC, phase=Phase.DECODE, caches=caches, pos=i)))
    for got, want in zip(rows, jrows):
        limit = 2 * 2.0**-8 * np.maximum(np.abs(want), 1.0)
        assert np.all(np.abs(got - want) <= limit), np.max(np.abs(got - want) / limit)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_weight_stream_counts_recurrent_layers(arch):
    """An RWKV layer streams 5 time-mix (D x D) and 3 channel-mix projections
    and its f32 decay LoRA; an RG-LRU layer its 5 projections (D x rw, rw x
    rw, rw x D) and its SwiGLU MLP; RecurrentGemma's attention layers their
    4 projections and MLP, and its tied head the embedding."""
    for wq in ("none", "int8"):
        cfg = cfg_registry.get_config(arch)
        enc = EncodingConfig(weight_quant=wq)
        got = T.decode_weight_stream_bytes(cfg, enc)
        per = 1 if wq == "int8" else 2  # weight bytes an element
        scales = (lambda n: 4 * n) if wq == "int8" else (lambda n: 0)
        d, f = cfg.d_model, cfg.d_ff

        def w(n, k):
            return n * k * per + scales(n)

        if arch == "rwkv6-1.6b":
            layer = 5 * w(d, d) + w(f, d) + w(d, f) + w(d, d) + 2 * d * (d // 32) * 4
            want = {"projections": cfg.num_layers * layer, "head": w(cfg.vocab_size, d)}
        else:
            rw = cfg.rnn_width
            mlp = 2 * w(f, d) + w(d, f)
            rec = 2 * w(rw, d) + 2 * w(rw, rw) + w(d, rw) + mlp
            hd = cfg.num_heads * cfg.head_dim
            kvd = cfg.num_kv_heads * cfg.head_dim
            attn = w(hd, d) + 2 * w(kvd, d) + w(d, hd) + mlp
            n_attn = cfg.num_layers // 3
            want = {"projections": n_attn * attn + (cfg.num_layers - n_attn) * rec,
                    "head": cfg.vocab_size * d * 2}
        assert got == want, (wq, got, want)


def test_recurrent_caches_and_refusals():
    """Dense caches hold each layer's state (f32 S and h, the activation
    dtype's shift and conv states); the paged cache is refused for a
    recurrent pattern, as in JAX, and for an enc-dec one, whose dense layer
    caches hold the self K/V rows and the cross K/V."""
    cfg = cfg_registry.get_reduced("recurrentgemma-9b", dtype="bfloat16")
    caches = T.cache_init(cfg, 3, 40, device="cpu")
    kinds = [sorted(layer) for layer in caches["layers"]]
    assert kinds == [["conv", "h"], ["conv", "h"], ["k", "v"]] * 2 + [["conv", "h"]] * 2
    rec, att = caches["layers"][0], caches["layers"][2]
    assert rec["h"].dtype == torch.float32 and rec["conv"].dtype == torch.bfloat16
    assert rec["conv"].shape == (3, cfg.conv_width - 1, cfg.rnn_width)
    assert att["k"].shape == (3, cfg.sliding_window, cfg.num_kv_heads, cfg.head_dim)
    rw = cfg_registry.get_reduced("rwkv6-1.6b")
    st = T.cache_init(rw, 2, 40, device="cpu")["layers"][0]
    assert st["S"].shape == (2, 4, 16, 16) and st["shift_tm"].shape == (2, 64)
    for arch in ARCHS:
        with pytest.raises(ValueError, match="attention-only"):
            T.cache_init(cfg_registry.get_reduced(arch), 2, 32, cache_mode="paged",
                         device="cpu")
    whisper = dataclasses.replace(cfg, family="encdec", block_pattern=("encdec_attn",))
    layer = T.cache_init(whisper, 1, 8, device="cpu")["layers"][0]
    assert sorted(layer) == ["cross_k", "cross_v", "k", "v"]
    with pytest.raises(ValueError, match="attention-only"):
        T.cache_init(whisper, 1, 8, cache_mode="paged", device="cpu")
