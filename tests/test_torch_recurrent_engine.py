"""The port's Engine on the recurrent families (reduced RWKV6-1.6B and
RecurrentGemma-9B) and on Grok-1-314B's layout, against the JAX engine.

Recurrent state has no position mask, so both engines resolve every
request to the dense cache with grouped decode, one prefill per admission
(serving/config.resolve: vectorized decode, the paged cache, batched
prefill, spec decode and the token budget are switched off).  Where no slot
is reused the port emits the JAX engine's tokens: grouped decode, and
vectorized decode requested and resolved to grouped (JAX's
test_engine_vectorized_falls_back_for_recurrent_state), greedy and
temperature-sampled, f32 and int8 weights.  RecurrentGemma's prompts reach
its 16-slot ring (reduced window) and decode past it; prompts longer than
the ring stay at a multiple of it, where JAX's ring prefill is right
(tests/test_torch_window.py).

Where a slot is reused the two differ on purpose: the JAX engine prefills
the new request from the state its slot's last request left (its per-slot
prefill runs on the slot's old rows and nothing resets them), while the
port starts every admission from zero state and emits a fresh engine's
tokens.  test_reused_slot_starts_from_zero_state keeps JAX's fault on
record.

Grok-1-314B is an MoE with no window: the reduced config (4 experts, top-2)
serves on the paged cache with vectorized decode and spec decode, and emits
the JAX engine's tokens.  The JAX engines run their plain paths ("xla"),
compiled with XLA's excess precision off (STRICT, tests/test_torch_moe.py);
the port runs registry routing ("auto", the kernels' plain versions on the
CPU).  f32 unless a case says otherwise."""

import functools

import numpy as np
import pytest
import torch

import jax

from repro.configs import registry as jcfg_registry
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import registry
from repro_torch.models import transformer as T
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.config import EngineConfig

STRICT = {"xla_allow_excess_precision": False}
AUTO = EncodingConfig(backend="auto", attn_backend="auto")
ARCHS = ("rwkv6-1.6b", "recurrentgemma-9b")
ROUTES = {
    "grouped": dict(slots=3, max_seq=48, decode_mode="grouped"),
    "vectorized": dict(slots=3, max_seq=48),  # resolved to grouped
    "sampled": dict(slots=3, max_seq=48, sample="temperature", seed=7),
}
CASES = ([(a, r, "none") for a in ARCHS for r in ROUTES]
         + [(a, "grouped", "int8") for a in ARCHS])
IDS = [f"{a}-{r}-{w}" for a, r, w in CASES]


@pytest.fixture(autouse=True)
def _clean_quarantine():
    registry.clear_quarantine()
    yield
    registry.clear_quarantine()


@functools.lru_cache(maxsize=None)
def _model(arch: str, wq: str = "none", seed: int = 1, **over):
    jcfg = jcfg_registry.get_reduced(arch, **over)
    cfg = cfg_registry.get_reduced(arch, **over)
    jenc = JEncodingConfig(enabled=True, backend="xla", attn_backend="xla", weight_quant=wq)
    jparams = jax.jit(functools.partial(JT.model_init, cfg=jcfg, enc=jenc))(
        jax.random.PRNGKey(seed))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     EncodingConfig(weight_quant=wq), "cpu")
    return jcfg, jparams, jenc, cfg, params


def _jax_engine(jparams, jcfg, jenc, **config):
    with pytest.MonkeyPatch.context() as m:  # the JAX engine jits its steps as it is built
        m.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=STRICT))
        return jengine.Engine(jparams, jcfg, jenc, **config)


def _serve(eng, req_cls, prompts, max_new, temps=None):
    for i, p in enumerate(prompts):
        kw = {} if temps is None else {"temperature": temps[i]}
        assert eng.submit(req_cls(uid=i, prompt=p, max_new_tokens=max_new, **kw))
    return {r.uid: r.generated for r in eng.run()}


@pytest.mark.parametrize("arch,route,wq", CASES, ids=IDS)
def test_recurrent_engine_tokens_match_jax(arch, route, wq):
    """No slot reused (as many slots as requests): the port's tokens ==
    the JAX engine's, staggered prompt lengths so grouped decode runs
    several groups a step; the resolved modes and downgrades match."""
    jcfg, jparams, jenc, cfg, params = _model(arch, wq)
    config = ROUTES[route]
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 256, n).astype(np.int32) for n in (5, 16, 11)]
    temps = [0.7, 0.0, 1.3] if route == "sampled" else None
    jeng = _jax_engine(jparams, jcfg, jenc, **config)
    eng = engine_lib.Engine(params, cfg, EncodingConfig(backend="auto", attn_backend="auto",
                                                        weight_quant=wq),
                            config=EngineConfig(**config), device="cpu")
    want = _serve(jeng, jengine.Request, prompts, 8, temps)
    got = _serve(eng, engine_lib.Request, prompts, 8, temps)
    assert got == want
    assert all(r.status == "ok" and len(r.generated) == 8 for r in eng.finished)
    st, jst = eng.stats, jeng.stats
    assert (st["cache_mode"], st["decode_mode"]) == (jst["cache_mode"], jst["decode_mode"]) \
        == ("dense", "grouped")
    assert st.get("config_downgrades", []) == jst.get("config_downgrades", [])
    assert "batch_prefill:off(model_family)" in st["config_downgrades"]
    assert st["attn_backend"] == jst["attn_backend"] or jst["attn_backend"] == "xla"
    assert eng._attn_s(Phase.DECODE) == jeng._attn_s(Phase.DECODE)
    assert st["dispatches"]["prefill"] == len(prompts)
    if route == "sampled":
        assert eng._step_idx == jeng._step_idx > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_reused_slot_starts_from_zero_state(arch):
    """One slot, request A (4 tokens) then request B (5 tokens), 6 new
    tokens each, on JAX's PRNGKey(0) weights: the port's B after A equals
    B on a fresh engine, and equals the JAX engine's fresh B.  The JAX
    engine's B after A differs from its fresh B: its prefill continues from
    A's recurrent state (JAX engine.py's per-slot prefill on
    slot_slice(self.caches, s), which _finish_slot never resets); the port
    diverges from it on purpose."""
    jcfg, jparams, jenc, cfg, params = _model(arch, seed=0)
    rng = np.random.RandomState(7)
    pa = rng.randint(1, cfg.vocab_size, 4).astype(np.int32)
    pb = rng.randint(1, cfg.vocab_size, 5).astype(np.int32)
    config = dict(slots=1, max_seq=32)

    def port(prompts):
        eng = engine_lib.Engine(params, cfg, AUTO, config=EngineConfig(**config), device="cpu")
        return _serve(eng, engine_lib.Request, prompts, 6)

    def jax_(prompts):
        return _serve(_jax_engine(jparams, jcfg, jenc, **config), jengine.Request, prompts, 6)

    fresh, after = port([pb])[0], port([pa, pb])[1]
    jfresh, jafter = jax_([pb])[0], jax_([pa, pb])[1]
    assert after == fresh == jfresh
    assert jafter != jfresh  # the reference's state leak, kept on record


@pytest.mark.parametrize("arch", ARCHS)
def test_more_requests_than_slots_equal_fresh_engines(arch):
    """Five requests through two slots (every slot reused) emit, request
    by request, the tokens each emits alone on a fresh engine."""
    _, _, _, cfg, params = _model(arch)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, 256, n).astype(np.int32) for n in (7, 3, 16, 9, 12)]

    def run(ps, slots):
        eng = engine_lib.Engine(params, cfg, AUTO, device="cpu",
                                config=EngineConfig(slots=slots, max_seq=48))
        return list(_serve(eng, engine_lib.Request, ps, 5).values())

    shared = _serve(engine_lib.Engine(params, cfg, AUTO, device="cpu",
                                      config=EngineConfig(slots=2, max_seq=48)),
                    engine_lib.Request, prompts, 5)
    assert [shared[i] for i in range(len(prompts))] == [run([p], 1)[0] for p in prompts]


def test_chunked_prefill_matches_single_shot_rwkv():
    """make_chunked_prefill_step carries RWKV's state (S and the token
    shifts) from chunk to chunk: the last logits, every state leaf and the
    next decode equal a single-shot prefill, as JAX's
    test_chunked_prefill_matches_single_shot runs it (and JAX's own
    chunked prefill's logits)."""
    jcfg, jparams, jenc, cfg, params = _model("rwkv6-1.6b")
    b, s, chunk = 2, 24, 8
    toks = torch.from_numpy(np.random.RandomState(1).randint(1, 256, (b, s)).astype(np.int32))
    enc = EncodingConfig(backend="fused", attn_backend="pallas")
    c1 = T.cache_init(cfg, b, s + 4, device="cpu")
    l1 = T.forward(params, toks, cfg=cfg, enc=enc, phase=Phase.PREFILL, caches=c1,
                   last_logits_only=True)
    c2 = T.cache_init(cfg, b, s + 4, device="cpu")
    l2, c2 = engine_lib.make_chunked_prefill_step(cfg, enc, chunk=chunk)(params, toks, c2)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=2e-4, atol=2e-4)
    for a, bb in zip(c1["layers"], c2["layers"]):
        for name in a:
            np.testing.assert_allclose(bb[name].numpy(), a[name].numpy(), rtol=2e-4, atol=2e-4)
    tok = toks[:, -1:]
    d1 = T.forward(params, tok, cfg=cfg, enc=enc, phase=Phase.DECODE, caches=c1, pos=s)
    d2 = T.forward(params, tok, cfg=cfg, enc=enc, phase=Phase.DECODE, caches=c2, pos=s)
    np.testing.assert_allclose(d2.numpy(), d1.numpy(), rtol=2e-4, atol=2e-4)
    jchunked = jengine.make_chunked_prefill_step(jcfg, jenc, chunk=chunk)
    jl, _ = jchunked(jparams, jax.numpy.asarray(toks.numpy()), JT.cache_init(jcfg, b, s + 4))
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_poison_follows_jax_on_every_state_leaf(arch):
    """poison_slot_kv on the dense cache: JAX's rule on every leaf, K/V rows
    and recurrent state (leaf[s, pos mod leaf.shape[1]] = NaN), the same
    leaves as the JAX engine poisons; the slot's next logits are non-finite
    and the guard finishes it alone."""
    jcfg, jparams, jenc, cfg, params = _model(arch)
    config = dict(slots=2, max_seq=48)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 256, n).astype(np.int32) for n in (6, 9)]
    eng = engine_lib.Engine(params, cfg, AUTO, config=EngineConfig(**config), device="cpu")
    jeng = _jax_engine(jparams, jcfg, jenc, **config)
    for e, req in ((eng, engine_lib.Request), (jeng, jengine.Request)):
        for i, p in enumerate(prompts):
            e.submit(req(uid=i, prompt=p, max_new_tokens=4))
        e.step()
        e.poison_slot_kv(1)
    pat = cfg.block_pattern
    n_groups = cfg.num_layers // len(pat)
    for li, layer in enumerate(eng.caches["layers"]):
        if li < n_groups * len(pat):
            jl = jax.tree.map(lambda a: np.asarray(a[li // len(pat)]),
                              jeng.caches["groups"][li % len(pat)])
        else:
            jl = jax.tree.map(np.asarray, jeng.caches["tail"][li - n_groups * len(pat)])
        for name, leaf in layer.items():
            assert np.array_equal(np.isnan(leaf.numpy()), np.isnan(jl[name])), (li, name)
            assert torch.isnan(leaf[1]).any() and not torch.isnan(leaf[0]).any()
    eng.run()
    status = {r.uid: r.status for r in eng.finished}
    assert status == {0: "ok", 1: "error"} and eng.lifecycle["guard_trips"] == 1


@functools.lru_cache(maxsize=None)
def _grok():
    return _model("grok-1-314b")


@pytest.mark.parametrize("spec", [False, True], ids=["paged", "paged_spec"])
def test_grok_serves_paged_with_spec_like_jax(spec):
    """Grok-1-314B's layout (MoE, no window), reduced: the paged cache with
    vectorized decode, with and without spec decode (the verify window's
    slots x L rows take capacity like any dispatch), emits the JAX engine's
    tokens, and its pages all return."""
    jcfg, jparams, jenc, cfg, params = _grok()
    assert cfg.num_experts == 4 and cfg.sliding_window == 0 and not cfg.tie_embeddings
    config = dict(slots=3, max_seq=64, block_size=8)
    if spec:
        config.update(spec_decode=True, draft_k=3)
    rng = np.random.RandomState(5)
    prompts = [np.tile(rng.randint(1, 256, 3), n).astype(np.int32) for n in (2, 5, 7)]
    prompts += [rng.randint(1, 256, n).astype(np.int32) for n in (9, 13)]
    jeng = _jax_engine(jparams, jcfg, jenc, **config)
    eng = engine_lib.Engine(params, cfg, AUTO, config=EngineConfig(**config), device="cpu")
    want = _serve(jeng, jengine.Request, prompts, 6)
    got = _serve(eng, engine_lib.Request, prompts, 6)
    assert got == want
    st = eng.stats
    assert (st["cache_mode"], st["decode_mode"]) == ("paged", "vectorized")
    eng.audit()
    assert st["pages_in_use"] == 0
    if spec:
        assert st["spec"]["proposed"] > 0 and eng.dispatches["verify"] > 0
        assert st["spec"] == {k: v for k, v in jeng.stats["spec"].items() if k in st["spec"]}
