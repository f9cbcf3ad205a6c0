"""The port's Engine emits the JAX engine's tokens on the reduced
Mixtral-8x22B (4 experts, top-2, capacity 1.25, window 16).

With 3 slots a decode step has cap = int(1.25 * 3 * 2 / 4) = 1 row an
expert, so nearly every step drops pairs, and a prefill of S tokens has
int(0.625 * S): the tokens agree only if the port dispatches the JAX
engine's batch shapes, dead slots included, and copies every rule of
moe_apply.  Windowed runs serve the dense ring (resolve() turns the paged
cache off) with vectorized and grouped decode, prompts up to the window and
at twice it (16 ring slots; 32 is a multiple, where JAX's ring prefill is
right, tests/test_torch_window.py), decoding past the window.  With
sliding_window=0 (the layout of Grok-1, an MoE with no window) the same
model serves on the paged cache, with and without spec decode, so the
capacity of the verify window (slots x L rows) is held too.  Two cases
serve the bf16 model, the dtype the card serves: there one rounding apart
flips a top-2 choice and the tokens with it.  The JAX engine runs its plain
paths ("xla"), compiled with XLA's excess precision off (STRICT, see
tests/test_torch_moe.py), the port registry routing ("auto", the kernels'
plain versions on the CPU)."""

import functools

import numpy as np
import pytest

import jax

from repro.configs import registry as jcfg_registry
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import registry
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.config import EngineConfig

ROUTES = {
    "ring": (16, dict(slots=3, max_seq=64)),
    "ring_grouped": (16, dict(slots=3, max_seq=64, decode_mode="grouped")),
    "paged": (0, dict(slots=3, max_seq=64, block_size=8)),
    "paged_spec": (0, dict(slots=3, max_seq=64, block_size=8, spec_decode=True, draft_k=3)),
}
CASES = ([("none", r, "float32") for r in ROUTES]
         + [("int8", "ring", "float32"), ("int8", "paged", "float32")]
         + [("none", "ring_grouped", "bfloat16"), ("int8", "ring", "bfloat16")])
IDS = [f"{w}-{r}" + ("-bf16" if d == "bfloat16" else "") for w, r, d in CASES]
STRICT = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True)
def _clean_quarantine():
    registry.clear_quarantine()
    yield
    registry.clear_quarantine()


@functools.lru_cache(maxsize=None)
def _model(window: int, wq: str, dtype: str = "float32"):
    jcfg = jcfg_registry.get_reduced("mixtral-8x22b", sliding_window=window, dtype=dtype)
    cfg = cfg_registry.get_reduced("mixtral-8x22b", sliding_window=window, dtype=dtype)
    jenc = JEncodingConfig(enabled=True, backend="xla", attn_backend="xla", weight_quant=wq)
    jparams = jax.jit(functools.partial(JT.model_init, cfg=jcfg, enc=jenc))(
        jax.random.PRNGKey(1))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     EncodingConfig(weight_quant=wq), "cpu")
    return jcfg, jparams, jenc, cfg, params


def _prompts(window: int):
    rng = np.random.RandomState(5)
    if window:  # up to the window, and twice it
        return [rng.randint(1, 256, n).astype(np.int32) for n in (5, 16, 32, 11)]
    tiled = [np.tile(rng.randint(1, 256, 3), n).astype(np.int32) for n in (2, 5, 7)]
    return tiled + [rng.randint(1, 256, n).astype(np.int32) for n in (9, 13)]


@pytest.mark.parametrize("wq,route,dtype", CASES, ids=IDS)
def test_moe_engine_tokens_match_jax(wq, route, dtype, monkeypatch):
    window, config = ROUTES[route]
    jcfg, jparams, jenc, cfg, params = _model(window, wq, dtype)
    with monkeypatch.context() as m:  # the JAX engine jits its steps as it is built
        m.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=STRICT))
        jeng = jengine.Engine(jparams, jcfg, jenc, **config)
    eng = engine_lib.Engine(params, cfg, EncodingConfig(backend="auto", attn_backend="auto",
                                                        weight_quant=wq),
                            config=EngineConfig(**config), device="cpu")
    for e, req in ((jeng, jengine.Request), (eng, engine_lib.Request)):
        for i, p in enumerate(_prompts(window)):
            e.submit(req(uid=i, prompt=p, max_new_tokens=6))
    want = {r.uid: r.generated for r in jeng.run()}
    got = {r.uid: r.generated for r in eng.run()}
    assert got == want
    assert all(r.status == "ok" and len(r.generated) == 6 for r in eng.finished)
    st, jst = eng.stats, jeng.stats
    assert st["cache_mode"] == jst["cache_mode"] == ("dense" if window else "paged")
    assert st["decode_mode"] == jst["decode_mode"]
    assert st.get("config_downgrades", []) == jst.get("config_downgrades", [])
    assert st["attn_backend"] == jst["attn_backend"] or jst["attn_backend"] == "xla"
    if window:
        assert eng._attn_s(engine_lib.Phase.DECODE) == jeng._attn_s(engine_lib.Phase.DECODE) == 16
        assert eng.caches["layers"][0]["k"].shape[1] == 16
        assert "batch_prefill:off(model_family)" in st["config_downgrades"]
    else:
        eng.audit()
        assert st["pages_in_use"] == 0
    if route == "paged_spec":
        assert st["spec"]["proposed"] > 0 and eng.dispatches["verify"] > 0
        assert st["spec"] == {k: v for k, v in jst["spec"].items() if k in st["spec"]}


def test_moe_engine_refuses_spec_and_budget_under_a_window():
    _, _, _, cfg, _ = _model(16, "none")
    config = EngineConfig(slots=3, max_seq=64, spec_decode=True, draft_k=3,
                          token_budget=16).resolve(cfg)
    assert (config.cache_mode, config.spec_decode, config.token_budget,
            config.batch_prefill) == ("dense", False, None, False)
    assert config.downgrades == ("cache_mode:dense(sliding_window)",
                                 "spec_decode:off(model_family)",
                                 "token_budget:off(needs_verify_window)",
                                 "batch_prefill:off(model_family)")
