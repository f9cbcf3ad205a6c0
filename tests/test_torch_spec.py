"""Speculative decode in the port (serving/spec.py, Engine(spec_decode=True))
against the JAX package, on the reduced Llama-3.2-1B with converted weights.

The port's engine runs with registry routing (backend and attn_backend
"auto"): on the CPU a verify window of slots x L > 8 rows goes through the
packed mmt4d GEMM's plain version, fewer rows through the fused GEMV's, and
attention through the paged decode kernel's plain version.  The JAX engine
runs its plain paths (backend and attn_backend "xla"), as its own spec
harness does.  Both sides compute in f32; greedy tokens must be identical,
and so must the spec counters (proposed, accepted, committed, pool
deferrals) and the preemption count."""

import numpy as np
import pytest

import jax

from repro.configs import registry as jcfg_registry
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro.serving import spec as jspec
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import registry
from repro_torch.serving import engine as engine_lib
from repro_torch.serving import spec
from repro_torch.serving.config import EngineConfig

JENC = JEncodingConfig(enabled=True, backend="xla", attn_backend="xla")
ENC = EncodingConfig(enabled=True, backend="auto", attn_backend="auto")
SPEC_KEYS = ("steps", "slot_steps", "proposed", "accepted", "committed", "pool_deferred")


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


def _run(model, stream, drafter=None, **config):
    """Drive the JAX and the port engine over the same (arrival_step,
    prompt, max_new, eos) stream, auditing the port's pool every step.
    Returns (jax tokens, port tokens, jax engine, port engine)."""
    jcfg, jparams, cfg, params = model
    jeng = jengine.Engine(jparams, jcfg, JENC, drafter=drafter, **config)
    eng = engine_lib.Engine(params, cfg, ENC, config=EngineConfig(**config), device="cpu",
                            drafter=drafter)
    outs = []
    for e, req_cls in ((jeng, jengine.Request), (eng, engine_lib.Request)):
        pending = sorted(enumerate(stream), key=lambda t: t[1][0])
        i = step = 0
        while i < len(pending) or e.queue or any(r is not None for r in e.slot_req):
            while i < len(pending) and pending[i][1][0] <= step:
                uid, (_, prompt, max_new, eos) = pending[i]
                e.submit(req_cls(uid=uid, prompt=prompt, max_new_tokens=max_new, eos_id=eos))
                i += 1
            e.step()
            e.audit()
            step += 1
            assert step < 2000, "engine failed to drain the stream"
        outs.append({r.uid: list(r.generated) for r in e.finished})
    assert all(r.status == "ok" for r in eng.finished)
    return outs[0], outs[1], jeng, eng


def _spec_stream(vocab, seed, *, n=5):
    """The JAX harness's stream: repetition-heavy prompts (drafts proposed)
    between incompressible ones (no drafts), staggered arrivals."""
    rng = np.random.RandomState(seed)
    stream = []
    for i in range(n):
        if i % 2 == 0:
            phrase = rng.randint(1, vocab, rng.randint(2, 4)).astype(np.int32)
            prompt = np.tile(phrase, rng.randint(3, 5))
        else:
            prompt = rng.randint(1, vocab, rng.randint(3, 9)).astype(np.int32)
        max_new = int(rng.choice([2, 4, 6, 8]))
        stream.append((int(rng.randint(0, 4)), prompt.astype(np.int32), max_new, None))
    return stream


def _assert_same_spec(jeng, eng):
    js, s = jeng.stats, eng.stats
    assert {k: s["spec"][k] for k in SPEC_KEYS} == {k: js["spec"][k] for k in SPEC_KEYS}
    assert s["spec"]["per_slot_proposed"] == js["spec"]["per_slot_proposed"]
    assert s["preemptions"] == js["preemptions"]
    assert s["pages_in_use"] == 0 and s["allocs"] == s["frees"]
    assert not s["degraded"]


# ---------------------------------------------------------------------------
# The drafter: the port's copy proposes what the JAX package proposes


@pytest.mark.parametrize("seed", range(6))
def test_propose_matches_jax(seed):
    """Seeded contexts: tiled phrases with noise (hits at every n-gram
    length), pure noise (misses), and degenerate lengths."""
    rng = np.random.RandomState(seed)
    for trial in range(40):
        kind = trial % 3
        if kind == 0:
            phrase = rng.randint(1, 9, rng.randint(1, 6))
            ctx = np.tile(phrase, rng.randint(1, 6))
            noise = rng.rand(ctx.size) < 0.2
            ctx = np.where(noise, rng.randint(1, 9, ctx.size), ctx)
        elif kind == 1:
            ctx = rng.randint(1, 1000, rng.randint(0, 30))
        else:
            ctx = rng.randint(1, 3, rng.randint(0, 4))
        ctx = ctx.astype(np.int32)
        k = int(rng.randint(0, 7))
        ngram = int(rng.randint(1, 5))
        min_ngram = int(rng.randint(1, ngram + 1))
        got = spec.propose(ctx, k, ngram=ngram, min_ngram=min_ngram)
        want = jspec.propose(ctx, k, ngram=ngram, min_ngram=min_ngram)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_draft_budget_matches_jax():
    for draft_k in range(0, 6):
        for rows in range(0, 5):
            for budget in (None, 1, 2, 3, 5, 9, 16, 64):
                assert (spec.draft_budget(draft_k, rows, budget)
                        == jspec.draft_budget(draft_k, rows, budget))


# ---------------------------------------------------------------------------
# Engine: tokens and spec counters equal the JAX engine's


@pytest.mark.parametrize("pool", [None, 8])
def test_spec_token_identity_paged(model, pool):
    """The JAX harness's paged stream; pool_pages=8 is tight enough that
    draft growth meets pool pressure (preemption or deferred drafts)."""
    stream = _spec_stream(model[2].vocab_size, seed=21)
    jgot, got, jeng, eng = _run(model, stream, slots=3, max_seq=48, block_size=4,
                                pool_pages=pool, spec_decode=True, draft_k=3)
    assert got == jgot
    _assert_same_spec(jeng, eng)
    st = eng.stats["spec"]
    if pool is None:
        assert st["proposed"] > 0 and st["accepted"] > 0
    else:
        assert eng.preemptions > 0 or st["pool_deferred"] > 0
    assert eng.dispatches["verify"] > 0


def test_spec_identity_under_adversarial_drafter(model):
    """Every draft wrong, every step: full rejection and page rollback."""

    def adversarial(context, k):
        return np.full((k,), 1, np.int32)

    stream = _spec_stream(model[2].vocab_size, seed=22, n=4)
    jgot, got, jeng, eng = _run(model, stream, drafter=adversarial, slots=2, max_seq=48,
                                block_size=2, spec_decode=True, draft_k=4)
    assert got == jgot
    _assert_same_spec(jeng, eng)
    st = eng.stats["spec"]
    assert st["proposed"] > 0
    assert st["committed"] == st["slot_steps"] + st["accepted"]


def test_eos_in_middle_of_accepted_draft_window(model):
    """An oracle drafter proposes the true continuation; the EOS inside an
    accepted window truncates the commit there."""
    _, _, cfg, params = model
    prompt = np.random.RandomState(13).randint(2, cfg.vocab_size, 5).astype(np.int32)
    plain = engine_lib.Engine(params, cfg, ENC, config=EngineConfig(slots=1, max_seq=64),
                              device="cpu")
    plain.submit(engine_lib.Request(uid=0, prompt=prompt, max_new_tokens=12))
    target = plain.run()[0].generated
    eos = target[4]
    want = target[: target.index(eos) + 1]
    full = np.concatenate([prompt, np.asarray(target, np.int32)])

    def oracle(context, kk):
        ctx = np.asarray(context, np.int32)
        return full[ctx.size: ctx.size + kk]

    jgot, got, jeng, eng = _run(model, [(0, prompt, 12, eos)], drafter=oracle, slots=1,
                                max_seq=64, spec_decode=True, draft_k=4)
    assert got == jgot == {0: want}
    _assert_same_spec(jeng, eng)
    req = eng.finished[0]
    assert req.draft_accepted == req.draft_proposed > 0
