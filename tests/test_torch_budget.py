"""The token-budget mixed step in the port (Engine(token_budget=N)) against
the JAX package, on the reduced Llama-3.2-1B with converted weights.

These mirror tests/test_token_budget.py.  The port's engine runs with
registry routing (backend and attn_backend "auto"): on the CPU a mixed
window of slots x L > 8 rows goes through the packed mmt4d GEMM's plain
version, fewer rows through the fused GEMV's, and attention through the
paged decode kernel's plain version at every window width.  The JAX engine
runs its plain paths (backend and attn_backend "xla"), as its own budget
harness does.  Both sides compute in f32; greedy tokens must be identical,
and so must stats["continuous"], the spec counters, the preemption count
and the prefix-cache counts."""

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


def _run(model, stream, **config):
    """Drive the JAX and the port engine over the same stream of requests,
    auditing the port's pool every step.  A stream entry is (arrival, prompt,
    max_new, request kwargs); arrival is a step number or a predicate on the
    engine (submit once it holds).  Returns (jax tokens, port tokens, jax
    engine, port engine)."""
    jcfg, jparams, cfg, params = model
    jeng = jengine.Engine(jparams, jcfg, JENC, **config)
    eng = engine_lib.Engine(params, cfg, ENC, config=EngineConfig(**config), device="cpu")
    outs = []
    for e, req_cls in ((jeng, jengine.Request), (eng, engine_lib.Request)):
        pending = list(enumerate(stream))
        step = 0
        while pending or e.queue or any(r is not None for r in e.slot_req):
            for item in list(pending):
                uid, (at, prompt, max_new, kw) = item
                if (at(e) if callable(at) else at <= step):
                    assert e.submit(req_cls(uid=uid, prompt=prompt, max_new_tokens=max_new,
                                            **kw))
                    pending.remove(item)
            e.step()
            e.audit()
            step += 1
            assert step < 2000, "engine failed to drain the stream"
        outs.append({r.uid: list(r.generated) for r in e.finished})
    assert all(r.status == "ok" for r in eng.finished)
    return outs[0], outs[1], jeng, eng


def _assert_same_stats(jeng, eng):
    js, s = jeng.stats, eng.stats
    assert s["continuous"] == js["continuous"]
    for key in ("preemptions", "shared_hits", "cow_events", "pages_in_use"):
        assert s[key] == js[key], key
    for key in ("hit_blocks", "hit_tokens", "deferred_hits"):
        assert s["prefix_cache"][key] == js["prefix_cache"][key], key
    if "spec" in js:
        assert {k: s["spec"][k] for k in SPEC_KEYS} == {k: js["spec"][k] for k in SPEC_KEYS}
    assert s["pages_in_use"] == 0 and s["allocs"] == s["frees"]
    assert not s["degraded"]


def _prompts(vocab, seed=0, n=5, lo=4, hi=12):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, rng.randint(lo, hi)).astype(np.int32) for _ in range(n)]


def _batch(prompts, max_new=8, **kw):
    return [(0, p, max_new, kw) for p in prompts]


# ---------------------------------------------------------------------------
# Scheduler policy: the port's copy decides what the JAX package decides


def test_scheduler_keys_match_jax():
    """queue_key / victim_key / rank over a sweep of classes, enqueue steps,
    tickets and aging periods."""
    rng = np.random.RandomState(0)
    classes = ["interactive", "standard", "batch", "mystery"]
    for aging in (1, 3, 4, 64):
        sched = engine_lib.TokenBudgetScheduler(16, aging_steps=aging)
        jsched = jengine.TokenBudgetScheduler(16, aging_steps=aging)
        for _ in range(50):
            cls = classes[rng.randint(len(classes))]
            enq = None if rng.rand() < 0.2 else int(rng.randint(0, 40))
            now, ticket = int(rng.randint(0, 80)), int(rng.randint(0, 9))
            req = engine_lib.Request(uid=0, prompt=np.ones(2, np.int32), max_new_tokens=1,
                                     slo_class=cls, enqueued_step=enq)
            jreq = jengine.Request(uid=0, prompt=np.ones(2, np.int32), max_new_tokens=1,
                                   slo_class=cls, enqueued_step=enq)
            assert sched.rank(req) == jsched.rank(jreq)
            assert sched.queue_key(req, now) == jsched.queue_key(jreq, now)
            assert sched.victim_key(req, ticket) == jsched.victim_key(jreq, ticket)
    assert engine_lib.SLO_CLASSES == jengine.SLO_CLASSES


@pytest.mark.parametrize("budget", [1, 2, 5, 8, 16, 64])
def test_split_chunks_matches_jax(budget):
    rng = np.random.RandomState(budget)
    sched = engine_lib.TokenBudgetScheduler(budget)
    jsched = jengine.TokenBudgetScheduler(budget)
    for _ in range(40):
        rows = list(rng.permutation(8)[: rng.randint(1, 6)])
        remaining = {int(s): int(rng.randint(1, 40)) for s in rows}
        order = [int(s) for s in rows]
        decode_cost = int(rng.randint(0, 12))
        assert (sched.split_chunks(decode_cost, remaining, order)
                == jsched.split_chunks(decode_cost, remaining, order))


def test_scheduler_rejects_empty_budget():
    with pytest.raises(ValueError, match="token_budget"):
        engine_lib.TokenBudgetScheduler(0)


# ---------------------------------------------------------------------------
# Token identity with the JAX engine


def test_mixed_token_identity(model):
    prompts = _prompts(model[2].vocab_size)
    jgot, got, jeng, eng = _run(model, _batch(prompts), slots=3, max_seq=64,
                                token_budget=10)
    assert got == jgot
    _assert_same_stats(jeng, eng)
    c = eng.stats["continuous"]
    assert c["mixed_steps"] > 0 and c["prefill_tokens"] > 0
    assert c["decode_stall_steps"] == 0
    assert eng.dispatches["mixed"] == c["mixed_steps"]


def test_mixed_token_identity_with_spec_decode(model):
    """Repetitive prompts, so drafts are proposed inside mixed windows and
    share the budget with prefill chunks."""
    rng = np.random.RandomState(3)
    prompts = [np.tile(rng.randint(1, model[2].vocab_size, 5), 4).astype(np.int32)
               for _ in range(4)]
    jgot, got, jeng, eng = _run(model, _batch(prompts, max_new=10), slots=3, max_seq=64,
                                token_budget=10, spec_decode=True, draft_k=4)
    assert got == jgot
    _assert_same_stats(jeng, eng)
    assert eng.stats["spec"]["proposed"] > 0


def test_mixed_identity_adversarial_arrival(model):
    """Requests trickle in every other step while the engine is mid-flight."""
    prompts = _prompts(model[2].vocab_size, seed=7, n=6, lo=4, hi=30)
    stream = [(2 * i, p, 8, {}) for i, p in enumerate(prompts)]
    jgot, got, jeng, eng = _run(model, stream, slots=3, max_seq=64, token_budget=8)
    assert got == jgot
    _assert_same_stats(jeng, eng)


def test_long_prompt_admission_zero_decode_stall(model):
    """A prompt ~8x the per-step budget admitted mid-decode streams in over
    many steps while the decoding slot emits every step."""
    vocab = model[2].vocab_size
    rng = np.random.RandomState(11)
    short = np.tile(rng.randint(1, vocab, 4), 3).astype(np.int32)
    long_p = rng.randint(1, vocab, 60).astype(np.int32)
    stream = [(0, short, 24, {}), (3, long_p, 4, {})]
    jgot, got, jeng, eng = _run(model, stream, slots=2, max_seq=64, token_budget=8)
    assert got == jgot
    _assert_same_stats(jeng, eng)
    c = eng.stats["continuous"]
    assert c["decode_stall_steps"] == 0 and c["completed_prefills"] == 2
    assert c["prefill_tokens"] >= len(long_p)


def test_slo_classes_serve_like_jax(model):
    """Mixed SLO classes with one slot: admission order (interactive jumps
    the batch queue) and tokens equal the JAX engine's."""
    prompts = _prompts(model[2].vocab_size, seed=5, n=3, lo=4, hi=8)
    stream = [(0, prompts[0], 4, dict(slo_class="batch")),
              (0, prompts[1], 4, dict(slo_class="batch")),
              (0, prompts[2], 4, dict(slo_class="interactive"))]
    jgot, got, jeng, eng = _run(model, stream, slots=1, max_seq=64, token_budget=8)
    assert got == jgot
    order = [r.uid for r in eng.finished]
    assert order == [r.uid for r in jeng.finished] and order.index(2) < order.index(1)
    _assert_same_stats(jeng, eng)


def test_budget_pool_pressure_preempts_like_jax(model):
    """A tight pool: mixed-step page growth preempts by SLO class."""
    prompts = _prompts(model[2].vocab_size, seed=9, n=4, lo=8, hi=20)
    stream = [(0, p, 12, dict(slo_class=("batch", "interactive")[i % 2]))
              for i, p in enumerate(prompts)]
    jgot, got, jeng, eng = _run(model, stream, slots=3, max_seq=48, block_size=4,
                                pool_pages=12, token_budget=6)
    assert got == jgot
    _assert_same_stats(jeng, eng)
    assert eng.preemptions > 0


def _prefix_pair(vocab, bs):
    """Two prompts sharing a 2.5-block prefix (not block- or chunk-aligned)."""
    rng = np.random.RandomState(13)
    prefix = rng.randint(1, vocab, 2 * bs + bs // 2).astype(np.int32)
    p0 = np.concatenate([prefix, rng.randint(1, vocab, 7).astype(np.int32)])
    p1 = np.concatenate([prefix, rng.randint(1, vocab, 9).astype(np.int32)])
    return p0, p1


def test_chunked_prefill_shared_prefix_partial_boundary_block(model):
    """The second prompt arrives once the first is fully prefilled: its chunks
    resume at the shared-page boundary and COW-split the partial block."""
    p0, p1 = _prefix_pair(model[2].vocab_size, 8)

    def first_prefilled(e):
        s = next((s for s in range(e.slots) if e.slot_req[s] is not None), None)
        return s is not None and int(e.slot_prefill_done[s]) >= len(p0)

    stream = [(0, p0, 8, {}), (first_prefilled, p1, 8, {})]
    jgot, got, jeng, eng = _run(model, stream, slots=2, max_seq=64, block_size=8,
                                token_budget=6)
    assert got == jgot
    _assert_same_stats(jeng, eng)
    st = eng.stats
    assert st["shared_hits"] >= 2 and st["cow_events"] >= 1


def test_chunked_prefill_shared_prefix_unwritten_pages(model):
    """Both prompts arrive together: the second defers on the unwritten
    shared prefix and re-plans into a real share (deferred_hits)."""
    p0, p1 = _prefix_pair(model[2].vocab_size, 8)
    jgot, got, jeng, eng = _run(model, _batch([p0, p1], max_new=6), slots=2, max_seq=64,
                                block_size=8, token_budget=6)
    assert got == jgot
    _assert_same_stats(jeng, eng)
    st = eng.stats
    assert st["prefix_cache"]["deferred_hits"] > 0 and st["shared_hits"] >= 2


def test_deferred_hit_recovers_unwritten_prefix(model):
    """Identical prompts: uid 1 races uid 0's chunked prefill, defers, and
    admits off the written blocks."""
    prompt = np.random.RandomState(3).randint(1, model[2].vocab_size, 33).astype(np.int32)
    jgot, got, jeng, eng = _run(model, _batch([prompt, prompt.copy()], max_new=6),
                                slots=2, max_seq=64, block_size=8, token_budget=8)
    assert got == jgot and got[0] == got[1]
    _assert_same_stats(jeng, eng)
    pc = eng.stats["prefix_cache"]
    assert pc["deferred_hits"] > 0 and pc["hit_blocks"] >= pc["deferred_hits"]


# ---------------------------------------------------------------------------
# Dispatch keys: a wide mixed window names the packed-GEMM bucket


def test_mixed_dispatch_key_hits_gemm_bucket(model):
    _, _, cfg, params = model
    eng = engine_lib.Engine(params, cfg, ENC, device="cpu",
                            config=EngineConfig(slots=3, max_seq=64, token_budget=40))
    eng._window_m = 3 * 32
    _attn_key, mm_key = eng._dispatch_keys("mixed")
    assert "|big|" in mm_key
    assert registry.resolve_key(mm_key, requested="auto").backend == "pallas"


def test_mixed_steps_key_their_window_rows(model):
    """Every mixed dispatch is keyed by slots x L, the rows its projections
    see; the key's M bucket is the one the model's matmuls resolve."""
    _, _, cfg, params = model
    seen = []

    class _Spy:
        def on_step_begin(self, engine):
            pass

        def pre_dispatch(self, engine, kind, keys):
            seen.append((kind, engine._window_m, keys[1]))

        def corrupt_slots(self, engine, active):
            return ()

    eng = engine_lib.Engine(params, cfg, ENC, device="cpu", fault_hooks=_Spy(),
                            config=EngineConfig(slots=3, max_seq=64, token_budget=24))
    for i, p in enumerate(_prompts(cfg.vocab_size, seed=1, n=3, lo=20, hi=30)):
        eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=3))
    eng.run()
    assert seen and all(kind == "mixed" for kind, _, _ in seen)
    for _, m, key in seen:
        assert key == registry.dispatch_key("none", engine_lib.Phase.DECODE, m, "h100")
    assert any("|big|" in key for _, _, key in seen)
    assert any("|m8|" in key or "|m1|" in key for _, _, key in seen)
