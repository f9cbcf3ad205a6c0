"""The port's serving Engine (CPU, plain kernel versions) against the JAX
package's Engine with its Pallas kernels in interpret mode, on the reduced
Llama-3.2-1B with converted weights: identical tokens, and identical
preemption and prefix-cache counts, on a mixed-length trace, a shared-prefix
trace that runs the suffix prefill, and a small-pool trace that preempts.
Also the port's registry keys, quarantine, lifecycle, the speculative,
token-budget and many-slot configurations against the JAX engine, and the
slice it refuses (meshes).  The quantized KV pools, the dense cache and
temperature sampling are held against the JAX engine in
tests/test_torch_kvquant.py, tests/test_torch_dense.py and
tests/test_torch_sample.py."""

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
from repro_torch.core import targets
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import registry
from repro_torch.models import transformer as T
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.faults import KernelFaultError

JENC = JEncodingConfig(enabled=True, backend="fused", attn_backend="pallas", interpret=True)
ENC = EncodingConfig(enabled=True, backend="fused", attn_backend="pallas")


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


def _mixed(rng, vocab):
    return [rng.randint(1, vocab, n).astype(np.int32) for n in (3, 17, 9, 30, 12, 5)]


def _shared_prefix(rng, vocab):
    prefix = rng.randint(1, vocab, 16).astype(np.int32)
    return [np.concatenate([prefix, rng.randint(1, vocab, n).astype(np.int32)])
            for n in (3, 9, 5, 12, 1)]


def _run_both(model, prompts, max_new, **config):
    jcfg, jparams, cfg, params = model
    jeng = jengine.Engine(jparams, jcfg, JENC, **config)
    eng = engine_lib.Engine(params, cfg, ENC, config=EngineConfig(**config), device="cpu")
    for e, req in ((jeng, jengine.Request), (eng, engine_lib.Request)):
        for i, p in enumerate(prompts):
            e.submit(req(uid=i, prompt=p, max_new_tokens=max_new))
    jdone = {r.uid: r.generated for r in jeng.run()}
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng.step()
        eng.audit()
    done = {r.uid: r.generated for r in eng.finished}
    assert all(r.status == "ok" for r in eng.finished)
    return jeng, jdone, eng, done


@pytest.mark.parametrize("trace", ["mixed", "shared_prefix", "preemption"])
def test_engine_tokens_match_jax(model, trace):
    rng = np.random.RandomState(7)
    vocab = model[2].vocab_size
    if trace == "mixed":
        prompts, max_new = _mixed(rng, vocab), 6
        config = dict(slots=4, max_seq=64, block_size=8)
    elif trace == "shared_prefix":
        prompts, max_new = _shared_prefix(rng, vocab), 5
        config = dict(slots=2, max_seq=64, block_size=8)
    else:
        prompts, max_new = [rng.randint(1, vocab, n).astype(np.int32)
                            for n in (9, 11, 10, 12)], 10
        config = dict(slots=3, max_seq=32, block_size=4, pool_pages=12)
    jeng, jdone, eng, done = _run_both(model, prompts, max_new, **config)
    assert done == jdone
    assert all(len(g) == max_new for g in done.values())
    js, s = jeng.stats, eng.stats
    assert s["preemptions"] == js["preemptions"]
    assert s["prefix_cache"]["hit_tokens"] == js["prefix_cache"]["hit_tokens"]
    assert s["prefix_cache"]["hit_blocks"] == js["prefix_cache"]["hit_blocks"]
    if trace == "shared_prefix":
        assert s["prefix_cache"]["hit_tokens"] > 0
    if trace == "preemption":
        assert s["preemptions"] > 0
    assert s["pages_in_use"] == 0 and not s["degraded"]


# ---------------------------------------------------------------------------
# Registry: the h100 keys of the slice resolve to the kernels


@pytest.mark.parametrize("phase,m,want", [(Phase.PREFILL, 2048, "fused"),
                                          (Phase.DECODE, 1, "fused"),
                                          (Phase.DECODE, 8, "fused"),
                                          (Phase.DECODE, 32, "pallas")])
def test_registry_h100_matmul_keys(phase, m, want):
    choice = registry.select(quant="none", phase=phase, m=m, requested="auto")
    assert (choice.backend, choice.source) == (want, "default")
    assert registry.dispatch_key("none", phase, m, "h100").endswith("|h100")


@pytest.mark.parametrize("phase,s", [(Phase.PREFILL, 512), (Phase.DECODE, 1024)])
def test_registry_h100_attn_keys(phase, s):
    choice = registry.select_attn(phase=phase, s=s, requested="auto")
    assert (choice.backend, choice.source) == ("pallas", "default")


def test_registry_unknown_target_falls_back():
    other = targets.TargetSpec(
        name="other", peak_flops_bf16=1.0, peak_flops_f32=1.0, peak_ops_int8=1.0,
        hbm_bytes_per_s=1.0, smem_bytes_per_block=1, sm_count=1)
    assert registry.select(quant="none", phase=Phase.DECODE, m=1, target=other,
                           requested="auto").source == "fallback"
    assert registry.select_attn(phase=Phase.DECODE, s=64, target=other,
                                requested="auto").backend == "xla"


def test_registry_demote_walks_the_ladder():
    key = registry.dispatch_key("none", Phase.DECODE, 4, "h100")
    rec = registry.demote(key, failing="fused", requested="fused")
    assert (rec["from"], rec["to"]) == ("fused", "reference")
    choice = registry.select(quant="none", phase=Phase.DECODE, m=4, requested="fused")
    assert choice.backend == "reference" and choice.source.startswith("quarantined:")


# ---------------------------------------------------------------------------
# Engine: quarantine, lifecycle, refusals


class _FailDecodeMatmul:
    """Fault hook: the decode matmul key's kernel 'fails' once."""

    def __init__(self):
        self.fired = False

    def on_step_begin(self, engine):
        pass

    def pre_dispatch(self, engine, kind, keys):
        if kind == "decode" and not self.fired:
            self.fired = True
            raise KernelFaultError(keys[1])

    def corrupt_slots(self, engine, active):
        return ()


def _engine(model, enc=ENC, **kw):
    _, _, cfg, params = model
    hooks = kw.pop("fault_hooks", None)
    clock = kw.pop("clock", None)
    return engine_lib.Engine(params, cfg, enc, config=EngineConfig(**kw), device="cpu",
                             fault_hooks=hooks, clock=clock)


def test_engine_quarantine_keeps_tokens(model):
    rng = np.random.RandomState(3)
    prompts = _mixed(rng, model[2].vocab_size)[:3]
    outs = []
    for hooks in (None, _FailDecodeMatmul()):
        registry.clear_quarantine()
        eng = _engine(model, slots=4, max_seq=64, block_size=8, fault_hooks=hooks)
        for i, p in enumerate(prompts):
            eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=4))
        outs.append({r.uid: r.generated for r in eng.run()})
    assert outs[0] == outs[1]
    (entry,) = eng.stats["degraded"]
    assert entry["key"] == "none|decode|m8|h100" and entry["to"] == "reference"


def test_engine_w8a8_quarantine_keeps_tokens(model):
    """Quantized dispatches key the registry by their quant: a pre_dispatch
    fault on the int8 decode key quarantines "w8a8|decode|m8|h100" (down to
    the plain "xla" oracle) and the tokens stay those of the fault-free run."""
    cfg = model[2]
    enc = EncodingConfig(backend="fused", attn_backend="pallas", weight_quant="int8")
    params = T.model_init(cfg, enc, seed=0, device="cpu")
    prompts = _mixed(np.random.RandomState(3), cfg.vocab_size)[:3]
    outs = []
    for hooks in (None, _FailDecodeMatmul()):
        registry.clear_quarantine()
        eng = engine_lib.Engine(params, cfg, enc, device="cpu", fault_hooks=hooks,
                                config=EngineConfig(slots=4, max_seq=64, block_size=8))
        for i, p in enumerate(prompts):
            eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=4))
        outs.append({r.uid: r.generated for r in eng.run()})
    assert outs[0] == outs[1]
    (entry,) = eng.stats["degraded"]
    assert entry["key"] == "w8a8|decode|m8|h100" and entry["to"] == "xla"
    assert registry.select(quant="w8a8", phase=Phase.DECODE, m=4,
                           requested="fused").backend == "xla"


def test_engine_lifecycle(model):
    now = [0.0]
    eng = _engine(model, slots=1, max_seq=32, block_size=8, max_queue=2,
                  clock=lambda: now[0])
    rng = np.random.RandomState(4)
    reqs = [engine_lib.Request(uid=i, prompt=rng.randint(1, 200, 5).astype(np.int32),
                               max_new_tokens=3) for i in range(4)]
    reqs[1].deadline_ms = 1.0
    assert eng.submit(reqs[0]) and eng.submit(reqs[1])
    rej = eng.submit(reqs[2])
    assert not rej and rej.reason == "queue_full"
    eng.step()  # admits request 0; the queue has room again
    long = engine_lib.Request(uid=9, prompt=np.ones(40, np.int32), max_new_tokens=1)
    assert eng.submit(long).reason == "unserviceable_seq"
    now[0] = 1.0  # request 1 expires while queued
    reqs[0].cancel()
    eng.run()
    status = {r.uid: r.status for r in eng.finished}
    assert status == {0: "cancelled", 1: "expired"}
    eng.audit()
    assert eng.stats["pages_in_use"] == 0


@pytest.mark.parametrize("kw,match", [
    pytest.param(dict(mesh_shape=(2,)), "tensor parallelism", id="kw1-tensor parallelism"),
])
def test_engine_refuses_later_slices(model, kw, match):
    with pytest.raises(NotImplementedError, match=match):
        _engine(model, enc=EncodingConfig(backend="auto", attn_backend="auto"), **kw)


@pytest.mark.parametrize("kw", [dict(spec_decode=True), dict(token_budget=16),
                                dict(slots=10), dict(slots=16)])
def test_engine_serves_window_configs_like_jax(model, kw):
    """Spec decode, the token budget and more than 8 slots serve under
    registry routing ("auto": windows and decode batches of more than 8 rows
    take the packed mmt4d GEMM) and emit the JAX engine's tokens (JAX on its
    plain paths, as its own harnesses run it)."""
    jcfg, jparams, cfg, params = model
    rng = np.random.RandomState(5)
    vocab = cfg.vocab_size
    prompts = [np.tile(rng.randint(1, vocab, 3), n).astype(np.int32) for n in (2, 5, 3, 7)]
    prompts += [rng.randint(1, vocab, n).astype(np.int32) for n in (9, 4, 13, 6, 11, 5, 8, 3)]
    config = dict(dict(slots=4, max_seq=64, block_size=8), **kw)
    jeng = jengine.Engine(jparams, jcfg, JEncodingConfig(enabled=True, backend="xla",
                                                         attn_backend="xla"), **config)
    eng = _engine(model, enc=EncodingConfig(backend="auto", attn_backend="auto"), **config)
    for e, req in ((jeng, jengine.Request), (eng, engine_lib.Request)):
        for i, p in enumerate(prompts):
            e.submit(req(uid=i, prompt=p, max_new_tokens=6))
    want = {r.uid: r.generated for r in jeng.run()}
    got = {r.uid: r.generated for r in eng.run()}
    assert got == want and all(r.status == "ok" for r in eng.finished)
    st = eng.stats
    assert st["pages_in_use"] == 0 and not st["degraded"]
    if "spec" in kw:
        assert st["spec"]["proposed"] > 0 and eng.dispatches["verify"] > 0
    if "token_budget" in kw:
        assert st["continuous"] == jeng.stats["continuous"]
    if "slots" in kw:
        assert st["peak_active"] == min(kw["slots"], len(prompts)) == jeng.stats["peak_active"]


def test_engine_defaults_to_cuda(model):
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only refusal")
    _, _, cfg, params = model
    with pytest.raises(RuntimeError, match="cuda"):
        engine_lib.Engine(params, cfg, ENC)
