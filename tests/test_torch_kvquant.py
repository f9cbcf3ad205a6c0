"""Quantized KV pools (kv8, kv4) of the port against the JAX package, on the
CPU: the KVLayout codec bit for bit, the byte pricing, the allocator's
scale-page tracking, the paged decode kernel's plain version against the
Pallas kernel in interpret mode, the
attention registry's KV-layout keys and per-layout quarantine, and the
serving engine's tokens and stats against the JAX engine on the reduced
Llama-3.2-1B with converted weights.

Tolerance: attention outputs atol = rtol = 1e-5 (f32 inputs; both sides
dequantize to the same f32 values, float(q) * scale, and sum in f32 in
another order).  Codes and scales: equal bit for bit.  Tokens: equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jcfg_registry
from repro.core import encoding as jencoding
from repro.core import targets as jtargets
from repro.core.encoding import Phase as JPhase
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.kernels import attn as jattn
from repro.kernels import registry as jregistry
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro.serving import paged as jpaged
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core import encoding
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import attn
from repro_torch.kernels import registry
from repro_torch.serving import engine as engine_lib
from repro_torch.serving import paged
from repro_torch.serving.config import EngineConfig

TOL = dict(rtol=1e-5, atol=1e-5)
JENC = JEncodingConfig(enabled=True, backend="fused", attn_backend="pallas", interpret=True)
ENC = EncodingConfig(enabled=True, backend="fused", attn_backend="pallas")
JXLA = JEncodingConfig(enabled=True, backend="xla", attn_backend="xla")
AUTO = EncodingConfig(backend="auto", attn_backend="auto")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The codec


@pytest.mark.parametrize("kv", ["kv8", "kv4"])
@pytest.mark.parametrize("shape", [(3, 5, 2, 16), (7, 1, 64), (2, 3, 4, 128)])
def test_kv_quantize_bit_for_bit_against_jax(kv, shape):
    """Rows scaled over 2**-12 .. 2**12, a row of zeros (the 1e-8 floor) and
    values on the rounding halves: identical codes and scales, and identical
    dequantized values."""
    rng = np.random.RandomState(len(shape) * 10 + shape[-1])
    x = rng.randn(*shape).astype(np.float32)
    x *= (2.0 ** rng.randint(-12, 13, shape[:-1] + (1,))).astype(np.float32)
    jlay, lay = jencoding.kv_layout(kv), encoding.kv_layout(kv)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    # A row whose scale is exactly 2**-3: its first entries sit on the
    # rounding halves (round half to even).
    flat[-1] = np.clip(flat[-1], -1, 1) * lay.qmax / 8
    flat[-1, :5] = np.array([lay.qmax, 0.5, -1.5, 2.5, -3.5], np.float32) / 8
    jq, jsc = jlay.quantize(jnp.asarray(x))
    q, sc = lay.quantize(_t(x))
    assert q.dtype == {"kv8": torch.int8, "kv4": torch.uint8}[kv]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    assert q.shape[-1] == lay.storage_head_dim(shape[-1])
    np.testing.assert_array_equal(lay.dequantize(q, sc).numpy(),
                                  np.asarray(jlay.dequantize(jq, jsc)))


def test_kv_layout_for_storage_and_shapes_match_jax():
    for dt, jdt in ((torch.int8, jnp.int8), (torch.uint8, jnp.uint8),
                    (torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        assert (encoding.kv_layout_for_storage(dt).name
                == jencoding.kv_layout_for_storage(jdt).name)
    for kv in encoding.KV_QUANTS:
        lay, jlay = encoding.kv_layout(kv), jencoding.kv_layout(kv)
        assert lay.scale_shape((5, 16), 8) == jlay.scale_shape((5, 16), 8)
        assert lay.bytes_per_token_per_head(64) == jlay.bytes_per_token_per_head(64)
    with pytest.raises(ValueError, match="kv2"):
        encoding.kv_layout("kv2")


@pytest.mark.parametrize("kv", ["bf16", "kv8", "kv4"])
@pytest.mark.parametrize("layers,kvh,hd,itemsize", [(16, 8, 64, 2), (2, 1, 16, 4), (28, 2, 128, 2)])
def test_kv_bytes_per_token_matches_jax(kv, layers, kvh, hd, itemsize):
    assert (encoding.kv_bytes_per_token(layers, kvh, hd, itemsize=itemsize, kv_quant=kv)
            == jencoding.kv_bytes_per_token(layers, kvh, hd, itemsize=itemsize, kv_quant=kv))


# ---------------------------------------------------------------------------
# The paged decode kernel's plain version on quantized pools


def _quant_pools(rng, kv, pages, bs, kvh, d):
    lay = jencoding.kv_layout(kv)
    k, v = (rng.randn(pages, bs, kvh, d).astype(np.float32) for _ in range(2))
    (kq, ks), (vq, vs) = lay.quantize(jnp.asarray(k)), lay.quantize(jnp.asarray(v))
    return [np.asarray(a) for a in (kq, vq, ks, vs)]


@pytest.mark.parametrize("kv", ["kv8", "kv4"])
@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("h,kvh", [(4, 1), (8, 2)])
def test_paged_decode_quantized_plain_matches_pallas(kv, L, h, kvh):
    rng = np.random.RandomState(L * 100 + h)
    b, d, bs, nb, pages = 3, 16, 4, 6, 14
    q = rng.randn(b, L, h, d).astype(np.float32)
    kq, vq, ks, vs = _quant_pools(rng, kv, pages, bs, kvh, d)
    table = rng.randint(1, pages, (b, nb)).astype(np.int32)
    table[1, :2] = table[0, :2]  # shared leading pages
    pos = np.array([2, 9, nb * bs - L], np.int32)  # ragged; the last row fills its table
    want = jattn.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(table), jnp.asarray(pos),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), kv_quant=kv, interpret=True,
    )
    got = attn.paged_decode_attention(_t(q), _t(kq), _t(vq), _t(table), _t(pos),
                                      k_scale=_t(ks), v_scale=_t(vs), kv_quant=kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.dtype == torch.float32


def test_paged_decode_quantized_checks_its_operands():
    q = torch.zeros(1, 1, 4, 16)
    pool = torch.zeros(2, 4, 1, 16, dtype=torch.int8)
    table, pos = torch.zeros(1, 1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="scale"):
        attn.paged_decode_attention(q, pool, pool, table, pos, kv_quant="kv8")
    scale = torch.ones(2, 4, 1, 1)
    with pytest.raises(ValueError, match="do not fit"):  # kv4 stores D/2 bytes a row
        attn.paged_decode_attention(q, pool.to(torch.uint8), pool.to(torch.uint8), table, pos,
                                    k_scale=scale, v_scale=scale, kv_quant="kv4")


@pytest.mark.parametrize("kv", ["kv8", "kv4"])
def test_block_allocator_scale_pages_match_jax(kv):
    """The allocator keeps the scale pages of a quantized pool live in
    lockstep with its data pages, shares and frees included, as JAX's does."""
    rng = np.random.RandomState(4)
    prefix = rng.randint(1, 100, 12).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.randint(1, 100, n).astype(np.int32)])
               for n in (3, 9, 1)]
    allocs = [mod.BlockAllocator(12, 4, kv, prefix_cache=True) for mod in (jpaged, paged)]
    for a in allocs:
        held = []
        for p in prompts:
            nblocks, shared = a.plan_prompt(p)
            plan = a.commit_prompt(p, nblocks, shared)
            a.mark_written(plan.pages)
            held.append(list(plan.pages))
        held[0].append(a.alloc())
        a.free_pages(held.pop(1))
        a.audit(held)
        for pages in held:
            a.free_pages(pages)
        a.audit([])
    assert allocs[1].scale_live == allocs[0].scale_live and allocs[1].scale_live
    assert allocs[1].stats == allocs[0].stats


# ---------------------------------------------------------------------------
# Registry: the KV-layout axis of the attention key


@pytest.mark.parametrize("kv", ["bf16", "kv8", "kv4"])
@pytest.mark.parametrize("phase,s", [(Phase.DECODE, 100), (Phase.DECODE, 1000),
                                     (Phase.PREFILL, 5000)])
def test_attn_keys_match_jax(kv, phase, s):
    key = registry.attn_dispatch_key(phase, s, "h100", kv)
    assert key == jregistry.attn_dispatch_key(JPhase(phase.value), s, "h100", kv)
    assert registry.split_attn_key(key) == jregistry.split_attn_key(key)
    assert len(key.split("|")) == (4 if kv == "bf16" else 5)


def test_attn_quarantine_is_per_layout_like_jax():
    """Demoting the kv4 decode key leaves bf16 and kv8 on the kernel, in
    both registries."""
    registry.clear_quarantine()
    jregistry.clear_quarantine()
    try:
        key = registry.attn_dispatch_key(Phase.DECODE, 512, "h100", "kv4")
        jkey = jregistry.attn_dispatch_key(JPhase.DECODE, 512, jtargets.TPU_V5E.name, "kv4")
        rec = registry.demote(key, failing="pallas", requested="pallas")
        jrec = jregistry.demote(jkey, failing="pallas", requested="pallas")
        assert (rec["from"], rec["to"]) == (jrec["from"], jrec["to"]) == ("pallas", "xla")
        for kv in ("bf16", "kv8", "kv4"):
            got = registry.select_attn(phase=Phase.DECODE, s=512, requested="pallas", kv=kv)
            want = jregistry.select_attn(phase=JPhase.DECODE, s=512, requested="pallas", kv=kv)
            assert got.backend == want.backend == ("xla" if kv == "kv4" else "pallas")
            assert got.source.startswith("quarantined:") == (kv == "kv4")
    finally:
        registry.clear_quarantine()
        jregistry.clear_quarantine()


# ---------------------------------------------------------------------------
# The serving engine on quantized pools


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


def _run_both(model, prompts, max_new, jenc, enc, **config):
    jcfg, jparams, cfg, params = model
    jeng = jengine.Engine(jparams, jcfg, jenc, **config)
    eng = engine_lib.Engine(params, cfg, enc, config=EngineConfig(**config), device="cpu")
    for e, req in ((jeng, jengine.Request), (eng, engine_lib.Request)):
        for i, p in enumerate(prompts):
            e.submit(req(uid=i, prompt=p, max_new_tokens=max_new))
    want = {r.uid: r.generated for r in jeng.run()}
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng.step()
        eng.audit()
    got = {r.uid: r.generated for r in eng.finished}
    assert all(r.status == "ok" for r in eng.finished)
    return jeng, want, eng, got


def _shared_prefix(rng, vocab):
    prefix = rng.randint(1, vocab, 16).astype(np.int32)
    return [np.concatenate([prefix, rng.randint(1, vocab, n).astype(np.int32)])
            for n in (3, 9, 5, 12, 1)]


def _tiled(rng, vocab):
    prompts = [np.tile(rng.randint(1, vocab, 3), n).astype(np.int32) for n in (2, 5, 3, 7)]
    return prompts + [rng.randint(1, vocab, n).astype(np.int32) for n in (9, 4, 13, 6)]


@pytest.mark.parametrize("trace", ["shared_prefix", "spec", "budget", "preemption"])
def test_engine_kv8_tokens_match_jax(model, trace):
    """kv8 pools: shared-prefix admissions (the write-skip without the
    suffix prefill) against the JAX engine's Pallas kernels in interpret
    mode; spec decode, the token budget and a small pool that preempts
    against the JAX engine's plain paths, as its own harnesses run them."""
    rng = np.random.RandomState(11)
    vocab = model[2].vocab_size
    base = dict(slots=4, max_seq=64, block_size=8, kv_quant="kv8")
    if trace == "shared_prefix":
        prompts, max_new, jenc, enc = _shared_prefix(rng, vocab), 5, JENC, ENC
        config = dict(base, slots=2)
    elif trace == "preemption":
        prompts = [rng.randint(1, vocab, n).astype(np.int32) for n in (9, 11, 10, 12)]
        max_new, jenc, enc = 10, JXLA, AUTO
        config = dict(base, slots=3, max_seq=32, block_size=4, pool_pages=12)
    else:
        prompts, max_new, jenc, enc = _tiled(rng, vocab), 6, JXLA, AUTO
        config = dict(base, spec_decode=True) if trace == "spec" else dict(base, token_budget=16)
    jeng, want, eng, got = _run_both(model, prompts, max_new, jenc, enc, **config)
    assert got == want
    assert all(len(g) == max_new for g in got.values())
    js, s = jeng.stats, eng.stats
    assert s["kv_quant"] == js["kv_quant"] == "kv8"
    assert s["preemptions"] == js["preemptions"]
    assert s["prefix_cache"]["hit_tokens"] == js["prefix_cache"]["hit_tokens"]
    assert s["pages_in_use"] == 0 and not s["degraded"]
    if trace == "shared_prefix":
        # Shared blocks are reused without a rewrite; a quantized pool runs
        # no suffix prefill, so every prefill is a batched one.
        assert s["prefix_cache"]["hit_tokens"] > 0
    if trace == "preemption":
        assert s["preemptions"] > 0
    if trace == "spec":
        assert s["spec"]["proposed"] > 0
        for key in ("steps", "proposed", "accepted", "committed"):
            assert s["spec"][key] == js["spec"][key], key
    if trace == "budget":
        assert s["continuous"] == js["continuous"]


def test_engine_kv4_tokens_match_jax(model):
    """kv4 pools through the JAX engine's Pallas kernels in interpret mode
    (its plain attention would downgrade kv4 to kv8); few new tokens bound
    the time."""
    rng = np.random.RandomState(12)
    prompts = [rng.randint(1, model[2].vocab_size, n).astype(np.int32) for n in (5, 17, 9)]
    jeng, want, eng, got = _run_both(model, prompts, 3, JENC, ENC, slots=4, max_seq=32,
                                     block_size=8, kv_quant="kv4")
    assert got == want
    assert eng.stats["kv_quant"] == jeng.stats["kv_quant"] == "kv4"
    assert eng.caches["layers"][0]["k"].dtype == torch.uint8
    assert eng.caches["layers"][0]["k"].shape[-1] == model[2].head_dim // 2


def test_engine_kv4_stats_under_xla_match_jax(model):
    """kv4 requested with the plain attention rides kv8 in both engines; the
    stats carry the same keys (the port adds its dispatch counts), the
    resolved modes and the downgrade."""
    jcfg, jparams, cfg, params = model
    config = dict(slots=2, max_seq=32, block_size=8, kv_quant="kv4")
    jeng = jengine.Engine(jparams, jcfg, JXLA, **config)
    eng = engine_lib.Engine(params, cfg, EncodingConfig(backend="xla", attn_backend="xla"),
                            config=EngineConfig(**config), device="cpu")
    js, s = jeng.stats, eng.stats
    assert set(s) - {"dispatches"} == set(js)
    for key in ("cache_mode", "decode_mode", "sample", "kv_quant", "attn_backend",
                "config_downgrades", "pages_total", "block_size"):
        assert s[key] == js[key], key
    assert s["kv_quant"] == "kv8"
    assert s["config_downgrades"] == ["kv_quant:kv8(attn_backend=xla)"]
    assert eng.caches["layers"][0]["k"].dtype == torch.int8


class _FailKv8Decode:
    """Fault hook: the kv8 decode attention key's kernel 'fails' once."""

    def __init__(self):
        self.fired = None

    def on_step_begin(self, engine):
        pass

    def pre_dispatch(self, engine, kind, keys):
        if kind == "decode" and self.fired is None:
            self.fired = keys[0]
            from repro_torch.serving.faults import KernelFaultError
            raise KernelFaultError(keys[0])

    def corrupt_slots(self, engine, active):
        return ()


def test_engine_kv8_quarantine_keys_the_layout(model):
    """A fault on the decode attention of a kv8 engine quarantines the kv8
    key (attn|decode|s256|kv8|h100), and the tokens stay those of the
    fault-free run (the plain attention on the same pool)."""
    _, _, cfg, params = model
    prompts = _tiled(np.random.RandomState(3), cfg.vocab_size)[:3]
    outs = []
    for hooks in (None, _FailKv8Decode()):
        registry.clear_quarantine()
        eng = engine_lib.Engine(params, cfg, ENC, device="cpu", fault_hooks=hooks,
                                config=EngineConfig(slots=4, max_seq=64, block_size=8,
                                                    kv_quant="kv8"))
        for i, p in enumerate(prompts):
            eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=4))
        outs.append({r.uid: r.generated for r in eng.run()})
    assert outs[0] == outs[1]
    (entry,) = eng.stats["degraded"]
    assert entry["key"] == hooks.fired == "attn|decode|s256|kv8|h100"
    assert entry["to"] == "xla"
    assert registry.select_attn(phase=Phase.DECODE, s=64, requested="pallas",
                                kv="bf16").backend == "pallas"
