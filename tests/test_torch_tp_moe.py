"""Tensor-parallel serving of the MoE family in the port against the JAX
engine, across gloo ranks on the CPU (the ranks run
tests/torch_tp_moe_worker.py; one start per degree, tp = 2 and 4, with
every case inside it).

The models are the reduced Grok-1-314B (4 experts, top-2, no window: the
paged cache) and Mixtral-8x22B (the same, window 16: the dense ring),
3 slots, so a decode dispatch keeps one row an expert and drops the rest.
Every rank holds each expert's FFN columns (64 at tp = 2, 32 at tp = 4) and
the whole router.  On paged, spec, the ring (vectorized and grouped),
moe_dense_decode and w8a8 every rank emits the JAX engine's mesh=1 tokens
(its plain "xla" paths, computed here); kv4 and w4a8 emit the port's own
tp=1 tokens.  Each rank's collectives a dispatch: 2 sums a layer (wo and
the experts' stacked w_down) plus the embedding's sum and the head's
gather, and 2 absmax reduces a layer with int8 or int4 weights.  Layer 0's
MoE block on a rank's shard equals one card's: w8a8 bit for bit, with one
sum (and one absmax) a call, never one an expert."""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jcfg_registry
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import registry
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T

import torch_tp_moe_worker as M

ARCHS = {"grok": "grok-1-314b", "mixtral": "mixtral-8x22b"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module (the suite's workers share the
    cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_quarantine():
    registry.clear_quarantine()
    yield
    registry.clear_quarantine()


def _cfgs(lib) -> dict:
    """The reduced configs by MATRIX model name, from `lib`'s registry."""
    return {f"{m}{'+dd' if dd else ''}": lib.get_reduced(arch, moe_dense_decode=dd)
            for m, arch in ARCHS.items() for dd in (False, True)}


@pytest.fixture(scope="module")
def model():
    """(JAX cfgs, port cfgs, {(model, fmt): JAX params}, {(model, fmt): port
    params}): JAX's random weights in f32 and int8 converted to the port,
    and the port's own int4 weights."""
    jcfgs, cfgs = _cfgs(jcfg_registry), _cfgs(cfg_registry)
    jparams, params = {}, {}
    for m in ARCHS:
        for fmt in ("none", "int8"):
            jenc = JEncodingConfig(enabled=True, backend="xla", weight_quant=fmt)
            jparams[(m, fmt)] = jax.jit(functools.partial(JT.model_init, cfg=jcfgs[m],
                                                          enc=jenc))(jax.random.PRNGKey(1))
            params[(m, fmt)] = convert.params_from_jax(
                jax.tree.map(np.asarray, jparams[(m, fmt)]), cfgs[m],
                EncodingConfig(weight_quant=fmt), "cpu")
        params[(m, "int4")] = T.model_init(cfgs[m], EncodingConfig(weight_quant="int4"),
                                           seed=0, device="cpu")
    return jcfgs, cfgs, jparams, params


@pytest.fixture(scope="module")
def references(model):
    """The JAX engine's mesh=1 tokens (plain "xla" paths) for every case it
    serves; the port's tp=1 tokens for M.PORT_HELD."""
    jcfgs, cfgs, jparams, params = model
    want = {}
    for name, (m, fmt, config) in M.MATRIX.items():
        if name in M.PORT_HELD:
            want[name] = M.serve(params[(M.base(m), fmt)], cfgs[m], m, fmt, config, tp=1)[0]
            continue
        jeng = jengine.Engine(jparams[(M.base(m), fmt)], jcfgs[m],
                              JEncodingConfig(enabled=True, backend="xla", weight_quant=fmt),
                              **config)
        for i, p in enumerate(M.prompts(m, jcfgs[m].vocab_size)):
            jeng.submit(jengine.Request(uid=i, prompt=p, max_new_tokens=6))
        want[name] = {r.uid: list(r.generated) for r in jeng.run()}
    return want


def test_moe_tp1_matches_jax(model, references):
    """The port at tp = 1 emits the JAX engine's tokens on every case the
    JAX engine serves (the reference the ranks are held to below)."""
    _, cfgs, _, params = model
    for name, (m, fmt, config) in M.MATRIX.items():
        if name not in M.PORT_HELD:
            got = M.serve(params[(M.base(m), fmt)], cfgs[m], m, fmt, config, tp=1)[0]
            assert got == references[name], name


@pytest.mark.parametrize("tp", [2, 4])
def test_moe_tp_ranks_match_jax_and_tp1(model, references, tp):
    _, cfgs, _, params = model
    ranks = mesh_lib.launch_ranks(M.rank_main, tp, cfgs, params, timeout_s=240,
                                  collective_timeout_s=60)
    for rank, out in enumerate(ranks):
        for name, (m, fmt, _) in M.MATRIX.items():
            assert out["tokens"][name] == references[name], (tp, rank, name)
            c = out["collectives"][name]
            n, counts, layers = c["dispatches"], c["counts"], cfgs[m].num_layers
            assert counts["all_gather_last"] == n, (name, counts)
            assert counts["all_reduce_sum"] == n * (2 * layers + 1), (name, counts)
            quant = fmt != "none"
            assert counts.get("all_reduce_max", 0) == (n * 2 * layers if quant else 0), name
        layer = out["moe_layer"]
        assert all(v == 0.0 for k, v in layer.items() if " int8 " in k), layer
        assert max(v for k, v in layer.items() if "bf16" not in k) < 1e-5, layer
        assert max(v for k, v in layer.items() if "bf16" in k) <= 1.0, layer  # in bf16 steps


@pytest.mark.parametrize("b,l", [(4, 1), (3, 6)])
def test_moe_decode_writes_settle_duplicates(b, l):
    """An MoE layer's decode window writing some cache slots more than once
    (idle rows on the scratch page, pads clamped onto one slot): every
    duplicate carries the last write's value, so the cache holds what
    writes made one after another in row-major order would leave, whatever
    order index_put_ lands them in."""
    from repro_torch.models import layers

    rng = np.random.RandomState(b * 10 + l)
    slot = torch.from_numpy(rng.randint(0, 5, (b, l)))
    k = torch.from_numpy(rng.randn(b, l, 2, 3).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, l, 2, 3).astype(np.float32))
    ks, vs = layers._last_write_wins(slot, k, v)
    want_k, want_v = torch.zeros(5, 2, 3), torch.zeros(5, 2, 3)
    for i in range(b):
        for j in range(l):
            want_k[slot[i, j]], want_v[slot[i, j]] = k[i, j], v[i, j]
    for i in range(b):
        for j in range(l):
            assert torch.equal(ks[i, j], want_k[slot[i, j]])
            assert torch.equal(vs[i, j], want_v[slot[i, j]])
    got = torch.zeros(5, 2, 3)
    got.index_put_((slot,), ks)
    assert torch.equal(got, want_k)
