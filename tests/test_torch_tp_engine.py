"""Tensor-parallel serving in the port against the JAX engine, across gloo
ranks on the CPU (the ranks run tests/torch_tp_worker.py; one start per
degree, tp = 2 and 4, with the whole matrix inside it).

The model is JAX's own choice for its mesh tests (tests/test_tp_mesh.py):
the reduced Qwen2-1.5B with num_kv_heads=4, so the kv heads split at 2 and
4 ranks.  On paged, dense, spec, budget, kv8 and w8a8 every rank emits the
JAX engine's mesh=1 tokens (its plain "xla" paths, computed here); kv4 and
w4a8 (which the JAX engine does not run under a mesh: it rides kv4 on kv8
and has no int4 leaf rule) emit the port's own tp=1 tokens.  Then JAX's
preemption audit (against the port's tp=1 run) and shard-1 chaos
schedule (on an attention key, and on a matmul key, whose last rung, the
plain reference, must still sum the row-parallel products), the
row-parallel projections against one card's (w8a8 bit for bit), an allocator made to diverge on the last rank (named by every
rank's audit), the ValueError for a world size that does not fit, and the
NotImplementedError for the recurrent models at tp > 1 (MoE serves at tp >
1: tests/test_torch_tp_moe.py).  The ranks check that the shards really split (heads,
FFN columns, kv pages, vocabulary rows); the collectives are counted per
dispatch: 2 a layer plus the embedding's and the head's, plus 2 a layer of
activation absmax reduces with int8 or int4 weights."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jcfg_registry
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro.serving.config import EngineConfig as JEngineConfig
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import registry
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.config import EngineConfig

import torch_tp_worker as W

ARCH, KW = "qwen2-1.5b", dict(num_kv_heads=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: the plain versions run many small
    ops, which more threads only slow down where the suite's workers already
    share every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    """(jcfg, cfg, {fmt: JAX params}, {fmt: port params}): JAX's random
    weights in f32 and int8, converted to the port, and the port's own int4
    weights (the JAX engine serves no int4 under a mesh)."""
    jcfg = jcfg_registry.get_reduced(ARCH, **KW)
    cfg = cfg_registry.get_reduced(ARCH, **KW)
    jparams, params = {}, {}
    init = jax.jit(JT.model_init, static_argnums=(1, 2))
    for fmt in ("none", "int8"):
        jenc = JEncodingConfig(enabled=True, backend="xla", weight_quant=fmt)
        jparams[fmt] = init(jax.random.PRNGKey(0), jcfg, jenc)
        params[fmt] = convert.params_from_jax(jax.tree.map(np.asarray, jparams[fmt]), cfg,
                                              EncodingConfig(weight_quant=fmt), "cpu")
    params["int4"] = T.model_init(cfg, EncodingConfig(weight_quant="int4"), seed=0, device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def references(model):
    """The JAX engine's mesh=1 tokens (plain "xla" paths) where it serves the
    configuration; the port's tp=1 tokens for kv4 and w4a8 and for the
    preemption run (JAX's test holds mesh=2 to its own mesh=1 there)."""
    jcfg, cfg, jparams, params = model
    want = {}
    for name, (fmt, config) in W.MATRIX.items():
        if name in ("kv4", "w4a8"):
            want[name] = W.serve(params[fmt], cfg, W.encoding(fmt), config, tp=1)[0]
        else:
            want[name] = _jax_tokens(jcfg, jparams[fmt], fmt, config)
    tokens, eng = W.serve(params["none"], cfg, W.encoding("none"), W.PREEMPT, tp=1, max_new=8,
                          audit_every_step=True)
    assert eng.preemptions > 0, "the pool was meant to force preemption"
    want["preempt"] = {"tokens": tokens, "preemptions": eng.preemptions}
    return want


def _jax_tokens(jcfg, jparams, fmt, config):
    """The JAX engine's tokens (mesh=1, plain "xla" paths)."""
    jeng = jengine.Engine(jparams, jcfg,
                          JEncodingConfig(enabled=True, backend="xla", weight_quant=fmt),
                          config=JEngineConfig(**config))
    for i, p in enumerate(W.prompts(jcfg.vocab_size)):
        jeng.submit(jengine.Request(uid=i, prompt=p, max_new_tokens=6))
    return {r.uid: list(r.generated) for r in jeng.run()}


@pytest.fixture(autouse=True)
def _clean_quarantine():
    registry.clear_quarantine()
    yield
    registry.clear_quarantine()


def test_mesh_larger_than_the_world_is_refused(model):
    """No process group: a mesh of 2 raises ValueError, never a silent
    mesh=1."""
    _, cfg, _, params = model
    with pytest.raises(ValueError, match="needs 2 ranks"):
        engine_lib.Engine(params["none"], cfg, W.encoding("none"), device="cpu",
                          config=EngineConfig(mesh_shape=(2,), **W.PAGED))


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_ranks_match_jax_and_tp1(model, references, tp):
    jcfg, cfg, _, params = model
    refused = {"rwkv": cfg_registry.get_reduced("rwkv6-1.6b"),
               "hybrid": cfg_registry.get_reduced("recurrentgemma-9b")}
    ranks = mesh_lib.launch_ranks(W.rank_main, tp, cfg, params, refused, timeout_s=240,
                                  collective_timeout_s=60)
    layers = cfg.num_layers
    for rank, out in enumerate(ranks):
        for name in W.MATRIX:
            assert out["tokens"][name] == references[name], (tp, rank, name)
            c = out["collectives"][name]
            n, counts = c["dispatches"], c["counts"]
            assert counts["all_gather_last"] == n, (name, counts)
            assert counts["all_reduce_sum"] == n * (2 * layers + 1), (name, counts)
            quant = W.MATRIX[name][0] != "none"
            assert counts.get("all_reduce_max", 0) == (n * 2 * layers if quant else 0), name
        assert out["preempt"] == references["preempt"], (tp, rank)
        for chaos in (out["chaos"], out["chaos_matmul"]):
            assert chaos["tokens"] == references["paged"], (tp, rank)
            assert [e for e in chaos["log"] if e["kind"] == "kernel_fail"][0]["shard"] == 1
        assert out["row_parallel"][("int8", "wo")] == 0.0
        assert out["row_parallel"][("int8", "w_down")] == 0.0
        assert f"shard {tp - 1}" in out["diverged"] and "diverged" in out["diverged"]
        assert f"needs {2 * tp} ranks but the process group has {tp}" in out["refused"]["world"]
        for label in ("rwkv", "hybrid"):
            assert "the recurrent blocks at tp > 1" in out["refused"][label], label
    for kind in ("chaos", "chaos_matmul"):
        assert all(r[kind]["snapshot"] == ranks[0][kind]["snapshot"] for r in ranks)
