"""Qwen2-1.5B with w8a8 and w4a8 weights in the port against the JAX
package, at the reduced and head-kept sizes (tests/test_torch_archs.py: the
models and their nonzero biases): each quantized projection bit for bit on
JAX's own activations, the prefill logits, and the engine's tokens
(tests/test_torch_archs_engine.py: the routes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.encoding import Phase as JPhase
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.core import packed
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import registry
from repro_torch.models import transformer as T
from test_torch_archs import SIZES, TOL, _model
from test_torch_archs_engine import _engines


@pytest.fixture(autouse=True)
def _clean_quarantine():
    registry.clear_quarantine()
    yield
    registry.clear_quarantine()


def _quantized_inputs(jparams, jcfg, jenc, toks) -> list:
    """The activations each quantized projection of JAX's prefill receives,
    in call order (JAX run eagerly so that they are concrete)."""
    from repro.kernels import ops as jops

    seen = []
    orig = {name: getattr(jops, name) for name in ("encoded_matmul_q8", "encoded_matmul_q4")}

    def spy(name):
        def fn(x, *args, **kw):
            seen.append((np.asarray(x), args, kw, np.asarray(orig[name](x, *args, **kw))))
            return orig[name](x, *args, **kw)
        return fn

    try:
        for name in orig:
            setattr(jops, name, spy(name))
        with jax.disable_jit():
            JT.forward(jparams, {"tokens": jnp.asarray(toks)}, cfg=jcfg, enc=jenc,
                       phase=JPhase.PREFILL, caches=JT.cache_init(jcfg, 2, 16))
    finally:
        for name, fn in orig.items():
            setattr(jops, name, fn)
    return seen


@pytest.mark.parametrize("wq", ["int8", "int4"])
@pytest.mark.parametrize("size", SIZES)
def test_quantized_qwen2_1_5b_matches_jax(size, wq):
    """w8a8 and w4a8 weights on Qwen2-1.5B (biases kept in the activation
    dtype beside the quantized weight).

    Each quantized projection of JAX's prefill, fed the activations JAX fed
    it, gives JAX's output bit for bit through the port (the quantized
    kernels' plain versions).  End to end, the prefill logits agree within
    1e-4, except where the two attentions' f32 sums, a few ulp apart, land
    on either side of an activation quantizer's rounding edge: an int8 code
    then moves by one step and the logits by ~1e-2 (as at the heads size
    with int4 weights).  Such a miss must be that and nothing else: the
    first projection whose codes differ got inputs within 4 ulp of JAX's
    and moved no code by more than one step.  The engines' tokens are
    identical."""
    from repro_torch.kernels import ref

    model = _model("qwen2-1.5b", size, wq)
    jcfg, jparams, cfg, params = model
    assert "b" in params["layers"][0]["attn"]["wq"] and ("w_q" if wq == "int8" else "w_q4") \
        in params["layers"][0]["attn"]["wq"]
    jenc = JEncodingConfig(enabled=True, backend="xla", attn_backend="xla", weight_quant=wq)
    enc = EncodingConfig(backend="fused", attn_backend="pallas", weight_quant=wq)
    toks = np.random.RandomState(3).randint(1, cfg.vocab_size, (2, 11)).astype(np.int32)
    calls = _quantized_inputs(jparams, jcfg, jenc, toks)
    assert len(calls) == 7 * cfg.num_layers
    fn = packed.ops.encoded_matmul_q8 if wq == "int8" else packed.ops.encoded_matmul_q4
    for x, args, kw, want in calls:
        weights = [convert.to_torch(np.asarray(a), "cpu") for a in args[:2]]
        extra = {"group": kw["group"]} if wq == "int4" else {}
        got = fn(convert.to_torch(x, "cpu"), *weights, n=kw["n"], phase=Phase.PREFILL,
                 backend="fused", out_dtype=torch.float32, **extra)
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(JT.forward(jparams, {"tokens": jnp.asarray(toks)}, cfg=jcfg, enc=jenc,
                                 phase=JPhase.PREFILL, caches=JT.cache_init(jcfg, 2, 16))[0])
    got = T.forward(params, torch.from_numpy(toks), cfg=cfg, phase=Phase.PREFILL, enc=enc,
                    caches=T.cache_init(cfg, 2, 16, device="cpu"))
    if not np.allclose(got.numpy(), want, **TOL):
        seen = []

        def spy(x, *args, **kw):
            seen.append(x.clone())
            return fn(x, *args, **kw)

        setattr(packed.ops, fn.__name__, spy)
        try:
            T.forward(params, torch.from_numpy(toks), cfg=cfg, phase=Phase.PREFILL, enc=enc,
                      caches=T.cache_init(cfg, 2, 16, device="cpu"))
        finally:
            setattr(packed.ops, fn.__name__, fn)
        for (x, _, _, _), mine in zip(calls, seen):
            xj = convert.to_torch(x, "cpu").reshape(-1, x.shape[-1])
            xp = mine.reshape(-1, x.shape[-1])
            step = (ref.quantize_rows(xj)[0].int() - ref.quantize_rows(xp)[0].int()).abs()
            if step.max() > 0:
                ulp = torch.finfo(torch.float32).eps * xj.abs().max()
                assert (xj - xp).abs().max() <= 4 * ulp and step.max() == 1
                break
        else:
            raise AssertionError("logits differ while every activation code agrees")
    got, want = _engines(model, EncodingConfig(backend="auto", attn_backend="auto",
                                               weight_quant=wq), jenc, "paged")
    assert got == want
