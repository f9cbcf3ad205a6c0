"""The port's reduced Llama-3.2-1B (repro_torch.models) against the JAX
package's `T.forward` on weights converted by repro_torch.convert.

Both sides run f32 at the reduced size (2 layers, d 64, 4/1 heads, head dim
16).  JAX runs its Pallas kernels in interpret mode; the port runs its
kernels' plain versions on the CPU.  Logit tolerance atol = rtol = 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jcfg_registry
from repro.core.encoding import Phase as JPhase
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-4, atol=1e-4)
JENC = JEncodingConfig(enabled=True, backend="fused", attn_backend="pallas", interpret=True)
ENC = EncodingConfig(enabled=True, backend="fused", attn_backend="pallas")


@pytest.fixture(scope="module")
def model():
    jcfg = jcfg_registry.get_reduced("llama3.2-1b")
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    jparams = JT.model_init(jax.random.PRNGKey(0), jcfg, JENC)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, ENC, "cpu")
    return jcfg, jparams, cfg, params


def test_reduced_config_matches_jax():
    jcfg = jcfg_registry.get_reduced("llama3.2-1b")
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "rope_theta", "norm_eps", "dtype", "q_chunk", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim) == (2, 64, 4, 1, 16)


def test_prefill_logits_and_cache_match_jax(model):
    jcfg, jparams, cfg, params = model
    toks = np.random.RandomState(0).randint(1, cfg.vocab_size, (2, 13)).astype(np.int32)
    jcaches = JT.cache_init(jcfg, 2, 16)
    want, jnew, _ = JT.forward(jparams, {"tokens": jnp.asarray(toks)}, cfg=jcfg, enc=JENC,
                               phase=JPhase.PREFILL, caches=jcaches)
    caches = T.cache_init(cfg, 2, 16, device="cpu")
    got = T.forward(params, torch.from_numpy(toks), cfg=cfg, enc=ENC, phase=Phase.PREFILL,
                    caches=caches)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i, layer in enumerate(caches["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(layer[name].numpy(),
                                       np.asarray(jnew["groups"][0][name][i]), **TOL)


def test_paged_decode_per_row_positions_matches_jax(model):
    """One decode step, every row at its own position, rows 0 and 1 sharing
    their leading pages; the pool writes and the logits both match."""
    jcfg, jparams, cfg, params = model
    rng = np.random.RandomState(1)
    b, bs, nb, pages = 3, 4, 6, 19
    kv_shape = (cfg.num_layers, pages, bs, cfg.num_kv_heads, cfg.head_dim)
    k_pool = (0.5 * rng.randn(*kv_shape)).astype(np.float32)
    v_pool = (0.5 * rng.randn(*kv_shape)).astype(np.float32)
    table = rng.permutation(np.arange(1, pages))[: b * nb].reshape(b, nb).astype(np.int32)
    table[1, :2] = table[0, :2]
    pos = np.array([5, 9, 22], np.int32)  # rows 0/1 write past their shared pages
    toks = rng.randint(1, cfg.vocab_size, (b, 1)).astype(np.int32)

    jcaches = {"groups": ({"k": jnp.asarray(k_pool), "v": jnp.asarray(v_pool),
                           "table": jnp.asarray(np.broadcast_to(table, (cfg.num_layers, b, nb)))},)}
    want, jnew, _ = JT.forward(jparams, {"tokens": jnp.asarray(toks)}, cfg=jcfg, enc=JENC,
                               phase=JPhase.DECODE, caches=jcaches, pos=jnp.asarray(pos))
    caches = T.cache_init(cfg, b, nb * bs, cache_mode="paged", block_size=bs,
                          num_pages=pages, device="cpu")
    shared_table = torch.from_numpy(table)
    for i, layer in enumerate(caches["layers"]):
        layer["k"].copy_(torch.from_numpy(k_pool[i]))
        layer["v"].copy_(torch.from_numpy(v_pool[i]))
        layer["table"] = shared_table
    got = T.forward(params, torch.from_numpy(toks), cfg=cfg, enc=ENC, phase=Phase.DECODE,
                    caches=caches, pos=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i, layer in enumerate(caches["layers"]):
        np.testing.assert_allclose(layer["k"].numpy(), np.asarray(jnew["groups"][0]["k"][i]),
                                   **TOL)


@pytest.mark.parametrize("backend,attn_backend", [("reference", "xla"), ("xla", "xla"),
                                                  ("fused", "auto"), ("auto", "pallas")])
def test_backends_agree_on_prefill(model, backend, attn_backend):
    _, _, cfg, params = model
    toks = torch.from_numpy(np.random.RandomState(2).randint(1, cfg.vocab_size, (2, 9)))
    enc = EncodingConfig(enabled=True, backend=backend, attn_backend=attn_backend)
    got = T.forward(params, toks, cfg=cfg, enc=enc, phase=Phase.PREFILL)
    want = T.forward(params, toks, cfg=cfg, enc=ENC, phase=Phase.PREFILL)
    torch.testing.assert_close(got, want, **TOL)


def test_bf16_weights_convert_bit_exactly():
    jcfg = jcfg_registry.get_reduced("llama3.2-1b", dtype="bfloat16")
    cfg = cfg_registry.get_reduced("llama3.2-1b", dtype="bfloat16")
    np_params = jax.tree.map(np.asarray, JT.model_init(jax.random.PRNGKey(3), jcfg, JENC))
    params = convert.params_from_jax(np_params, cfg, ENC, "cpu")
    w = params["layers"][1]["mlp"]["w_down"]["w_packed"]
    assert w.dtype == torch.bfloat16
    want = np_params["groups"][0]["mlp"]["w_down"]["w_packed"][1].view(np.uint16)
    np.testing.assert_array_equal(w.view(torch.int16).numpy().view(np.uint16), want)
    np.testing.assert_array_equal(params["embed"].view(torch.int16).numpy().view(np.uint16),
                                  np_params["embed"].view(np.uint16))


def test_entry_points_default_to_cuda(model):
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only refusal")
    _, _, cfg, _ = model
    with pytest.raises(RuntimeError, match="cuda"):
        T.model_init(cfg, ENC)
