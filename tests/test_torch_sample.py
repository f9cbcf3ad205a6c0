"""Temperature sampling in the port against the JAX package.

- The key stream: prng_key, fold_in, random_bits (the partitionable
  Threefry-2x32 bits) and uniform equal jax.random's bit for bit over
  several seeds, step indices and shapes, an odd V and a flat size above
  2**16 included.  gumbel is -log(-log(u)) of the same u; XLA's and torch's
  log may differ in the last bit, which the outer log carries as an
  absolute error, so it is held to 2 ulp of max(1, |g|).
- sample_rows (JAX's decode_sampled body) gives JAX's indices at
  temperatures {0, 0.5, 1, 2}; rows at temperature <= 0 stay greedy.
- The port's Engine(sample="temperature") emits the JAX engine's tokens for
  the same seed, requests and mixed temperatures on the reduced
  Llama-3.2-1B: paged vectorized (also under preemption, which replays with
  fresh keys) and dense grouped, the JAX side on its plain "xla" paths.
- Ports of tests/test_spec_decode.py's sampling tests: temperature-0 rows
  equal greedy, the same seed gives the same stream, spec decode and the
  token budget are off under sampling.
- A chi-square test of the sampler's frequencies against softmax(l / T).
- The Gumbel noise keeps its bits under process states a test worker may
  carry (thread count, flushed denormals, MKL's low-accuracy vector math).
"""

import contextlib
import ctypes
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jcfg_registry
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import registry
from repro_torch.serving import engine as engine_lib
from repro_torch.serving import sampling
from repro_torch.serving.config import EngineConfig

JXLA = JEncodingConfig(enabled=True, backend="xla", attn_backend="xla")
AUTO = EncodingConfig(enabled=True, backend="auto", attn_backend="auto")
EPS32 = float(np.finfo(np.float32).eps)


def _jkey(key) -> tuple[int, int]:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


# ---------------------------------------------------------------------------
# The key stream


@pytest.mark.parametrize("seed", [0, 1, 9, 12345, 2**31 - 1, -7, 2**32 + 3])
def test_keys_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert sampling.prng_key(seed) == _jkey(key)
    for d in (0, 1, 7, 1000, 2**31, 2**32 - 1):
        assert sampling.fold_in(sampling.prng_key(seed), d) == _jkey(jax.random.fold_in(key, d))


@pytest.mark.parametrize("shape", [(4, 1001), (70001,), (2, 3, 5), (4, 128256)])
@pytest.mark.parametrize("seed,step", [(0, 0), (9, 3), (12345, 100000)])
def test_bits_and_uniform_match_jax(shape, seed, step):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    tkey = sampling.fold_in(sampling.prng_key(seed), step)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(sampling.random_bits(tkey, shape).numpy(), want)
    for lo, hi in ((0.0, 1.0), (sampling.TINY, 1.0), (-2.0, 3.0)):
        want = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi))
        got = sampling.uniform(tkey, shape, minval=lo, maxval=hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shape", [(4, 1001), (70001,)])
def test_gumbel_and_categorical_match_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    tkey = sampling.fold_in(sampling.prng_key(3), 5)
    want = np.asarray(jax.random.gumbel(key, shape))
    got = sampling.gumbel(tkey, shape).numpy()
    assert np.all(np.abs(got - want) <= 2 * EPS32 * np.maximum(1.0, np.abs(want)))
    logits = 3 * np.random.RandomState(0).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(
        sampling.categorical(tkey, torch.from_numpy(logits)).numpy(),
        np.asarray(jax.random.categorical(key, logits)))


@contextlib.contextmanager
def _process_state(state: str):
    """A state a test worker's process may carry from earlier tests: fewer
    intra-op threads, denormals flushed, or MKL's vector math in its
    low-accuracy mode (where this torch build exports vmlSetMode)."""
    if state.startswith("threads"):
        n = torch.get_num_threads()
        torch.set_num_threads(int(state[len("threads"):]))
        try:
            yield
        finally:
            torch.set_num_threads(n)
    elif state == "flush_denormal":
        torch.set_flush_denormal(True)
        try:
            yield
        finally:
            torch.set_flush_denormal(False)
    else:  # "vml_ep": MKL VML's enhanced-performance (half-precision-bits) mode
        lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                       "libtorch_cpu.so"))
        if not hasattr(lib, "vmlSetMode"):
            yield
            return
        old = lib.vmlSetMode(ctypes.c_uint(0x3))
        try:
            yield
        finally:
            lib.vmlSetMode(ctypes.c_uint(old))


@pytest.mark.parametrize("state", ["threads1", "threads2", "flush_denormal", "vml_ep"])
def test_gumbel_independent_of_process_state(state):
    """Regression for noise that drifted in a multi-worker run (one value
    off by 9e-5, passing in a fresh process): under each process state the
    port's Gumbel noise has the same bits as in the default state and stays
    within 2 ulp of JAX's, for the decode shape and a flat size above the
    intra-op grain."""
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    tkey = sampling.fold_in(sampling.prng_key(3), 5)
    for shape in ((4, 1001), (70001,)):
        want = np.asarray(jax.random.gumbel(key, shape))
        fresh = sampling.gumbel(tkey, shape)
        with _process_state(state):
            got = sampling.gumbel(tkey, shape)
        assert torch.equal(got, fresh)
        got = got.numpy()
        assert np.all(np.abs(got - want) <= 2 * EPS32 * np.maximum(1.0, np.abs(want)))


def _jax_decode_sampled(logits, temp, key):
    """repro/serving/engine.py make_decode_step(sample="temperature")'s body
    after the forward."""
    last = jnp.asarray(logits).astype(jnp.float32)
    greedy = jnp.argmax(last, axis=-1).astype(jnp.int32)
    scaled = last / jnp.maximum(temp, 1e-6)[:, None]
    sampled = jax.random.categorical(key, scaled, axis=-1).astype(jnp.int32)
    return np.asarray(jnp.where(temp > 0, sampled, greedy))


@pytest.mark.parametrize("t", [0.0, 0.5, 1.0, 2.0])
def test_sample_rows_matches_jax(t):
    rng = np.random.RandomState(int(10 * t))
    logits = 4 * rng.randn(6, 257).astype(np.float32)
    temp = np.array([t, 0.0, t, -1.0, t, 0.7], np.float32)
    for step in range(4):
        key = jax.random.fold_in(jax.random.PRNGKey(11), step)
        got = sampling.sample_rows(torch.from_numpy(logits), torch.from_numpy(temp),
                                   sampling.fold_in(sampling.prng_key(11), step)).numpy()
        np.testing.assert_array_equal(got, _jax_decode_sampled(logits, jnp.asarray(temp), key))
        greedy = logits.argmax(-1)
        assert np.all(got[temp <= 0] == greedy[temp <= 0])


def test_sampler_frequencies_follow_softmax():
    """20000 rows of the same 8 logits at T = 0.7 under one key: the counts
    against softmax(l / T).  Threshold: the chi-square critical value of 7
    degrees of freedom at p = 0.001, 24.32 (the draw is seeded, so the test
    is deterministic)."""
    logits = torch.tensor([1.0, 0.5, 0.0, -0.5, 2.0, -1.0, 0.25, 1.5])
    n, t = 20000, 0.7
    draws = sampling.sample_rows(logits.expand(n, -1), torch.full((n,), t),
                                 sampling.fold_in(sampling.prng_key(5), 0))
    counts = torch.bincount(draws, minlength=8).double()
    expect = n * torch.softmax(logits.double() / t, dim=0)
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 24.32, (chi2, counts.tolist(), expect.tolist())


# ---------------------------------------------------------------------------
# The engine against the JAX engine


@pytest.fixture(scope="module")
def model():
    jcfg = jcfg_registry.get_reduced("llama3.2-1b")
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    jparams = JT.model_init(jax.random.PRNGKey(0), jcfg, JXLA)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, AUTO, "cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(autouse=True)
def _clean_quarantine():
    registry.clear_quarantine()
    yield
    registry.clear_quarantine()


def _serve(eng, req_cls, prompts, temps, max_new=6):
    for i, (p, t) in enumerate(zip(prompts, temps)):
        eng.submit(req_cls(uid=i, prompt=p, max_new_tokens=max_new, temperature=t))
    done = eng.run()
    assert all(r.status == "ok" for r in done)
    return {r.uid: r.generated for r in done}


@pytest.mark.parametrize("case", ["vectorized", "grouped", "preemption"])
def test_sampled_engine_tokens_match_jax(model, case):
    jcfg, jparams, cfg, params = model
    rng = np.random.RandomState(23)
    vocab = cfg.vocab_size
    config = dict(slots=4, max_seq=64, block_size=8, sample="temperature", seed=7)
    lengths = (3, 17, 9, 30, 12, 5)
    if case == "grouped":
        config = dict(config, decode_mode="grouped")
    elif case == "preemption":
        config = dict(config, slots=3, max_seq=32, block_size=4, pool_pages=12)
        lengths = (9, 11, 10, 12)
    prompts = [rng.randint(1, vocab, n).astype(np.int32) for n in lengths]
    temps = [(0.0, 0.5, 1.0, 2.0)[i % 4] for i in range(len(prompts))]
    jeng = jengine.Engine(jparams, jcfg, JXLA, **config)
    eng = engine_lib.Engine(params, cfg, AUTO, config=EngineConfig(**config), device="cpu")
    want = _serve(jeng, jengine.Request, prompts, temps, max_new=10)
    got = _serve(eng, engine_lib.Request, prompts, temps, max_new=10)
    assert got == want
    assert eng._step_idx == jeng._step_idx > 0
    st, js = eng.stats, jeng.stats
    assert st["sample"] == js["sample"] == "temperature"
    assert st["decode_mode"] == js["decode_mode"] and st["cache_mode"] == js["cache_mode"]
    if case == "preemption":
        assert st["preemptions"] == js["preemptions"] > 0
    if case == "grouped":
        assert eng.dispatches["decode"] > st["steps"] - eng.dispatches["prefill"]


def test_engine_sampled_greedy_requests_match_greedy_engine(model):
    """Temperature-0 requests in a sampling engine emit the greedy engine's
    tokens (the key stream must not perturb greedy rows)."""
    _, _, cfg, params = model
    rng = np.random.RandomState(17)
    prompts = [rng.randint(1, cfg.vocab_size, 4 + i).astype(np.int32) for i in range(3)]

    def run(sample):
        eng = engine_lib.Engine(params, cfg, AUTO, device="cpu", config=EngineConfig(
            slots=2, max_seq=32, sample=sample, seed=9))
        return _serve(eng, engine_lib.Request, prompts, [0.0] * 3, max_new=5)

    assert run("temperature") == run("greedy")


def test_engine_sampling_deterministic_per_seed(model):
    _, _, cfg, params = model
    rng = np.random.RandomState(19)
    prompts = [rng.randint(1, cfg.vocab_size, 5).astype(np.int32) for _ in range(2)]

    def run(seed):
        eng = engine_lib.Engine(params, cfg, AUTO, device="cpu", config=EngineConfig(
            slots=2, max_seq=32, sample="temperature", seed=seed, cache_mode="dense"))
        return _serve(eng, engine_lib.Request, prompts, [2.0, 2.0])

    assert run(5) == run(5)  # same seed, same stream
    assert run(5) != run(6)  # a hot temperature departs under another seed


@pytest.mark.parametrize("kw,field,note", [
    (dict(spec_decode=True), "spec_decode", "spec_decode:off(sample)"),
    (dict(token_budget=16), "token_budget", "token_budget:off(needs_verify_window)"),
])
def test_windows_off_under_sampling(model, kw, field, note):
    """No greedy target to verify against: resolve() switches speculation and
    the token budget off, as in JAX; the greedy twin keeps them."""
    jcfg, jparams, cfg, params = model
    config = dict(slots=2, max_seq=32, **kw)
    eng = engine_lib.Engine(params, cfg, AUTO, device="cpu",
                            config=EngineConfig(sample="temperature", **config))
    jeng = jengine.Engine(jparams, jcfg, JXLA, sample="temperature", **config)
    assert not getattr(eng.config, field) and not getattr(jeng.config, field)
    assert note in eng.config.downgrades and eng.config.downgrades == jeng.config.downgrades
    assert eng.spec_decode is False and eng.token_budget is None
    twin = engine_lib.Engine(params, cfg, AUTO, device="cpu", config=EngineConfig(**config))
    assert getattr(twin.config, field)


def test_config_rejects_unknown_sample_mode():
    with pytest.raises(ValueError, match="sample"):
        EngineConfig(sample="nucleus")
