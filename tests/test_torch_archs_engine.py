"""The dense family's engines in the port against the JAX engine: tokens on
the paged, spec and budget routes for Qwen2-1.5B, Qwen2.5-14B/32B and
Yi-9B at the reduced and head-kept sizes (tests/test_torch_archs.py: the
models, their nonzero biases and untied heads; tests/test_torch_archs_quant.py:
Qwen2-1.5B with w8a8 and w4a8 weights).  The JAX engine runs its plain
paths ("xla"), the port's registry routing ("auto"), the kernels' plain
versions on the CPU."""

import numpy as np
import pytest
import torch

from repro.serving import engine as jengine
from repro_torch.kernels import registry
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.config import EngineConfig
from test_torch_archs import AUTO, CASES, IDS, JENC, _model


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: the plain versions run many small
    ops, which more threads only slow down where the suite's workers already
    share every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_quarantine():
    registry.clear_quarantine()
    yield
    registry.clear_quarantine()


def _prompts(route, vocab):
    rng = np.random.RandomState(5)
    if route == "paged":
        return [rng.randint(1, vocab, n).astype(np.int32) for n in (3, 17, 9, 30, 12)]
    prompts = [np.tile(rng.randint(1, vocab, 3), n).astype(np.int32) for n in (2, 5, 7)]
    return prompts + [rng.randint(1, vocab, n).astype(np.int32) for n in (9, 13)]


ROUTES = {"paged": dict(slots=3, max_seq=64, block_size=8),
          "spec": dict(slots=3, max_seq=64, block_size=8, spec_decode=True, draft_k=3),
          "budget": dict(slots=3, max_seq=64, block_size=8, token_budget=16)}


def _engines(model, enc, jenc, route, max_new=5):
    jcfg, jparams, cfg, params = model
    config = ROUTES[route]
    jeng = jengine.Engine(jparams, jcfg, jenc, **config)
    eng = engine_lib.Engine(params, cfg, enc, config=EngineConfig(**config), device="cpu")
    for e, req in ((jeng, jengine.Request), (eng, engine_lib.Request)):
        for i, p in enumerate(_prompts(route, cfg.vocab_size)):
            e.submit(req(uid=i, prompt=p, max_new_tokens=max_new))
    want = {r.uid: r.generated for r in jeng.run()}
    got = {r.uid: r.generated for r in eng.run()}
    assert all(r.status == "ok" for r in eng.finished)
    eng.audit()
    st = eng.stats
    assert st["pages_in_use"] == 0 and not st["degraded"]
    if route == "spec":
        assert st["spec"]["proposed"] > 0 and eng.dispatches["verify"] > 0
    if route == "budget":
        assert st["continuous"] == jeng.stats["continuous"]
    return got, want


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("arch,size", CASES, ids=IDS)
def test_engine_tokens_match_jax(arch, size, route):
    got, want = _engines(_model(arch, size), AUTO, JENC, route)
    assert got == want
