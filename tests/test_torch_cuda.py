"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is False.  This file imports torch and repro_torch only (no JAX), so it runs
on a machine with the GPU:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the GEMV and GEMM accumulate f32 products of the same inputs in
both versions (1e-4); attention outputs are rounded to the input dtype, so
bf16 allows about one bf16 ulp (2e-2)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as cfg_registry
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import attn
from repro_torch.kernels import fused_gemv
from repro_torch.kernels import fused_pack_mmt4d
from repro_torch.models import transformer as T
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.config import EngineConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, exact_sum: bool):
    if dtype == torch.float32 or exact_sum:
        return dict(rtol=1e-4, atol=1e-4)
    return dict(rtol=2e-2, atol=2e-2)


def _rand(dev, dtype, *shape, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 5, 8])
def test_fused_gemv_kernel(dev, dtype, m):
    rhs4 = _rand(dev, dtype, 4, 3, 128, 128, scale=384**-0.5)
    lhs = _rand(dev, dtype, m, 384, seed=m)
    before = fused_gemv.fused_gemv.launches
    got = fused_gemv.fused_gemv(lhs, rhs4)
    assert fused_gemv.fused_gemv.launches == before + 1
    torch.testing.assert_close(got, fused_gemv.fused_gemv_plain(lhs, rhs4), **_tol(dtype, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [16, 37, 300])
def test_fused_pack_mmt4d_kernel(dev, dtype, m):
    rhs4 = _rand(dev, dtype, 4, 3, 128, 128, scale=384**-0.5)
    lhs = _rand(dev, dtype, m, 384, seed=m)
    got = fused_pack_mmt4d.fused_pack_mmt4d(lhs, rhs4)
    torch.testing.assert_close(got, fused_pack_mmt4d.fused_pack_mmt4d_plain(lhs, rhs4),
                               **_tol(dtype, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,q_offset", [(40, 40, 0), (40, 72, 32), (7, 100, 93)])
def test_flash_prefill_kernel(dev, dtype, sq, sk, q_offset):
    q = _rand(dev, dtype, 2, sq, 8, 64, seed=1)
    k = _rand(dev, dtype, 2, sk, 2, 64, seed=2)
    v = _rand(dev, dtype, 2, sk, 2, 64, seed=3)
    got = attn.flash_prefill_attention(q, k, v, q_offset=q_offset)
    want = attn.flash_prefill_attention_plain(q, k, v, q_offset=q_offset)
    torch.testing.assert_close(got, want, **_tol(dtype, False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 3])
def test_paged_decode_kernel(dev, dtype, L):
    rng = np.random.RandomState(L)
    b, h, kv, d, bs, nb, pages = 3, 8, 2, 64, 16, 8, 30
    q = _rand(dev, dtype, b, L, h, d, seed=4)
    k_pool = _rand(dev, dtype, pages, bs, kv, d, seed=5)
    v_pool = _rand(dev, dtype, pages, bs, kv, d, seed=6)
    table = torch.from_numpy(rng.randint(1, pages, (b, nb)).astype(np.int32)).to(dev)
    table[1, :2] = table[0, :2]  # shared leading pages
    pos = torch.tensor([0, 37, nb * bs - L], dtype=torch.int32, device=dev)
    got = attn.paged_decode_attention(q, k_pool, v_pool, table, pos)
    want = attn.paged_decode_attention_plain(q, k_pool, v_pool, table, pos)
    torch.testing.assert_close(got, want, **_tol(dtype, False))


def test_engine_kernels_match_plain_path(dev):
    """The reduced model served through the four kernels emits the tokens
    the plain backends emit on the card."""
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    params = T.model_init(cfg, EncodingConfig(), seed=0, device=dev)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in (5, 17, 30, 9)]
    outs = []
    for enc in (EncodingConfig(backend="fused", attn_backend="auto"),
                EncodingConfig(backend="reference", attn_backend="xla")):
        eng = engine_lib.Engine(params, cfg, enc, config=EngineConfig(slots=4, max_seq=64),
                                device=dev)
        for i, p in enumerate(prompts):
            eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=6))
        outs.append({r.uid: r.generated for r in eng.run()})
    assert outs[0] == outs[1]
