"""The port's MoE block against the JAX package's in bf16, the dtype the
card serves Mixtral-8x22B in: tests/test_torch_moe.py's check_apply over
the same grid (capacity 1.25 and 8.0, 0 and 4 dispatch groups, dispatch
and dense decode, prefill and decode, bf16/int8/int4 weights) on the
reduced Mixtral with dtype bfloat16.

The bf16 rules that decide tokens are all held bit for bit: the f32 router
fed the bf16 rows cast to f32, the bf16 scatter-add dispatch buffer, silu
taken in f32 and cast to bf16 before the up product, and the f32 combine
cast back to bf16.  Expert ids, queue places and kept masks are exact, the
outputs equal.  JAX is compiled with XLA's excess precision off (see
tests/test_torch_moe.py)."""

import pytest

from test_torch_moe import FORMATS, PHASES, check_apply


@pytest.mark.parametrize("wq", FORMATS)
@pytest.mark.parametrize("phase", list(PHASES))
@pytest.mark.parametrize("dense_decode", [False, True], ids=["dispatch", "dense_decode"])
@pytest.mark.parametrize("groups", [0, 4])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_apply_matches_jax_bf16(cf, groups, dense_decode, phase, wq):
    check_apply(cf, groups, dense_decode, phase, wq, "bfloat16")
