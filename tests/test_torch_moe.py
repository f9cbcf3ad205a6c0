"""The port's MoE block (models/layers.moe_apply) against the JAX package's
on the reduced Mixtral-8x22B (4 experts, top-2), weights converted from
the JAX pytree by convert.params_from_jax in each weight format.

Inputs come from a numpy seed.  The JAX side runs its plain projections
(backend "xla"), the port registry routing ("fused": the kernels' plain
versions on the CPU).  The routing is held exactly (expert ids, places in
the queues, kept masks), the output to 1e-5 in f32 and bit for bit in
bf16.  JAX's moe_apply is compiled with XLA's excess precision off
(STRICT): by default XLA on the CPU may keep f32 where the program casts
an f32 value to bf16 and uses it again, which moves bf16 outputs by a few
ulps and the engine's tokens with them; without it JAX rounds where its
program says, as the port does."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jcfg_registry
from repro.core import packed as jpacked
from repro.core.encoding import Phase as JPhase
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)
STRICT = {"xla_allow_excess_precision": False}
FORMATS = ("none", "int8", "int4")
PHASES = {"prefill": (Phase.PREFILL, JPhase.PREFILL), "decode": (Phase.DECODE, JPhase.DECODE)}


@functools.lru_cache(maxsize=None)
def _jax_params(wq: str, dtype: str = "float32"):
    """A JAX reduced Mixtral's params in weight format `wq` and activation
    dtype `dtype`, as numpy (the init jitted: one compile, not one per op)."""
    jcfg = jcfg_registry.get_reduced("mixtral-8x22b", dtype=dtype)
    jenc = JEncodingConfig(enabled=True, backend="xla", weight_quant=wq)
    init = jax.jit(functools.partial(JT.model_init, cfg=jcfg, enc=jenc))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(3)))


@functools.lru_cache(maxsize=None)
def _weights(wq: str, tie: bool = False, dtype: str = "float32"):
    """(jmoe, moe): layer 0's MoE params of _jax_params(wq, dtype) and their
    conversion.  `tie` copies the router row of expert 2 onto expert 3 in
    every router leaf, so the two always tie."""
    np_params = _jax_params(wq, dtype)
    if tie:
        np_params = dict(np_params, groups=(dict(np_params["groups"][0]),))
        group = np_params["groups"][0]
        group["moe"] = dict(group["moe"], router=dict(group["moe"]["router"]))
        router = group["moe"]["router"]
        for name, leaf in router.items():
            leaf = np.array(leaf)
            if leaf.ndim == 3:  # w_scale (L, N1, N0)
                leaf[:, 0, 3] = leaf[:, 0, 2]
            else:  # (L, N1, K1, N0, ...)
                leaf[:, 0, :, 3] = leaf[:, 0, :, 2]
            router[name] = leaf
    cfg = cfg_registry.get_reduced("mixtral-8x22b", dtype=dtype)
    params = convert.params_from_jax(np_params, cfg, EncodingConfig(weight_quant=wq), "cpu")
    jmoe = jax.tree.map(lambda a: jnp.asarray(a[0]), np_params["groups"][0]["moe"])
    return jmoe, params["layers"][0]["moe"]


def _configs(**kw):
    return (jcfg_registry.get_reduced("mixtral-8x22b", **kw),
            cfg_registry.get_reduced("mixtral-8x22b", **kw))


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_routing(jmoe, x2d, jcfg, jenc, jphase, groups):
    """JAX's router and queue places, from jnp: the logits by JAX's own
    linear_apply, then top_k and the slot-major cumsum of moe_apply."""
    e, k = jcfg.num_experts, jcfg.experts_per_token
    logits = jpacked.linear_apply(jmoe["router"], jnp.asarray(x2d), n=e, phase=jphase, enc=jenc,
                                  out_dtype=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, eidx = jax.lax.top_k(probs, k)
    t = x2d.shape[0]
    tg = t // groups
    onehot = jax.nn.one_hot(eidx, e, dtype=jnp.float32)
    oh_g = onehot.reshape(groups, tg, k, e).transpose(0, 2, 1, 3).reshape(groups, k * tg, e)
    pos = ((jnp.cumsum(oh_g, axis=1) - oh_g) * oh_g).sum(-1)
    position = pos.reshape(groups, k, tg).transpose(0, 2, 1).astype(jnp.int32)
    return np.asarray(probs), np.asarray(eidx), np.asarray(position)


@functools.lru_cache(maxsize=None)
def _jax_moe(jcfg, wq: str, phase: str):
    """JAX's moe_apply, jitted once per configuration (one compile instead
    of an eager compile per op and shape), with excess precision off."""
    jenc = JEncodingConfig(enabled=True, backend="xla", weight_quant=wq)
    return jax.jit(functools.partial(JL.moe_apply, cfg=jcfg, enc=jenc, phase=PHASES[phase][1]),
                   compiler_options=STRICT)


def _check(jmoe, moe, x, jcfg, cfg, wq, phase):
    """x: f32 numpy, cast to the model's dtype on both sides."""
    tph, jph = PHASES[phase]
    jenc = JEncodingConfig(enabled=True, backend="xla", weight_quant=wq)
    enc = EncodingConfig(backend="fused", attn_backend="pallas", weight_quant=wq)
    bf16 = cfg.dtype == "bfloat16"
    xj = jnp.asarray(x).astype(jcfg.activation_dtype)
    xt = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    want, _ = _jax_moe(jcfg, wq, phase)(jmoe, xj)
    got = L.moe_apply(moe, xt, cfg=cfg, enc=enc, phase=tph).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if bf16:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)

    x2d = xt.reshape(-1, x.shape[-1])
    groups, cap = L.moe_capacity(cfg, x2d.shape[0])
    jprobs, jeidx, jposition = _jax_routing(jmoe, xj.reshape(x2d.shape), jcfg, jenc, jph, groups)
    probs, _, eidx = L.moe_route(moe, x2d, cfg=cfg, enc=enc, phase=tph)
    np.testing.assert_allclose(probs.numpy(), jprobs, **TOL)
    np.testing.assert_array_equal(eidx.numpy(), jeidx)
    position, keep = L.moe_positions(eidx, cfg)
    np.testing.assert_array_equal(position.numpy(), jposition)
    np.testing.assert_array_equal(keep.numpy(), jposition < cap)
    return got, keep.numpy(), eidx.numpy(), probs.numpy()


def check_apply(cf, groups, dense_decode, phase, wq, dtype):
    """Decode is a (12, 1) batch (a 12-slot step), prefill a (2, 12) one;
    the rows are 3 random vectors tiled, so each expert's queue is long
    enough that capacity 1.25 must drop pairs (an expert chosen by m of the
    vectors gets 4m or 8m pairs, more than cap for one of them), grouped or
    not, and 8.0 cannot.  Random rows too, where drops depend on the draw."""
    jmoe, moe = _weights(wq, dtype=dtype)
    jcfg, cfg = _configs(capacity_factor=cf, moe_dispatch_groups=groups,
                         moe_dense_decode=dense_decode, dtype=dtype)
    shape = (12, 1, 64) if phase == "decode" else (2, 12, 64)
    t = shape[0] * shape[1]
    x = np.tile(_x((3, 64)), (t // 3, 1)).reshape(shape)
    _, keep, _, _ = _check(jmoe, moe, x, jcfg, cfg, wq, phase)
    assert (not keep.all()) == (cf == 1.25)
    assert L.moe_capacity(cfg, t)[0] == (groups or 1)
    _check(jmoe, moe, _x(shape), jcfg, cfg, wq, phase)


@pytest.mark.parametrize("wq", FORMATS)
@pytest.mark.parametrize("phase", list(PHASES))
@pytest.mark.parametrize("dense_decode", [False, True], ids=["dispatch", "dense_decode"])
@pytest.mark.parametrize("groups", [0, 4])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_apply_matches_jax(cf, groups, dense_decode, phase, wq):
    """check_apply in f32 (tests/test_torch_moe_bf16.py: in bf16)."""
    check_apply(cf, groups, dense_decode, phase, wq, "float32")


def test_moe_dead_rows_take_capacity():
    """Dead slots route and take capacity like live ones.  Two live decode
    rows alone get cap 1 an expert, and their second choices drop.  Beside
    two dead rows the dispatch has 4 rows and cap 2: dead rows that route
    as the live ones do take those places (the live second choices still
    drop), while zero rows (uniform router: experts 0 and 1, the tie going
    to the lower ids) leave them free.  The port matches JAX in all three."""
    jmoe, moe = _weights("none")
    jcfg, cfg = _configs()
    assert L.moe_capacity(cfg, 2) == (1, 1) and L.moe_capacity(cfg, 4) == (1, 2)
    live = _x((2, 1, 64), seed=1)
    runs = {}
    for name, x in (("live", live), ("dead", np.concatenate([live, live[::-1]])),
                    ("zero", np.concatenate([live, np.zeros_like(live)]))):
        got, keep, eidx, _ = _check(jmoe, moe, x, jcfg, cfg, "none", "decode")
        runs[name] = (got[:2], keep[0], eidx)
    assert not runs["live"][1][:, 1].any() and not runs["dead"][1][:2, 1].any()
    assert runs["zero"][1][:2, 1].all()
    np.testing.assert_array_equal(runs["zero"][2][2:], [[0, 1], [0, 1]])
    np.testing.assert_allclose(runs["dead"][0], runs["live"][0], **TOL)
    assert not np.allclose(runs["zero"][0], runs["live"][0], atol=1e-3)


@pytest.mark.parametrize("wq", FORMATS)
def test_moe_router_ties_go_to_the_lower_expert(wq):
    """Experts 2 and 3 share their router row, so their probabilities tie
    on every row: 3 is chosen only together with 2 and after it, and where
    2 is the second choice, 3 loses the tie, as under jax.lax.top_k."""
    jmoe, moe = _weights(wq, tie=True)
    jcfg, cfg = _configs(capacity_factor=8.0)
    x = _x((2, 12, 64), seed=2)
    _, _, eidx, probs = _check(jmoe, moe, x, jcfg, cfg, wq, "prefill")
    assert np.array_equal(probs[:, 2], probs[:, 3])
    with3 = (eidx == 3).any(axis=1)
    assert (eidx[with3] == [2, 3]).all()
    assert (eidx[:, 1] == 2).any()


def test_top_k_breaks_ties_as_jax():
    rng = np.random.RandomState(4)
    vals = rng.choice(np.array([0.1, 0.2, 0.3], np.float32), size=(64, 8))
    got_v, got_i = L.top_k(torch.from_numpy(vals), 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(vals), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("wq", FORMATS)
def test_params_from_jax_splits_experts(wq):
    cfg = cfg_registry.get_reduced("mixtral-8x22b")
    np_params = _jax_params(wq)
    params = convert.params_from_jax(np_params, cfg, EncodingConfig(weight_quant=wq), "cpu")
    jmoe = np_params["groups"][0]["moe"]
    assert len(params["layers"]) == cfg.num_layers
    for i, layer in enumerate(params["layers"]):
        assert "mlp" not in layer
        moe = layer["moe"]
        for key, leaf in jmoe["router"].items():
            np.testing.assert_array_equal(_np(moe["router"][key]), leaf[i])
        for name in ("w_gate", "w_up", "w_down"):
            assert len(moe[name]) == cfg.num_experts
            for j, expert in enumerate(moe[name]):
                assert set(expert) == set(jmoe[name])
                for key, leaf in jmoe[name].items():
                    np.testing.assert_array_equal(_np(expert[key]), leaf[i, j])


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(jnp.bfloat16)
    return t.numpy()


def test_model_init_makes_moe_layers():
    from repro_torch.models import transformer as T

    cfg = cfg_registry.get_reduced("mixtral-8x22b")
    for wq in FORMATS:
        params = T.model_init(cfg, EncodingConfig(weight_quant=wq), seed=0, device="cpu")
        moe = params["layers"][0]["moe"]
        jmoe = jax.tree.map(lambda a: a[0], _jax_params(wq)["groups"][0]["moe"])
        for key, leaf in jmoe["router"].items():
            assert tuple(moe["router"][key].shape) == leaf.shape
            assert str(moe["router"][key].dtype).split(".")[-1] == str(leaf.dtype)
        for name in ("w_gate", "w_up", "w_down"):
            for key, leaf in jmoe[name].items():
                assert tuple(moe[name][0][key].shape) == leaf.shape[1:]


def test_moe_shard_map_falls_back_to_the_grouped_path():
    """moe_shard_map without a mesh: JAX takes its grouped path, and so does
    the port on one card (capacity 1.25 with 4 groups: drops included)."""
    jmoe, moe = _weights("none")
    jcfg, cfg = _configs(moe_shard_map=True, moe_dispatch_groups=4)
    x = np.tile(_x((3, 64)), (8, 1)).reshape(2, 12, 64)
    got, keep, _, _ = _check(jmoe, moe, x, jcfg, cfg, "none", "prefill")
    assert not keep.all()
    base_j, base = _configs(moe_dispatch_groups=4)
    np.testing.assert_array_equal(got, _check(jmoe, moe, x, base_j, base, "none", "prefill")[0])
