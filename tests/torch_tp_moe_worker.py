"""Rank bodies of tests/test_torch_tp_moe.py.  The ranks are spawned
processes that import this module (not the test file), so it imports
nothing of JAX: every JAX reference is computed in the parent."""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.encoding import Phase
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import collectives, sharding

import torch_tp_worker as W

PAGED = dict(slots=3, max_seq=64, block_size=8)
RING = dict(slots=3, max_seq=64)  # Mixtral's window of 16: resolve() serves the dense ring
# name -> (model, weight format, engine config).  Model "grok" is the reduced
# Grok-1-314B (no window: the paged cache), "mixtral" the reduced
# Mixtral-8x22B (window 16: the ring), "+dd" either with moe_dense_decode.
# With 3 slots a decode dispatch has cap = int(1.25 * 3 * 2 / 4) = 1 row an
# expert, so most steps drop pairs: every rank must route and drop alike.
MATRIX = {
    "grok paged": ("grok", "none", PAGED),
    "grok spec": ("grok", "none", dict(PAGED, spec_decode=True, draft_k=3)),
    "grok dense-decode": ("grok+dd", "none", PAGED),
    "grok w8a8": ("grok", "int8", PAGED),
    "mixtral ring": ("mixtral", "none", RING),
    "mixtral ring grouped": ("mixtral", "none", dict(RING, decode_mode="grouped")),
    "mixtral dense-decode": ("mixtral+dd", "none", RING),
    "mixtral w8a8": ("mixtral", "int8", RING),
    # Held to the port's own tp = 1 (the JAX engine runs no kv4 or int4
    # under a mesh).
    "grok kv4": ("grok", "none", dict(PAGED, kv_quant="kv4")),
    "grok w4a8": ("grok", "int4", PAGED),
    "mixtral w4a8": ("mixtral", "int4", RING),
}
PORT_HELD = ("grok kv4", "grok w4a8", "mixtral w4a8")


def base(model: str) -> str:
    return model.split("+")[0]


def prompts(model: str, vocab: int) -> list:
    """Grok: tiled prompts (spec drafts get accepted) and two random ones;
    Mixtral: prompts up to the window and at twice it (a multiple of the
    ring, where JAX's ring prefill is right: tests/test_torch_window.py)."""
    rng = np.random.RandomState(5)
    if base(model) == "mixtral":
        return [rng.randint(1, vocab, n).astype(np.int32) for n in (5, 16, 32, 11)]
    tiled = [np.tile(rng.randint(1, vocab, 3), n).astype(np.int32) for n in (2, 5, 7)]
    return tiled + [rng.randint(1, vocab, n).astype(np.int32) for n in (9, 13)]


def serve(params, cfg, model: str, fmt: str, config: dict, *, tp: int):
    """(tokens by uid, engine) of the model's prompts served to the end."""
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving.config import EngineConfig

    eng = engine_lib.Engine(params, cfg, W.encoding(fmt), device="cpu",
                            config=EngineConfig(mesh_shape=(tp,), **config))
    for i, p in enumerate(prompts(model, cfg.vocab_size)):
        eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=6))
    eng.run()
    eng.audit()
    assert all(r.status == "ok" and len(r.generated) == 6 for r in eng.finished), [
        (r.uid, r.status, r.error) for r in eng.finished]
    return {r.uid: list(r.generated) for r in eng.finished}, eng


def rank_main(rank: int, world: int, device: str, cfgs: dict, params: dict) -> dict:
    """Every MoE case of MATRIX at tp = world on this rank, then one MoE
    layer at tp = world against one card's; `cfgs` by model, `params` by
    (base model, weight format), each the whole tree (the engine slices
    this rank's shard)."""
    del device
    out = {"tokens": {}, "collectives": {}}
    for name, (model, fmt, config) in MATRIX.items():
        cfg = cfgs[model]
        full = params[(base(model), fmt)]
        before = collectives.counts.copy()
        got, eng = serve(full, cfg, model, fmt, config, tp=world)
        st = eng.stats
        assert eng.tp_shards == world and st["tp"]["enc_downgrades"] == []
        assert st["cache_mode"] == ("dense" if cfg.sliding_window else "paged"), name
        # The shard really splits each expert's FFN columns; the router is whole.
        assert eng.shard.mlp_split and eng.model_cfg.d_ff == cfg.d_ff // world
        assert eng.model_cfg.num_experts == cfg.num_experts
        moe, whole = eng.params["layers"][0]["moe"], full["layers"][0]["moe"]
        assert all(torch.equal(moe["router"][k], whole["router"][k]) for k in whole["router"])
        assert len(moe["w_down"]) == cfg.num_experts
        out["tokens"][name] = got
        out["collectives"][name] = {"counts": dict(collectives.counts - before),
                                    "dispatches": sum(eng.dispatches.values())}
    out["moe_layer"] = moe_layer_check(cfgs, params, rank, world)
    return out


def moe_layer_check(cfgs: dict, params: dict, rank: int, world: int) -> dict:
    """Layer 0's MoE block on this rank's shard (moe_apply with tp) against
    one card's on the same rows, at prefill (a capacity buffer of 2 x 9
    rows) and decode (3 rows; the dense-decode combine too), in f32, w8a8
    and w4a8: w8a8 bit for bit (the gate/up columns are one card's, the
    stacked w_down sums exact integers), f32 and w4a8 within f32 summation
    order.  Each call makes one all_reduce_sum (and one all_reduce_max with
    int8/int4 weights), never one an expert.  Returns the largest
    |tp - one card| by case."""
    group = dist.group.WORLD
    gen = torch.Generator().manual_seed(11)
    worst = {}
    for model in ("grok", "grok+dd"):
        cfg = cfgs[model]
        for fmt in ("none", "int8", "int4"):
            enc = W.encoding(fmt)
            shard = sharding.plan(cfg, enc, world, rank, group=group)
            layer = params[("grok", fmt)]["layers"][0]
            full = layer["moe"]
            part = sharding.shard_layer(layer, cfg, shard, enc.quant_group)["moe"]
            for phase, shape in ((Phase.PREFILL, (2, 9)), (Phase.DECODE, (3, 1))):
                x = torch.randn(*shape, cfg.d_model, generator=gen)
                one = L.moe_apply(full, x, cfg=cfg, enc=enc, phase=phase)
                before = collectives.counts.copy()
                got = L.moe_apply(part, x, cfg=shard.cfg, enc=enc, phase=phase, tp=shard)
                calls = collectives.counts - before
                assert calls["all_reduce_sum"] == 1, (model, fmt, phase, calls)
                assert calls["all_reduce_max"] == (0 if fmt == "none" else 1), calls
                if fmt == "int8":
                    assert torch.equal(got, one), (model, fmt, phase)
                else:
                    torch.testing.assert_close(got, one, rtol=1e-5, atol=1e-5)
                key = f"{model} {fmt} {phase.value}"
                worst[key] = (got - one).abs().max().item()
    # bf16, the dtype the card serves: the partials are summed in f32 and
    # cast once, as one card casts its f32 products once, so a rank's
    # output is one card's or the next bf16 value (its f32 sum, in another
    # order, rounds either way); partials cast before the sum would miss by
    # more wherever they cancel.
    cfg = dataclasses.replace(cfgs["grok"], dtype="bfloat16")
    enc = W.encoding("none")
    shard = sharding.plan(cfg, enc, world, rank, group=group)
    layer = T.model_init(cfg, enc, seed=2, device="cpu")["layers"][0]
    part = sharding.shard_layer(layer, cfg, shard, enc.quant_group)["moe"]
    for phase, shape in ((Phase.PREFILL, (2, 9)), (Phase.DECODE, (3, 1))):
        x = torch.randn(*shape, cfg.d_model, generator=gen).to(torch.bfloat16)
        one = L.moe_apply(layer["moe"], x, cfg=cfg, enc=enc, phase=phase).float()
        got = L.moe_apply(part, x, cfg=shard.cfg, enc=enc, phase=phase, tp=shard).float()
        step = torch.where(one == 0, 0.0, 2.0 ** (torch.floor(torch.log2(one.abs())) - 7))
        assert ((got - one).abs() <= step).all(), (phase, (got - one).abs().max())
        worst[f"grok bf16 {phase.value}"] = ((got - one).abs() / step.clamp(min=1e-30)).max().item()
    return worst
