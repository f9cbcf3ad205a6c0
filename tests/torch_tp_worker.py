"""Rank bodies of tests/test_torch_tp_engine.py.  The ranks are spawned
processes that import this module (not the test file), so it imports
nothing of JAX: every JAX reference is computed in the parent."""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import packed
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import registry
from repro_torch.parallel import collectives, sharding
from repro_torch.serving import engine as engine_lib
from repro_torch.serving import faults as faults_lib
from repro_torch.serving import paged as paged_lib
from repro_torch.serving.config import EngineConfig

PAGED = dict(slots=2, max_seq=64, cache_mode="paged", block_size=8)
# name -> (weight format, engine config); JAX's tests/test_tp_mesh.py matrix
# plus kv4 and the quantized weights.
MATRIX = {
    "paged": ("none", PAGED),
    "dense": ("none", dict(slots=2, max_seq=64, cache_mode="dense")),
    "spec": ("none", dict(PAGED, spec_decode=True, draft_k=3)),
    "budget": ("none", dict(PAGED, token_budget=16)),
    "kv8": ("none", dict(PAGED, kv_quant="kv8")),
    "w8a8": ("int8", PAGED),
    "kv4": ("none", dict(PAGED, kv_quant="kv4")),
    "w4a8": ("int4", PAGED),
}
# Pool pressure: preemption and replay (JAX's _TP_PREEMPT_SCRIPT).
PREEMPT = dict(slots=3, max_seq=64, cache_mode="paged", block_size=8, pool_pages=6)


def encoding(fmt: str) -> EncodingConfig:
    # "auto" matmuls and attention: the registry's kernel routes, whose
    # plain versions run on CPU tensors; kv4 stays kv4 (an "xla" attention
    # would ride it on kv8).
    return EncodingConfig(enabled=True, backend="auto", attn_backend="auto", weight_quant=fmt)


def prompts(vocab: int) -> list:
    return [((np.arange(5 + 3 * i) * 7 + i) % (vocab - 1) + 1).astype(np.int32)
            for i in range(4)]


def serve(params, cfg, enc, config: dict, *, tp: int, max_new: int = 6,
          audit_every_step: bool = False, **engine_kw):
    """(tokens by uid, engine) of the four prompts served to the end."""
    eng = engine_lib.Engine(params, cfg, enc, device="cpu",
                            config=EngineConfig(mesh_shape=(tp,), **config), **engine_kw)
    for i, p in enumerate(prompts(cfg.vocab_size)):
        eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=max_new))
    if audit_every_step:
        while eng.queue or any(r is not None for r in eng.slot_req):
            eng.step()
            eng.audit()
    else:
        eng.run()
        eng.audit()
    assert all(r.status == "ok" for r in eng.finished), [
        (r.uid, r.status, r.error) for r in eng.finished]
    return {r.uid: list(r.generated) for r in eng.finished}, eng


def rank_main(rank: int, world: int, device: str, cfg, params_by_fmt: dict, refused_cfgs) -> dict:
    """Everything one rank checks at tp = world; returns what the parent
    compares with JAX and with tp = 1."""
    del device
    out = {"tokens": {}, "collectives": {}}
    for name, (fmt, config) in MATRIX.items():
        before = collectives.counts.copy()
        got, eng = serve(params_by_fmt[fmt], cfg, encoding(fmt), config, tp=world)
        st = eng.stats
        assert eng.tp_shards == world and st["tp"]["shards"] == world
        assert st["tp"]["mesh_shape"] == [world] and st["tp"]["enc_downgrades"] == []
        assert st["kv_quant"] == config.get("kv_quant", "bf16")
        assert set(st["attn_backend"]) == set(st["degraded"]) == set(range(world))
        # The shards really split: this rank's heads, FFN columns, kv pages.
        assert eng.model_cfg.num_heads == cfg.num_heads // world
        assert eng.model_cfg.num_kv_heads == cfg.num_kv_heads // world
        assert eng.model_cfg.d_ff == cfg.d_ff // world
        assert eng.caches["layers"][0]["k"].shape[-2] == cfg.num_kv_heads // world
        assert eng.params["embed"].shape[0] == 256 // world
        if "tp" in st and "per_shard_pages" in st["tp"]:
            per = st["tp"]["per_shard_pages"]
            assert len(per) == world and all(p == per[0] for p in per)
        out["tokens"][name] = got
        out["collectives"][name] = {
            "counts": dict(collectives.counts - before),
            "dispatches": sum(eng.dispatches.values()),
        }

    got, eng = serve(params_by_fmt["none"], cfg, encoding("none"), PREEMPT, tp=world,
                     max_new=8, audit_every_step=True)
    per = eng.stats["tp"]["per_shard_pages"]
    assert all(p == per[0] for p in per), per
    out["preempt"] = {"tokens": got, "preemptions": eng.preemptions}

    out["chaos"] = chaos(cfg, params_by_fmt["none"], world, "attn|decode|*",
                         EncodingConfig(enabled=True, backend="xla"))
    # A matmul fault: the float matmuls' "auto" ladder falls to its last
    # rung, the plain reference, whose row-parallel products must still be
    # summed over the group.
    out["chaos_matmul"] = chaos(cfg, params_by_fmt["none"], world, "none|decode|*",
                                encoding("none"))
    assert out["chaos_matmul"]["degraded"][0]["to"] == "reference", out["chaos_matmul"]
    out["row_parallel"] = row_parallel_projections(cfg, params_by_fmt, rank, world)

    # A rank whose allocator drifts out of lockstep: every rank's audit
    # names it.
    _, eng = serve(params_by_fmt["none"], cfg, encoding("none"), PAGED, tp=world)
    if rank == world - 1:
        eng.alloc.free_page(eng.alloc.alloc())
    try:
        eng.audit()
        out["diverged"] = None
    except paged_lib.AllocatorInvariantError as exc:
        out["diverged"] = str(exc)

    out["refused"] = {}
    try:
        engine_lib.Engine(params_by_fmt["none"], cfg, encoding("none"), device="cpu",
                          config=EngineConfig(mesh_shape=(2 * world,), **PAGED))
    except ValueError as exc:
        out["refused"]["world"] = str(exc)
    for label, rcfg in refused_cfgs.items():  # refused before any weight is read
        try:
            engine_lib.Engine({}, rcfg, encoding("none"), device="cpu",
                              config=EngineConfig(mesh_shape=(world,), slots=2, max_seq=64))
        except NotImplementedError as exc:
            out["refused"][label] = str(exc)
    return out


def chaos(cfg, params, world: int, key: str, enc: EncodingConfig) -> dict:
    """JAX's shard-1 chaos schedule: a kernel fault on `key` attributed to
    shard 1 demotes only that shard's quarantine entry and serving
    completes."""
    registry.clear_quarantine()
    try:
        sched = faults_lib.FaultSchedule(
            [faults_lib.Fault(2, "kernel_fail", key=key, shard=1)], seed=0)
        got, eng = serve(params, cfg, enc, PAGED, tp=world, fault_hooks=sched,
                         clock=sched.clock)
        snap = registry.quarantine_snapshot()
        assert [k for k in snap if "@shard1" in k], snap
        assert all("@shard" in k or snap[k].get("shard") == 1 for k in snap), snap
        s = eng.stats
        assert s["lifecycle"]["kernel_faults"] == 1
        assert s["degraded"][1] and not s["degraded"][0], s["degraded"]
        assert s["degraded"][1][0]["shard"] == 1
        key = s["degraded"][1][0]["key"]
        assert registry.quarantine_level(key, shard=0) == 0
        assert registry.quarantine_level(key) > 0
        return {"tokens": got, "snapshot": snap, "log": sched.log,
                "degraded": s["degraded"][1]}
    finally:
        registry.clear_quarantine()


def row_parallel_projections(cfg, params_by_fmt: dict, rank: int, world: int) -> dict:
    """Layer 0's wo and w_down on this rank's K slice, summed over the group
    (linear_apply's row_group), against one card's product of the whole
    weight on the same rows, at decode (M = 3) and prefill (M = 40): w8a8
    bit for bit (exact integer sums, one card's epilogue), w4a8 within the
    f32 rounding of each rank's sum, and f32 on the plain reference rung (a
    quarantine's last) and the "auto" route within f32 summation order.
    Returns the largest |row-parallel - one card| by (format, projection)."""
    hd = cfg.head_dim
    group = dist.group.WORLD
    gen = torch.Generator().manual_seed(7)
    cases = {"int8": ("int8", "auto"), "int4": ("int4", "auto"),
             "f32 reference": ("none", "reference"), "f32 auto": ("none", "auto")}
    worst = {}
    for label, (fmt, backend) in cases.items():
        enc = EncodingConfig(enabled=True, backend=backend, attn_backend="auto",
                             weight_quant=fmt)
        shard = sharding.plan(cfg, enc, world, rank)
        assert shard.attn_split and shard.mlp_split, shard.replicated
        layer = params_by_fmt[fmt]["layers"][0]
        projections = {
            "wo": (layer["attn"]["wo"], cfg.num_heads * hd, shard.q_lo * hd,
                   shard.cfg.num_heads * hd),
            "w_down": (layer["mlp"]["w_down"], cfg.d_ff, shard.ff_lo, shard.cfg.d_ff),
        }
        for name, (w, k, lo, width) in projections.items():
            part = sharding.shard_linear(w, cfg.d_model, k, "cols", lo, lo + width,
                                         group=enc.quant_group)
            for phase, m in ((Phase.DECODE, 3), (Phase.PREFILL, 40)):
                x = torch.randn(m, k, generator=gen)
                one = packed.linear_apply(w, x, n=cfg.d_model, phase=phase, enc=enc)
                tp = packed.linear_apply(part, x[:, lo:lo + width], n=cfg.d_model,
                                         phase=phase, enc=enc, row_group=group)
                if fmt == "int8":
                    assert torch.equal(tp, one), (label, name, phase)
                else:
                    torch.testing.assert_close(tp, one, rtol=1e-5, atol=1e-5)
                err = (tp - one).abs().max().item()
                worst[(label, name)] = max(worst.get((label, name), 0.0), err)
    return worst
