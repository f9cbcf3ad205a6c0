"""The chaos harness of the port (repro_torch.serving.faults and the engine's
fault hooks), case by case after tests/test_chaos.py, on the reduced
Qwen2-1.5B with weights converted from the JAX package.

Each conformance replay of a committed schedule (tests/fault_schedules/)
holds the port's engine to the contract of the JAX harness -- every request
reaches a terminal status within a step budget, survivors emit the
fault-free run's tokens, no page leaks, every kernel fault is in
stats["degraded"] -- and to the JAX engine under the same schedule: the
same statuses, the same survivors' tokens and the same schedule log (keys
compared without their target name: h100 here, the TPU there).  Both sides
run their plain paths (JAX backend "xla", the port's "xla"), f32.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax

from repro.configs import registry as jcfg_registry
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.kernels import registry as jregistry
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro.serving import faults as jfaults
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import registry as registry_lib
from repro_torch.runtime import watchdog as watchdog_lib
from repro_torch.serving import engine as engine_lib
from repro_torch.serving import faults as faults_lib
from repro_torch.serving import paged as paged_lib

JENC = JEncodingConfig(enabled=True, backend="xla")
ENC = EncodingConfig(enabled=True, backend="xla")
SCHEDULE_DIR = os.path.join(os.path.dirname(__file__), "fault_schedules")
SCHEDULES = sorted(glob.glob(os.path.join(SCHEDULE_DIR, "*.json")))
IDS = [os.path.basename(p) for p in SCHEDULES]

JCFG = jcfg_registry.get_reduced("qwen2-1.5b")
CFG = cfg_registry.get_reduced("qwen2-1.5b")
JPARAMS = JT.model_init(jax.random.PRNGKey(0), JCFG, JENC)
PARAMS = convert.params_from_jax(jax.tree.map(np.asarray, JPARAMS), CFG, ENC, "cpu")


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
    # Quarantine is process-global on both sides; no test may leak a demotion.
    registry_lib.clear_quarantine()
    jregistry.clear_quarantine()
    yield
    registry_lib.clear_quarantine()
    jregistry.clear_quarantine()


def _prompts(seed=0, n=6, repeat=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        base = rng.randint(1, CFG.vocab_size, rng.randint(4, 10)).astype(np.int32)
        out.append(np.tile(base, 3) if repeat else base)
    return out


def _engine(hooks=None, *, prompts, max_new=8, jax_side=False, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_seq", 64)
    clock = hooks.clock if hooks is not None else None
    if jax_side:
        eng = jengine.Engine(JPARAMS, JCFG, JENC, fault_hooks=hooks, clock=clock, **kw)
        req = jengine.Request
    else:
        eng = engine_lib.Engine(PARAMS, CFG, ENC, fault_hooks=hooks, clock=clock,
                                device="cpu", **kw)
        req = engine_lib.Request
    for i, p in enumerate(prompts):
        assert eng.submit(req(uid=i, prompt=p, max_new_tokens=max_new))
    return eng


def _drive(eng, sched=None, budget=300):
    """Step to completion under a step budget (the no-deadlock gate),
    auditing the allocator every step."""
    steps = 0
    while eng.queue or any(r is not None for r in eng.slot_req):
        assert steps < budget, "engine deadlocked under faults"
        eng.step()
        eng.audit()
        steps += 1
    if sched is not None:
        sched.drain(eng)
        eng.audit()
    return steps


def _drive_to_finish(eng):
    _drive(eng)
    return eng.finished


def _log_without_target(log):
    """A schedule log with each registry key's last field (the target) cut."""
    return [dict(e, key=e["key"].rsplit("|", 1)[0]) if "key" in e else e for e in log]


def _conformance(schedule_path, *, spec=False, cache_mode="paged", **kw):
    prompts = _prompts(repeat=spec)
    mk = dict(prompts=prompts, cache_mode=cache_mode, spec_decode=spec, draft_k=3, **kw)
    gold = {r.uid: list(r.generated) for r in _drive_to_finish(_engine(**mk))}
    sched = faults_lib.FaultSchedule.from_json(schedule_path)
    eng = _engine(sched, **mk)
    _drive(eng, sched)
    by_uid = {r.uid: r for r in eng.finished}
    assert set(by_uid) == set(range(len(prompts)))
    assert all(r.status in engine_lib.REQUEST_STATUSES and r.done for r in eng.finished)
    for r in eng.finished:
        if r.status == "ok":
            assert list(r.generated) == gold[r.uid], f"uid {r.uid} diverged under faults"
    if cache_mode == "paged":
        assert eng.alloc.in_use() == 0
        assert eng.alloc.available() == eng.alloc.capacity
    fired = [e for e in sched.log if e["kind"] == "kernel_fail"]
    if fired:
        assert len(eng.stats["degraded"]) == len(fired)
        assert [d["key"] for d in eng.stats["degraded"]] == [e["key"] for e in fired]
        assert all(registry_lib.quarantine_level(d["key"]) > 0 for d in eng.stats["degraded"])

    # The JAX engine under the same schedule: same statuses, survivors'
    # tokens and log.
    jsched = jfaults.FaultSchedule.from_json(schedule_path)
    jeng = _engine(jsched, jax_side=True, **mk)
    _drive(jeng, jsched)
    want = {r.uid: (r.status, list(r.generated) if r.status == "ok" else None)
            for r in jeng.finished}
    got = {r.uid: (r.status, list(r.generated) if r.status == "ok" else None)
           for r in eng.finished}
    assert got == want
    assert _log_without_target(sched.log) == _log_without_target(jsched.log)
    return eng, sched


# ---------------------------------------------------------------------------
# Conformance replays of the committed schedules


@pytest.mark.parametrize("path", SCHEDULES, ids=IDS)
def test_chaos_conformance_paged(path):
    _conformance(path)


def test_chaos_conformance_spec_decode():
    eng, _ = _conformance(os.path.join(SCHEDULE_DIR, "spec_cancel.json"), spec=True)
    assert eng.spec_decode


def test_chaos_conformance_dense():
    # pool_spike is paged-only; everything else holds on the dense cache.
    _conformance(os.path.join(SCHEDULE_DIR, "mixed_paged.json"), cache_mode="dense")


def test_chaos_conformance_dense_spec_decode():
    eng, _ = _conformance(os.path.join(SCHEDULE_DIR, "spec_cancel.json"), spec=True,
                          cache_mode="dense")
    assert eng.spec_decode


@pytest.mark.parametrize("path", SCHEDULES, ids=IDS)
def test_chaos_conformance_token_budget(path):
    eng, _ = _conformance(path, token_budget=24)
    assert eng.scheduler is not None
    assert eng.stats["continuous"]["mixed_steps"] > 0


def test_chaos_conformance_token_budget_spec_decode():
    eng, _ = _conformance(os.path.join(SCHEDULE_DIR, "spec_cancel.json"), spec=True,
                          token_budget=24)
    assert eng.spec_decode and eng.scheduler is not None


def test_chaos_conformance_kv8():
    eng, _ = _conformance(os.path.join(SCHEDULE_DIR, "kv_quant_mix.json"), kv_quant="kv8")
    assert eng.stats["kv_quant"] == "kv8"
    # Scales survive exactly on the pages the prefix tree keeps.
    assert eng.alloc.scale_live == eng.alloc.cached


# ---------------------------------------------------------------------------
# Schedules: JSON, the generator, the fault kinds


def test_schedule_json_roundtrip(tmp_path):
    sched = faults_lib.FaultSchedule.random(7, steps=12, uids=[0, 1, 2])
    p = sched.to_json(str(tmp_path / "s.json"))
    back = faults_lib.FaultSchedule.from_json(p)
    assert back.seed == sched.seed
    assert [f.to_dict() for f in back.faults] == [f.to_dict() for f in sched.faults]
    for path in SCHEDULES:
        with open(path) as f:
            raw = json.load(f)
        parsed = faults_lib.FaultSchedule.from_dicts(raw["faults"])
        assert parsed.faults
        # The port reads each committed file as the JAX package does.
        want = jfaults.FaultSchedule.from_json(path)
        assert [x.to_dict() for x in faults_lib.FaultSchedule.from_json(path).faults] == \
            [x.to_dict() for x in want.faults]


def test_fault_shard_roundtrips(tmp_path):
    sched = faults_lib.FaultSchedule(
        [faults_lib.Fault(2, "kernel_fail", key="attn|decode|*", shard=1),
         faults_lib.Fault(3, "kernel_fail", key="*")], seed=5)
    back = faults_lib.FaultSchedule.from_json(sched.to_json(str(tmp_path / "s.json")))
    assert [(f.shard, f.key) for f in back.faults] == [(1, "attn|decode|*"), (None, "*")]
    assert back.faults[0].to_dict() == {"step": 2, "kind": "kernel_fail",
                                        "key": "attn|decode|*", "shard": 1}
    err = faults_lib.KernelFaultError("attn|decode|s256|h100", shard=1)
    assert err.shard == 1 and str(err).endswith("(shard 1)")
    assert faults_lib.KernelFaultError("k").shard is None


def test_shard_tagged_fault_records_its_shard():
    """One card: a shard-tagged kernel fault demotes that shard's entry,
    which the card's dispatch honours (the level over every shard), and its
    stats["degraded"] entry names the shard; the stream still conforms."""
    prompts = _prompts(n=2)
    sched = faults_lib.FaultSchedule(
        [faults_lib.Fault(2, "kernel_fail", key="attn|decode|*", shard=1)], seed=0)
    eng = _engine(sched, prompts=prompts, slots=2)
    _drive(eng, sched)
    (deg,) = eng.stats["degraded"]
    assert deg["shard"] == 1 and registry_lib.quarantine_level(deg["key"]) == 1
    assert sched.log[-1]["shard"] == 1
    assert all(r.status == "ok" for r in eng.finished)


@pytest.mark.parametrize("seed", range(20))
def test_random_schedule_matches_jax(seed):
    kw = dict(steps=12 + seed, uids=[0, 1, 2, 3, 4])
    got = faults_lib.FaultSchedule.random(seed, **kw)
    want = jfaults.FaultSchedule.random(seed, **kw)
    assert [f.to_dict() for f in got.faults] == [f.to_dict() for f in want.faults]
    assert got.seed == want.seed == seed


def test_fault_kind_validated():
    assert faults_lib.FAULT_KINDS == jfaults.FAULT_KINDS
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults_lib.Fault(1, "meteor_strike")


# ---------------------------------------------------------------------------
# Backpressure and admission-time serviceability


def test_submit_backpressure_queue_full():
    eng = _engine(prompts=[], max_queue=2)
    prompt = np.arange(1, 5, dtype=np.int32)
    ok1 = eng.submit(engine_lib.Request(uid=0, prompt=prompt, max_new_tokens=4))
    ok2 = eng.submit(engine_lib.Request(uid=1, prompt=prompt, max_new_tokens=4))
    assert ok1 and ok2 and isinstance(ok1, engine_lib.Admitted)
    rej = eng.submit(engine_lib.Request(uid=2, prompt=prompt, max_new_tokens=4))
    assert not rej and rej.reason == "queue_full"
    assert eng.stats["lifecycle"]["rejected"] == 1
    assert eng.rejected[0].uid == 2 and eng.rejected[0].status == "rejected"
    assert {r.uid for r in _drive_to_finish(eng)} == {0, 1}


def test_submit_unserviceable_seq_and_pool_boundary():
    eng = _engine(prompts=[], max_seq=32, block_size=4, pool_pages=5)
    too_long = eng.submit(engine_lib.Request(uid=0, prompt=np.arange(1, 40, dtype=np.int32),
                                             max_new_tokens=1))
    assert not too_long and too_long.reason == "unserviceable_seq"
    # prompt 8 + 9 new = position 16 -> 5 pages > capacity 4.
    over = eng.submit(engine_lib.Request(uid=1, prompt=np.arange(1, 9, dtype=np.int32),
                                         max_new_tokens=9))
    assert not over and over.reason == "unserviceable_pool"
    fits = eng.submit(engine_lib.Request(uid=2, prompt=np.arange(1, 9, dtype=np.int32),
                                         max_new_tokens=8))
    assert fits
    done = _drive_to_finish(eng)
    assert [r.uid for r in done] == [2] and done[0].status == "ok"
    assert eng.alloc.in_use() == 0


# ---------------------------------------------------------------------------
# Deadlines and cancellation (injected clock)


def test_deadline_expiry_mid_flight():
    t = [0.0]
    eng = engine_lib.Engine(PARAMS, CFG, ENC, slots=2, max_seq=64, clock=lambda: t[0],
                            device="cpu")
    r0 = engine_lib.Request(uid=0, prompt=np.arange(1, 6, dtype=np.int32),
                            max_new_tokens=50, deadline_ms=1000.0)
    r1 = engine_lib.Request(uid=1, prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=6)
    assert eng.submit(r0) and eng.submit(r1)
    eng.step()
    assert r0.status == "running"
    t[0] = 2.0
    eng.step()
    assert r0.done and r0.status == "expired" and "deadline" in r0.error
    assert len(r0.generated) >= 1
    _drive(eng)
    assert r1.status == "ok" and len(r1.generated) == 6
    assert eng.alloc.in_use() == 0


def test_deadline_expiry_while_queued():
    t = [0.0]
    eng = engine_lib.Engine(PARAMS, CFG, ENC, slots=1, max_seq=64, clock=lambda: t[0],
                            device="cpu")
    reqs = [engine_lib.Request(uid=i, prompt=np.arange(1, 6, dtype=np.int32),
                               max_new_tokens=4, deadline_ms=500.0) for i in range(3)]
    for r in reqs:
        assert eng.submit(r)
    eng.step()
    t[0] = 1.0
    eng.step()
    statuses = {r.uid: r.status for r in reqs}
    assert statuses[1] == "expired" and statuses[2] == "expired"
    assert reqs[1].generated == [] and reqs[2].generated == []
    _drive(eng)
    assert reqs[0].status == "expired"


def test_cancel_while_queued_and_running():
    eng = _engine(prompts=_prompts(n=3), slots=1)
    queued = list(eng.queue)
    eng.step()
    running = next(r for r in queued if r.status == "running")
    waiting = next(r for r in queued if r.status == "queued")
    running.cancel()
    waiting.cancel()
    eng.step()
    assert running.status == "cancelled" and running.done
    assert waiting.status == "cancelled" and waiting.generated == []
    _drive(eng)
    assert eng.alloc.in_use() == 0
    assert eng.stats["lifecycle"]["cancelled"] == 2


# ---------------------------------------------------------------------------
# Cancel mid speculative decode


def test_cancel_mid_spec_decode_frees_draft_pages():
    prompts = _prompts(seed=5, n=2, repeat=True)
    mk = dict(prompts=prompts, slots=2, spec_decode=True, draft_k=3, max_new=10)
    gold = {r.uid: list(r.generated) for r in _drive_to_finish(_engine(**mk))}
    sched = faults_lib.FaultSchedule([faults_lib.Fault(3, "cancel", uid=0, where="mid")])
    eng = _engine(sched, **mk)
    assert eng.spec_decode
    _drive(eng, sched)
    by_uid = {r.uid: r for r in eng.finished}
    assert by_uid[0].status == "cancelled"
    mid = [e for e in sched.log if e["kind"] == "cancel"]
    assert mid and mid[0]["where"] == "mid"
    assert len(by_uid[0].generated) < len(gold[0])
    assert by_uid[1].status == "ok" and list(by_uid[1].generated) == gold[1]
    assert eng.alloc.in_use() == 0
    # The JAX engine cancels at the same dispatch and keeps the same tokens.
    jsched = jfaults.FaultSchedule([jfaults.Fault(3, "cancel", uid=0, where="mid")])
    jeng = _engine(jsched, jax_side=True, **mk)
    _drive(jeng, jsched)
    assert {r.uid: list(r.generated) for r in jeng.finished} == \
        {r.uid: list(r.generated) for r in eng.finished}
    assert sched.log == jsched.log


def test_spec_survivor_page_truncation_under_cancel():
    prompts = _prompts(seed=9, n=2, repeat=True)
    sched = faults_lib.FaultSchedule([faults_lib.Fault(2, "cancel", uid=1, where="mid")])
    eng = _engine(sched, prompts=prompts, slots=2, spec_decode=True, draft_k=4, max_new=12,
                  block_size=4, pool_pages=32)
    while any(r is not None for r in eng.slot_req) or eng.queue:
        eng.step()
        eng.audit()
        for s in range(eng.slots):
            if eng.slot_req[s] is not None:
                need = (int(eng.slot_pos[s]) - 1) // eng.block_size + 1
                assert len(eng.slot_pages[s]) <= need, "draft-only pages survived the rollback"
    sched.drain(eng)
    assert eng.alloc.in_use() == 0


# ---------------------------------------------------------------------------
# The non-finite logits guard and poisoned caches


def test_guard_quarantines_only_offending_slot():
    prompts = _prompts(seed=2, n=2)
    gold = {r.uid: list(r.generated)
            for r in _drive_to_finish(_engine(prompts=prompts, slots=2))}
    sched = faults_lib.FaultSchedule([faults_lib.Fault(2, "nonfinite_logits", uid=0)])
    eng = _engine(sched, prompts=prompts, slots=2)
    _drive(eng, sched)
    by_uid = {r.uid: r for r in eng.finished}
    assert by_uid[0].status == "error" and "non-finite" in by_uid[0].error
    assert by_uid[1].status == "ok" and list(by_uid[1].generated) == gold[1]
    assert eng.stats["lifecycle"]["guard_trips"] == 1


def test_guard_flag_off_skips_check():
    sched = faults_lib.FaultSchedule([faults_lib.Fault(2, "nonfinite_logits", uid=0)])
    eng = _engine(sched, prompts=_prompts(n=1), slots=1, logits_guard=False)
    _drive(eng, sched)
    assert eng.stats["lifecycle"]["guard_trips"] == 0
    assert eng.finished[0].status == "ok"


@pytest.mark.parametrize("cache_mode", ["paged", "dense"])
def test_poisoned_kv_trips_guard_next_step(cache_mode):
    """A poisoned newest page trips the guard on the slot's next step.  On
    the dense cache the newest row is the one the next decode step writes
    again, so the poison is overwritten and the request ends "ok", in the
    JAX engine as in the port: both are held to the JAX engine."""
    mk = dict(prompts=_prompts(n=1), slots=1, max_new=10, cache_mode=cache_mode)
    sched = faults_lib.FaultSchedule([faults_lib.Fault(3, "nonfinite_kv", uid=0)])
    eng = _engine(sched, **mk)
    _drive(eng, sched)
    jsched = jfaults.FaultSchedule([jfaults.Fault(3, "nonfinite_kv", uid=0)])
    jeng = _engine(jsched, jax_side=True, **mk)
    _drive(jeng, jsched)
    assert [e["kind"] for e in sched.log] == ["nonfinite_kv"] and sched.log == jsched.log
    assert eng.finished[0].status == jeng.finished[0].status
    assert eng.stats["lifecycle"] == jeng.stats["lifecycle"]
    if cache_mode == "paged":
        assert eng.finished[0].status == "error"
        assert eng.stats["lifecycle"]["guard_trips"] >= 1
        assert eng.alloc.in_use() == 0
    else:
        assert list(eng.finished[0].generated) == list(jeng.finished[0].generated)


@pytest.mark.parametrize("kv_quant", ["bf16", "kv8", "kv4"])
def test_poison_slot_kv_writes_the_sentinels(kv_quant):
    """poison_slot_kv on a paged pool: the slot's last page of every layer's
    K and V pools holds NaN (bf16 pools) or the dtype's largest value (kv8
    int8, kv4 nibble bytes) with NaN scale pages; no other page and no
    table changes."""
    eng = _engine(prompts=_prompts(n=2), slots=2, kv_quant=kv_quant)
    eng.step()
    eng.step()
    before = [{k: v.clone() for k, v in layer.items()} for layer in eng.caches["layers"]]
    page = eng.slot_pages[0][-1]
    eng.poison_slot_kv(0)
    for layer, old in zip(eng.caches["layers"], before):
        assert layer["table"] is old["table"] or bool((layer["table"] == old["table"]).all())
        for name, leaf in layer.items():
            if name == "table":
                continue
            others = [p for p in range(leaf.shape[0]) if p != page]
            assert bool((leaf[others] == old[name][others]).all()) or name.endswith("scale")
            if leaf.dtype.is_floating_point:
                assert bool(leaf[page].isnan().all())
            else:
                assert bool((leaf[page] == np.iinfo(str(leaf.dtype).split(".")[1]).max).all())


def test_poisoned_kv_quantized_pages_isolated_to_slot():
    prompts = _prompts(n=3)
    gold = {r.uid: list(r.generated)
            for r in _drive_to_finish(_engine(prompts=prompts, kv_quant="kv8"))}
    sched = faults_lib.FaultSchedule([faults_lib.Fault(3, "nonfinite_kv", uid=0)])
    eng = _engine(sched, prompts=prompts, kv_quant="kv8")
    _drive(eng, sched)
    assert eng.stats["kv_quant"] == "kv8"
    by_uid = {r.uid: r for r in eng.finished}
    assert by_uid[0].status == "error"
    assert eng.stats["lifecycle"]["guard_trips"] >= 1
    for uid in (1, 2):
        assert by_uid[uid].status == "ok", by_uid[uid].error
        assert list(by_uid[uid].generated) == gold[uid]
    assert eng.alloc.in_use() == 0
    assert eng.alloc.scale_live == eng.alloc.cached


# ---------------------------------------------------------------------------
# Typed allocator invariants (the port's copy of serving/paged.py)


def test_allocator_double_free_is_typed():
    alloc = paged_lib.BlockAllocator(8, 4)
    p = alloc.alloc(owner=2)
    alloc.free_page(p)
    with pytest.raises(paged_lib.AllocatorInvariantError) as ei:
        alloc.free_page(p, owner=2)
    assert ei.value.page == p and ei.value.owner == 2
    assert f"page {p}" in str(ei.value) and "slot 2" in str(ei.value)
    assert isinstance(ei.value, AssertionError)


def test_allocator_share_unreferenced_is_typed():
    alloc = paged_lib.BlockAllocator(8, 4)
    p = alloc.alloc()
    alloc.free_page(p)
    with pytest.raises(paged_lib.AllocatorInvariantError):
        alloc.share(p)


def test_audit_catches_stale_prefix_tree_entry():
    alloc = paged_lib.BlockAllocator(8, 4)
    prompt = np.arange(1, 10, dtype=np.int32)
    nblocks, shared = alloc.plan_prompt(prompt)
    plan = alloc.commit_prompt(prompt, nblocks, shared)
    alloc.mark_written(plan.pages)
    alloc.free_pages(plan.pages)
    stale = plan.pages[0]
    assert stale in alloc.cached
    alloc.cached.discard(stale)
    alloc.free.append(stale)
    with pytest.raises(paged_lib.AllocatorInvariantError,
                       match="prefix tree references a freed page"):
        alloc.audit([])


def test_audit_leak_names_owner():
    alloc = paged_lib.BlockAllocator(8, 4)
    p = alloc.alloc(owner=1)
    with pytest.raises(paged_lib.AllocatorInvariantError) as ei:
        alloc.audit([])
    assert ei.value.page == p and ei.value.owner == 1


def test_audit_counts_held_pages():
    """Pages a pool_spike holds are in use but in no table: the engine's
    audit folds the schedule's held_pages in, and drain returns them."""
    sched = faults_lib.FaultSchedule([faults_lib.Fault(1, "pool_spike", pages=3, hold=5)])
    eng = _engine(sched, prompts=_prompts(n=2), slots=2)
    eng.step()
    eng.step()
    assert len(sched.held_pages()) == 3
    eng.audit()
    sched.drain(eng)
    assert sched.held_pages() == []
    eng.audit()


# ---------------------------------------------------------------------------
# Decode-step watchdog


def test_watchdog_stall_detection_and_percentiles():
    t = [0.0]
    wd = watchdog_lib.DecodeStepWatchdog(clock=lambda: t[0])
    for _ in range(8):
        wd.step_start()
        t[0] += 0.010
        assert wd.step_end() is False
    wd.step_start()
    t[0] += 0.200
    assert wd.step_end() is True
    s = wd.summary()
    assert s["stalls"] == 1 and s["stalled"]
    assert s["p50_ms"] == pytest.approx(10.0, rel=0.2)
    assert s["p99_ms"] > s["p50_ms"]
    assert s["ewma_ms"] < 50.0
    wd.step_start()
    t[0] += 0.010
    assert wd.step_end() is False


def test_watchdog_wired_into_engine_stats():
    eng = _engine(prompts=_prompts(n=2), slots=2)
    _drive(eng)
    wd = eng.stats["watchdog"]
    assert wd["steps"] == eng.stats["steps"] > 0
    assert wd["p50_ms"] >= 0.0 and wd["ewma_ms"] > 0.0


def test_watchdog_sees_injected_clock_skew():
    sched = faults_lib.FaultSchedule([faults_lib.Fault(8, "clock_skew", skew_s=30.0)])
    eng = _engine(sched, prompts=_prompts(n=2), slots=2, max_new=12)
    _drive(eng, sched)
    assert eng.stats["watchdog"]["stalls"] >= 1


# ---------------------------------------------------------------------------
# Kernel quarantine (the registry's demotion ladder)


def test_registry_demotes_down_ladder():
    key = registry_lib.dispatch_key("none", Phase.DECODE, 4, "h100")
    first = registry_lib.resolve_key(key, requested="xla")
    rec = registry_lib.demote(key, failing=first.backend, requested="xla")
    assert rec["from"] == first.backend
    demoted = registry_lib.resolve_key(key, requested="xla")
    assert demoted.backend == rec["to"]
    assert registry_lib.quarantine_level(key) >= 1
    if rec["to"] != rec["from"]:
        assert demoted.source.startswith("quarantined:")


def test_engine_quarantine_survives_for_process_and_records():
    sched = faults_lib.FaultSchedule(
        [faults_lib.Fault(2, "kernel_fail", key="attn|decode|*")])
    eng = _engine(sched, prompts=_prompts(n=2), slots=2)
    _drive(eng, sched)
    (d,) = eng.stats["degraded"]
    assert d["key"].startswith("attn|decode|") and d["reason"]
    assert registry_lib.quarantine_level(d["key"]) == d["level"] == 1
    assert eng.stats["lifecycle"]["kernel_faults"] == 1
    eng2 = _engine(prompts=_prompts(n=1), slots=1)
    _drive(eng2)
    assert eng2.finished[0].status == "ok"
    assert registry_lib.quarantine_level(d["key"]) == 1


def test_dispatch_exhausting_ladder_raises():
    # Six faults armed at one step: each retry after a demotion fires another,
    # past the bottom of the ladder; the engine surfaces the failure.
    sched = faults_lib.FaultSchedule(
        [faults_lib.Fault(1, "kernel_fail", key="*") for _ in range(6)])
    eng = _engine(sched, prompts=_prompts(n=1), slots=1)
    with pytest.raises(faults_lib.KernelFaultError):
        for _ in range(10):
            eng.step()


def test_real_errors_are_not_caught():
    """Only KernelFaultError is a kernel fault: any other error a hook or a
    dispatch raises propagates, and nothing is quarantined."""

    class Boom:
        clock = staticmethod(lambda: 0.0)

        def on_step_begin(self, engine):
            pass

        def pre_dispatch(self, engine, kind, keys):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        def corrupt_slots(self, engine, active):
            return []

    eng = _engine(Boom(), prompts=_prompts(n=1), slots=1)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.step()
    assert eng.stats["degraded"] == []
