"""What surrounds the port's train step, against the JAX package on the CPU:
the synthetic data pipeline (data/pipeline.py) bit for bit, checkpoints
(checkpoint/checkpoint.py), the straggler watchdog and data reassigner
(runtime/watchdog.py), the optimizer state carried across
(convert.opt_state_from_jax) and the training CLI (launch/train.py).  The
cases of JAX's tests/test_data.py and tests/test_checkpoint.py are ported
one by one (the reshard and elastic cases wait for tensor parallelism).

Tolerances: batches, checkpoints (bf16 leaves included) and restarts are
bit for bit; a step continued from JAX's converted state holds JAX's loss
within 1e-5 relative and its params within 1e-6 relative + 1e-3 x lr abs:
that step's gradients differ from JAX's by f32 sums in another order
(test_torch_train_grads.py), and Adam divides them by sqrt(nu), so where a
gradient is small its relative difference reaches the update, at most lr x
that difference."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

hypothesis = pytest.importorskip("hypothesis")
import hypothesis.strategies as st

from repro.configs import registry as jcfg_registry
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.data import pipeline as jdata_lib
from repro.models import transformer as JT
from repro.runtime import watchdog as jwd_lib
from repro.train import optimizer as jopt_lib
from repro.train import trainer as jtrainer_lib
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import registry as cfg_registry
from repro_torch.core import tree
from repro_torch.core.packed import EncodingConfig
from repro_torch.data import pipeline as data_lib
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as T
from repro_torch.runtime import watchdog as wd_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import trainer as trainer_lib
from test_torch_train_grads import one_thread  # noqa: F401  (autouse)

ENC = EncodingConfig(backend="xla")
JENC = JEncodingConfig(enabled=True, backend="xla")


def _cfg(**kw):
    base = dict(vocab_size=512, seq_len=32, global_batch=8, seed=3)
    base.update(kw)
    return data_lib.DataConfig(**base), jdata_lib.DataConfig(**base)


# ---- data ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 17])
@pytest.mark.parametrize("host_id,num_hosts", [(0, 1), (1, 4), (3, 4), (1, 2)])
def test_batches_equal_jax(seed, host_id, num_hosts):
    cfg, jcfg = _cfg(seed=seed, vocab_size=1000 + seed)
    mine = data_lib.SyntheticPacked(cfg, host_id=host_id, num_hosts=num_hosts)
    theirs = jdata_lib.SyntheticPacked(jcfg, host_id=host_id, num_hosts=num_hosts)
    for step in (0, 1, 7, 100):
        a, b = mine.batch(step), theirs.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_to_torch():
    cfg, _ = _cfg()
    b = data_lib.SyntheticPacked(cfg).batch(0)
    t = data_lib.to_torch({**b, "frames": np.ones((2, 3), np.float32)}, "cpu")
    assert t["tokens"].dtype == t["labels"].dtype == torch.int64
    assert t["frames"].dtype == torch.float32
    np.testing.assert_array_equal(t["tokens"].numpy(), b["tokens"])


def test_deterministic_across_instances():
    cfg, _ = _cfg()
    a = data_lib.SyntheticPacked(cfg).batch(5)
    b = data_lib.SyntheticPacked(cfg).batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"], b["labels"])


def test_steps_differ():
    d = data_lib.SyntheticPacked(_cfg()[0])
    assert not np.array_equal(d.batch(0)["tokens"], d.batch(1)["tokens"])


def test_host_sharding_disjoint_and_covering():
    cfg, _ = _cfg()
    full = data_lib.SyntheticPacked(cfg).batch(2)["tokens"]
    parts = [data_lib.SyntheticPacked(cfg, host_id=h, num_hosts=4).batch(2)["tokens"]
             for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts, axis=0), full)
    with pytest.raises(ValueError):
        data_lib.SyntheticPacked(cfg, num_hosts=3)


def test_labels_are_shifted_tokens():
    b = data_lib.SyntheticPacked(_cfg()[0]).batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@hypothesis.given(seed=st.integers(0, 1000), step=st.integers(0, 100))
@hypothesis.settings(max_examples=20, deadline=None)
def test_tokens_in_vocab_property(seed, step):
    b = data_lib.SyntheticPacked(_cfg(seed=seed)[0]).batch(step)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 512
    assert b["tokens"].shape == (8, 32)


def test_prefetcher_preserves_order():
    d = data_lib.SyntheticPacked(_cfg()[0])
    pf = data_lib.Prefetcher(d)
    got = [next(pf)["tokens"] for _ in range(3)]
    for g, i in zip(got, range(3)):
        np.testing.assert_array_equal(g, d.batch(i)["tokens"])


# ---- checkpoints -------------------------------------------------------------


def _tiny_state(dtype="float32", moment_dtype="float32", seed=0):
    cfg = cfg_registry.get_reduced("qwen2-1.5b", dtype=dtype)
    params = T.model_init(cfg, ENC, seed=seed, device="cpu")
    opt_cfg = opt_lib.OptimizerConfig(moment_dtype=moment_dtype)
    return cfg, {"params": params, "opt": opt_lib.init(params, opt_cfg)}


def _assert_bitwise(a, b):
    pa, pb = tree.leaves_with_path(a), tree.leaves_with_path(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and x.shape == y.shape, tree.keystr(path)
        assert torch.equal(x.view(torch.uint8) if x.dim() else x.reshape(1).view(torch.uint8),
                           y.view(torch.uint8) if y.dim() else y.reshape(1).view(torch.uint8)), \
            tree.keystr(path)


@pytest.mark.parametrize("dtype,moment_dtype", [("float32", "float32"),
                                                ("bfloat16", "float32"),
                                                ("bfloat16", "bfloat16")])
def test_save_restore_bitwise(tmp_path, dtype, moment_dtype):
    """bf16 leaves go to disk as their uint16 bits and come back bit for bit
    (the manifest keeps the true dtype); keys are the tree paths."""
    _, state = _tiny_state(dtype, moment_dtype)
    # Non-trivial moments, NaN payloads and negative zeros included.
    state["opt"]["mu"] = tree.tree_map(lambda m: torch.randn(m.shape).to(m.dtype),
                                       state["opt"]["mu"])
    state["opt"]["mu"]["embed"].view(-1)[:3] = torch.tensor([float("nan"), -0.0, 1e-40])
    state["opt"]["step"] = torch.tensor(7, dtype=torch.int32)
    path = ckpt_lib.save(str(tmp_path), state, step=7)
    assert ckpt_lib.latest_step(str(tmp_path)) == 7
    restored = ckpt_lib.restore(str(tmp_path), 7, state, device="cpu")
    _assert_bitwise(state, restored)
    import json

    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    keys = [e["key"] for e in manifest["leaves"]]
    assert keys == [tree.keystr(p) for p, _ in tree.leaves_with_path(state)]
    assert "['params']['layers'][0]['attn']['wq']['w_packed']" in keys
    dtypes = {e["key"]: e["dtype"] for e in manifest["leaves"]}
    assert dtypes["['params']['embed']"] == dtype
    assert dtypes["['opt']['step']"] == "int32"


def test_restore_default_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        return  # the card: the default device exists
    _, state = _tiny_state()
    ckpt_lib.save(str(tmp_path), state, step=1)
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt_lib.restore(str(tmp_path), 1, state)


def test_restart_resumes_identically(tmp_path):
    """Kill and restart: training continued from a checkpoint is bit for bit
    the uninterrupted run (deterministic data keyed by step)."""
    cfg, state = _tiny_state()
    opt_cfg = opt_lib.OptimizerConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=50)
    data = data_lib.SyntheticPacked(data_lib.DataConfig(cfg.vocab_size, seq_len=16,
                                                        global_batch=4))
    step = trainer_lib.make_train_step(cfg, ENC, opt_cfg)
    batch = lambda i: data_lib.to_torch(data.batch(i), "cpu")

    p, o = state["params"], state["opt"]
    for i in range(6):
        p, o, _, _ = step(p, o, batch(i))

    p2, o2 = state["params"], state["opt"]
    for i in range(3):
        p2, o2, _, _ = step(p2, o2, batch(i))
    ckpt_lib.save(str(tmp_path), {"params": p2, "opt": o2}, step=3)
    del p2, o2  # crash
    rs = ckpt_lib.restore(str(tmp_path), 3, state, device="cpu")
    p3, o3 = rs["params"], rs["opt"]
    assert int(o3["step"]) == 3
    for i in range(3, 6):
        p3, o3, _, _ = step(p3, o3, batch(i))
    _assert_bitwise({"params": p, "opt": o}, {"params": p3, "opt": o3})


def test_corruption_detected(tmp_path):
    _, state = _tiny_state()
    path = ckpt_lib.save(str(tmp_path), state, step=1)
    with open(os.path.join(path, "leaf_00003.npy"), "r+b") as f:
        f.seek(128)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(IOError, match="checksum"):
        ckpt_lib.restore(str(tmp_path), 1, state, device="cpu")


def test_atomicity_no_partial_checkpoint(tmp_path):
    """A .tmp dir (a crash mid-save) is never listed as a step."""
    _, state = _tiny_state()
    ckpt_lib.save(str(tmp_path), state, step=1)
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert ckpt_lib.latest_step(str(tmp_path)) == 1
    assert ckpt_lib.latest_step(str(tmp_path / "absent")) is None


def test_async_checkpointer(tmp_path):
    """The async save snapshots the state before it returns: writes to the
    live tensors after save() do not reach the checkpoint."""
    _, state = _tiny_state(dtype="bfloat16")
    want = tree.tree_map(lambda x: x.clone(), state)
    saver = ckpt_lib.AsyncCheckpointer(str(tmp_path))
    saver.save(state, 5)
    for leaf in tree.leaves(state):
        leaf.add_(1)
    saver.wait()
    assert ckpt_lib.latest_step(str(tmp_path)) == 5
    _assert_bitwise(want, ckpt_lib.restore(str(tmp_path), 5, state, device="cpu"))


# ---- watchdog and reassignment (JAX tests/test_checkpoint.py) ---------------


@pytest.mark.parametrize("mod", [wd_lib, jwd_lib], ids=["port", "jax"])
def test_watchdog_flags_straggler(mod):
    t = {"now": 0.0}
    wd = mod.StepWatchdog(clock=lambda: t["now"])
    flagged = []
    for i in range(10):
        wd.step_start()
        t["now"] += 1.0
        flagged.append(wd.step_end(host_times={0: 1.0, 1: 1.0, 2: 5.0 if i >= 6 else 1.0}))
    assert 2 in wd.evicted
    assert wd.should_remesh()
    assert 0 not in wd.evicted and 1 not in wd.evicted
    assert flagged[6:9] == [[2], [2], [2]] and flagged[9] == []
    assert wd.ewma == pytest.approx(1.0)


def test_watchdog_tolerates_transient():
    t = {"now": 0.0}
    wd = wd_lib.StepWatchdog(clock=lambda: t["now"])
    for i in range(10):
        wd.step_start()
        t["now"] += 1.0
        wd.step_end(host_times={0: 1.0, 1: 4.0 if i == 6 else 1.0})
    assert not wd.evicted and not wd.should_remesh()


def test_watchdog_matches_jax_on_a_schedule():
    """The same clock and host times through both watchdogs: the same
    flags, EWMA and evictions at every step."""
    rng = np.random.RandomState(0)
    durs = rng.uniform(0.5, 1.5, 40)
    hosts = [{h: float(rng.choice([1.0, 1.2, 6.0], p=[0.7, 0.2, 0.1])) for h in range(5)}
             for _ in range(40)]
    for ht in hosts[20:]:
        ht[4] = 6.0  # a lasting straggler, evicted after evict_after flags
    clocks = [{"now": 0.0}, {"now": 0.0}]
    wds = [m.StepWatchdog(m.WatchdogConfig(), clock=lambda c=c: c["now"])
           for m, c in zip((wd_lib, jwd_lib), clocks)]
    for d, ht in zip(durs, hosts):
        out = []
        for wd, c in zip(wds, clocks):
            wd.step_start()
            c["now"] += d
            out.append((wd.step_end(host_times=ht), wd.ewma, sorted(wd.evicted),
                        dict(wd.flags)))
        assert out[0] == out[1]
    assert 4 in wds[0].evicted


def test_data_reassignment():
    for mod in (wd_lib, jwd_lib):
        r = mod.DataReassigner(4)
        r.evict(2)
        r.evict(2)  # evicting twice changes nothing
        shards = sum((r.shards_for(h) for h in range(4)), [])
        assert sorted(shards) == [0, 1, 2, 3]
        assert r.shards_for(2) == []
    mine, theirs = wd_lib.DataReassigner(6), jwd_lib.DataReassigner(6)
    for h in (4, 1, 0):
        mine.evict(h)
        theirs.evict(h)
        assert mine.assignment == theirs.assignment


# ---- optimizer state across the bridge ---------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_llama():
    jcfg = jcfg_registry.get_reduced("llama3.2-1b")
    jparams = jax.jit(functools.partial(JT.model_init, cfg=jcfg, enc=JENC))(
        jax.random.PRNGKey(0))
    return jcfg, jparams


def test_opt_state_from_jax():
    """JAX trains one step; its params and AdamW state come across; the
    port's second step equals JAX's second step."""
    jcfg, jparams = _jax_llama()
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    kw = dict(peak_lr=3e-3, warmup_steps=1, decay_steps=10)
    jstep = jax.jit(jtrainer_lib.make_train_step(jcfg, JENC, jopt_lib.OptimizerConfig(**kw)))
    data = data_lib.SyntheticPacked(data_lib.DataConfig(cfg.vocab_size, 32, 4))
    jb = lambda i: {k: jnp.asarray(v) for k, v in data.batch(i).items()}
    p1, s1, _, _ = jstep(jparams, jopt_lib.init(jparams), jb(0))
    p2, s2, jm, _ = jstep(p1, s1, jb(1))

    np_ = lambda t: jax.tree.map(np.asarray, t)
    opt = convert.opt_state_from_jax(np_(s1), cfg, ENC, "cpu")
    params = convert.params_from_jax(np_(p1), cfg, ENC, "cpu")
    like = opt_lib.init(params)
    assert [p for p, _ in tree.leaves_with_path(opt)] == \
        [p for p, _ in tree.leaves_with_path(like)]
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 1
    assert float(opt["nu"]["embed"].abs().max()) > 0
    step = trainer_lib.make_train_step(cfg, ENC, opt_lib.OptimizerConfig(**kw))
    q2, t2, m, _ = step(params, opt, data_lib.to_torch(data.batch(1), "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    want = convert.params_from_jax(np_(p2), cfg, ENC, "cpu")
    for (path, a), b in zip(tree.leaves_with_path(q2), tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-3 * kw["peak_lr"],
                                   err_msg=tree.keystr(path))
    assert int(t2["step"]) == int(s2["step"]) == 2


# ---- the CLI -------------------------------------------------------------------


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    """--reduced --device cpu --steps 3 writes checkpoints; a second run to 5
    steps resumes from step 3 and its losses equal an uninterrupted 5-step
    run's, bit for bit."""
    ck = str(tmp_path / "ck")
    base = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16", "--log-every", "1"]
    first = train_cli.main(base + ["--steps", "3", "--ckpt-dir", ck, "--ckpt-every", "2"])
    assert len(first) == 3 and all(np.isfinite(first))
    assert ckpt_lib.latest_step(ck) == 3 and os.path.isdir(os.path.join(ck, "step_00000002"))
    resumed = train_cli.main(base + ["--steps", "5", "--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out and "[train] step=4 loss=" in out
    whole = train_cli.main(base + ["--steps", "5"])
    assert first == whole[:3] and resumed == whole[3:]
    assert ckpt_lib.latest_step(ck) == 5
