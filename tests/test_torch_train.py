"""The port's optimizer and train step (train/optimizer.py,
train/trainer.py, parallel/compression.py) against the JAX package, and
the cases of JAX's tests/test_training.py ported one by one, on reduced
configs in f32 with JAX's weights carried across (convert.params_from_jax)
and batches from data/pipeline.SyntheticPacked.

Tolerances, stated per test:
  * schedule: 1e-6 relative (f32 cos on two libraries);
  * apply_updates with f32 moments: params and moments within 1e-6
    relative (+1e-9 abs for the moments, 1e-7 abs for the params): the
    elementwise AdamW arithmetic is JAX's, and only the global norm's f32
    sum runs in another leaf order, which moves the clip scale by ulps;
  * apply_updates with bf16 moments (no clipping, scale exactly 1): the
    moments within one bf16 ulp (2^-7 relative), since an f32 ulp before
    the cast may round the other way, and the params within
    lr x 2^-6 + 1e-7 after the second step, which reads those moments;
  * five train steps of Llama: each loss within 1e-4 relative of JAX's
    jitted step (f32 gradients in another order, compounded over steps);
  * the int8 round trip: equal to JAX's (op by op) bit for bit;
  * the ported JAX cases keep JAX's own bounds.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jcfg_registry
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.models import transformer as JT
from repro.parallel import compression as jcompression
from repro.train import optimizer as jopt_lib
from repro.train import trainer as jtrainer_lib
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core import tree
from repro_torch.core.packed import EncodingConfig
from repro_torch.data import pipeline as data_lib
from repro_torch.models import transformer as T
from repro_torch.parallel import compression
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import trainer as trainer_lib
from test_torch_train_grads import one_thread  # noqa: F401  (autouse)

ENC = EncodingConfig(backend="xla")
JENC = JEncodingConfig(enabled=True, backend="xla")


@functools.lru_cache(maxsize=None)
def _jax_model(arch: str, seed: int = 0):
    jcfg = jcfg_registry.get_reduced(arch)
    jparams = jax.jit(functools.partial(JT.model_init, cfg=jcfg, enc=JENC))(
        jax.random.PRNGKey(seed))
    return jcfg, jparams


def _port(np_tree, cfg):
    return convert.params_from_jax(np_tree, cfg, ENC, "cpu")


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _setup(arch="qwen2-1.5b", lr=3e-3):
    """JAX's tests/test_training.py _setup on the port."""
    cfg = cfg_registry.get_reduced(arch)
    params = T.model_init(cfg, ENC, seed=0, device="cpu")
    opt_cfg = opt_lib.OptimizerConfig(peak_lr=lr, warmup_steps=2, decay_steps=100)
    data = data_lib.SyntheticPacked(data_lib.DataConfig(cfg.vocab_size, seq_len=32,
                                                        global_batch=8))
    return cfg, params, opt_lib.init(params), opt_cfg, data


def _batch(data, i):
    return data_lib.to_torch(data.batch(i), "cpu")


def _max_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree.leaves(a), tree.leaves(b)))


# ---- optimizer against JAX ------------------------------------------------


def test_schedule_matches_jax():
    for kw in (dict(peak_lr=1.0, min_lr=0.1, warmup_steps=10, decay_steps=100),
               dict(peak_lr=1e-3, warmup_steps=5, decay_steps=20),
               dict()):
        steps = np.arange(0, 130, dtype=np.int32)
        want = np.asarray(jax.vmap(lambda s: jopt_lib.schedule(jopt_lib.OptimizerConfig(**kw),
                                                               s))(jnp.asarray(steps)))
        got = opt_lib.schedule(opt_lib.OptimizerConfig(**kw), torch.from_numpy(steps))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # JAX's test_lr_schedule.
    cfg = opt_lib.OptimizerConfig(peak_lr=1.0, min_lr=0.1, warmup_steps=10, decay_steps=100)
    lr = lambda s: float(opt_lib.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
    assert lr(0) < 0.2
    assert abs(lr(10) - 1.0) < 0.01
    assert lr(100) <= 0.11


def _random_grads(jparams, seed: int, scale: float):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: (scale * rng.randn(*x.shape)).astype(np.float32), jparams)


@pytest.mark.parametrize("arch,moment_dtype", [("llama3.2-1b", "float32"),
                                               ("mixtral-8x22b", "float32"),
                                               ("llama3.2-1b", "bfloat16")])
def test_apply_updates_matches_jax(arch, moment_dtype):
    """Two AdamW steps on converted trees: weight decay on the matrix leaves
    only (an MoE's experts split out of JAX's stack), clipping active with
    f32 moments (random gradients of global norm >> clip_norm), bf16
    moments without clipping."""
    jcfg, jparams = _jax_model(arch)
    cfg = cfg_registry.get_reduced(arch)
    bf16 = moment_dtype == "bfloat16"
    kw = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=10, moment_dtype=moment_dtype,
              clip_norm=1e9 if bf16 else 1.0)
    jcfg_opt, cfg_opt = jopt_lib.OptimizerConfig(**kw), opt_lib.OptimizerConfig(**kw)
    g0, g1 = _random_grads(jparams, 1, 0.1), _random_grads(jparams, 2, 0.1)
    apply = jax.jit(functools.partial(jopt_lib.apply_updates, cfg=jcfg_opt))
    jstate = jopt_lib.init(jparams, jcfg_opt)
    p1, s1, jm1 = apply(jparams, g0, jstate)
    p2, s2, jm2 = apply(p1, g1, s1)

    params = _port(_np(jparams), cfg)
    state = opt_lib.init(params, cfg_opt)
    q1, t1, m1 = opt_lib.apply_updates(params, _port(g0, cfg), state, cfg_opt)
    q2, t2, m2 = opt_lib.apply_updates(q1, _port(g1, cfg), t1, cfg_opt)

    for m, jm in ((m1, jm1), (m2, jm2)):
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    if not bf16:
        assert float(m1["grad_norm"]) > 10 * kw["clip_norm"]  # clipping is active
    assert int(t2["step"]) == int(s2["step"]) == 2 and t2["step"].dtype == torch.int32
    lr = kw["peak_lr"]
    mom_tol = dict(rtol=2**-7, atol=1e-30) if bf16 else dict(rtol=1e-6, atol=1e-9)
    p_tol = dict(rtol=0, atol=lr * 2**-6 + 1e-7) if bf16 else dict(rtol=1e-6, atol=1e-7)
    for name, got, want, tol in (("params", q2, p2, p_tol), ("mu", t2["mu"], s2["mu"], mom_tol),
                                 ("nu", t2["nu"], s2["nu"], mom_tol)):
        want = _port(_np(want), cfg)
        for (path, a), b in zip(tree.leaves_with_path(got), tree.leaves(want)):
            assert a.dtype == b.dtype, (name, tree.keystr(path))
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), **tol,
                                       err_msg=f"{name} {tree.keystr(path)}")


def test_compression_matches_jax():
    """The error-feedback int8 round trip, two steps (the second with the
    carried error), against JAX's compress_decompress run op by op on the
    port's tree (numpy leaves): values and error bit for bit.  (Under jit,
    XLA's fusion moves some values by an ulp.)  One scale a
    leaf on both sides; a port leaf is one layer's (one expert's) weight,
    where JAX's stacked leaf holds every layer of a pattern position, so on
    JAX's own tree its scales are coarser."""
    cfg = cfg_registry.get_reduced("mixtral-8x22b")
    params = T.model_init(cfg, ENC, seed=0, device="cpu")
    state = compression.init_state(params)
    jstate = jcompression.init_state(tree.tree_map(lambda p: p.numpy(), params))
    rng = np.random.RandomState(3)
    for _ in range(2):
        g = tree.tree_map(lambda p: torch.from_numpy(
            (0.05 * rng.randn(*p.shape)).astype(np.float32)), params)
        jg, jstate = jcompression.compress_decompress(
            tree.tree_map(lambda t: t.numpy(), g), jstate)
        got, state = compression.compress_decompress(g, state)
        for mine, theirs in ((got, jg), (state, jstate)):
            want = {tree.keystr(p): np.array(b) for p, b in tree.leaves_with_path(theirs)}
            pairs = tree.leaves_with_path(mine)
            assert len(pairs) == len(want)
            for path, a in pairs:
                assert torch.equal(a, torch.from_numpy(want[tree.keystr(path)]))


def test_train_steps_follow_jax():
    """Five make_train_step steps of the reduced Llama from JAX's weights on
    the same batches: every loss, nll and grad norm within 1e-4 relative of
    JAX's jitted step."""
    jcfg, jparams = _jax_model("llama3.2-1b")
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    kw = dict(peak_lr=3e-3, warmup_steps=2, decay_steps=100)
    jstep = jax.jit(jtrainer_lib.make_train_step(jcfg, JENC, jopt_lib.OptimizerConfig(**kw)))
    step = trainer_lib.make_train_step(cfg, ENC, opt_lib.OptimizerConfig(**kw))
    data = data_lib.SyntheticPacked(data_lib.DataConfig(cfg.vocab_size, seq_len=32,
                                                        global_batch=8))
    jp, js = jparams, jopt_lib.init(jparams)
    p = _port(_np(jparams), cfg)
    s = opt_lib.init(p)
    for i in range(5):
        b = data.batch(i)
        jp, js, jm, _ = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        p, s, m, _ = step(p, s, data_lib.to_torch(b, "cpu"))
        for key in ("loss", "nll", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4,
                                       err_msg=f"step {i} {key}")
    assert np.isfinite(float(m["loss"]))


# ---- JAX's tests/test_training.py, case by case -----------------------------


def test_loss_decreases():
    cfg, params, opt_state, opt_cfg, data = _setup()
    step = trainer_lib.make_train_step(cfg, ENC, opt_cfg)
    losses = []
    for i in range(30):
        params, opt_state, m, _ = step(params, opt_state, _batch(data, i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_microbatch_equivalence():
    """Gradient accumulation over 4 microbatches == one batch of 8."""
    cfg, params, opt_state, opt_cfg, data = _setup()
    batch = _batch(data, 0)
    s1 = trainer_lib.make_train_step(cfg, ENC, opt_cfg, microbatches=1)
    s4 = trainer_lib.make_train_step(cfg, ENC, opt_cfg, microbatches=4)
    p1, _, m1, _ = s1(params, opt_state, batch)
    p4, _, m4, _ = s4(params, opt_state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m1["nll"]), float(m4["nll"]), rtol=1e-5)
    assert _max_diff(p1, p4) < 5e-5


def test_grad_compression_converges():
    """int8 + error feedback trains to about the loss of the exact run."""
    cfg, params, opt_state, opt_cfg, data = _setup()
    comp_state = compression.init_state(params)
    step_c = trainer_lib.make_train_step(cfg, ENC, opt_cfg, compress_grads=True)
    step_p = trainer_lib.make_train_step(cfg, ENC, opt_cfg)
    params_c, opt_c, params_p, opt_p = params, opt_state, params, opt_state
    lc, lp = [], []
    for i in range(25):
        batch = _batch(data, i)
        params_c, opt_c, mc, comp_state = step_c(params_c, opt_c, batch, comp_state)
        params_p, opt_p, mp, _ = step_p(params_p, opt_p, batch)
        lc.append(float(mc["loss"]))
        lp.append(float(mp["loss"]))
    assert np.mean(lc[-5:]) < np.mean(lc[:5]) - 0.1
    assert abs(np.mean(lc[-5:]) - np.mean(lp[-5:])) < 0.35, (lc[-5:], lp[-5:])


def test_quantize_roundtrip_error_bound():
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(128, 64) * 5).astype(np.float32))
    q, s = compression._quantize(x)
    assert q.dtype == torch.int8
    err = (compression._dequantize(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6


def test_gradient_clipping():
    cfg, params, opt_state, opt_cfg, data = _setup(lr=1.0)
    opt_cfg = dataclasses.replace(opt_cfg, clip_norm=1e-9)
    new_params, _, m, _ = trainer_lib.make_train_step(cfg, ENC, opt_cfg)(
        params, opt_state, _batch(data, 0))
    # With a tiny clip norm the Adam direction is bounded: params move little.
    assert _max_diff(params, new_params) < 2.0


def test_packed_padding_stays_zero_under_training():
    """The packed head's K padding (d_model 64 in a 128-wide K0 tile) stays
    exactly zero, and so does every packed leaf's padding: the rows and
    columns of its unpacked matrix that are all zero at init (a random
    init can make a single zero, never a whole row)."""
    cfg = cfg_registry.get_reduced("yi-9b")  # untied: a packed head
    params = T.model_init(cfg, ENC, seed=0, device="cpu")
    opt_state = opt_lib.init(params)
    opt_cfg = opt_lib.OptimizerConfig(peak_lr=1e-2, warmup_steps=1, decay_steps=10)
    data = data_lib.SyntheticPacked(data_lib.DataConfig(cfg.vocab_size, seq_len=16,
                                                        global_batch=4))
    step = trainer_lib.make_train_step(cfg, ENC, opt_cfg)
    before = params
    for i in range(3):
        params, opt_state, _, _ = step(params, opt_state, _batch(data, i))
    head = params["head"]["w_packed"]
    assert torch.all(head[..., :, 64:] == 0), "K padding leaked nonzero values"
    padded = 0
    for (path, new), old in zip(tree.leaves_with_path(params), tree.leaves(before)):
        if path[-1] == "w_packed":
            n1, k1, n0, k0 = old.shape
            unpacked = lambda w: w.permute(0, 2, 1, 3).reshape(n1 * n0, k1 * k0)
            zero = unpacked(old) == 0
            pad = zero.all(dim=1, keepdim=True) | zero.all(dim=0, keepdim=True)
            assert torch.all(unpacked(new)[pad] == 0), tree.keystr(path)
            padded += int(pad.sum())
    assert padded > 0


# ---- the port's own rules ----------------------------------------------------


@pytest.mark.parametrize("kw", [dict(backend="pallas"), dict(backend="fused"),
                                dict(backend="auto"), dict(weight_quant="int8"),
                                dict(weight_quant="int4")],
                         ids=["pallas", "fused", "auto", "w8a8", "w4a8"])
def test_refuses_kernel_projections(kw):
    """A projection on a hand-written kernel has no backward: refused at
    construction, never trained with detached outputs."""
    cfg = cfg_registry.get_reduced("llama3.2-1b")
    with pytest.raises(ValueError, match="training needs"):
        trainer_lib.make_train_step(cfg, EncodingConfig(**kw), opt_lib.OptimizerConfig())


@pytest.mark.parametrize("arch", tuple(jcfg_registry.ASSIGNED_ARCHS) + ("llama3.2-1b",))
def test_arch_train_step_smoke(arch):
    """JAX's tests/test_archs.py train-step smoke on the port: one step,
    finite loss, step 1, every matrix leaf moved; eval_step's loss equals
    the step's."""
    from test_torch_train_grads import np_batch

    cfg = cfg_registry.get_reduced(arch)
    params = T.model_init(cfg, ENC, seed=0, device="cpu")
    batch = data_lib.to_torch(np_batch(cfg, 2, 16), "cpu")
    step = trainer_lib.make_train_step(cfg, ENC, opt_lib.OptimizerConfig(peak_lr=1e-3))
    new_params, new_opt, m, _ = step(params, opt_lib.init(params), batch)
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert int(new_opt["step"]) == 1
    for (path, a), b in zip(tree.leaves_with_path(params), tree.leaves(new_params)):
        if opt_lib.is_matrix(path):
            assert not torch.equal(a, b), tree.keystr(path)
    ev = trainer_lib.make_eval_step(cfg, ENC)(params, batch)
    assert torch.equal(ev["loss"], m["loss"])
