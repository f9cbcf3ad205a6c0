"""The port's training objective and its gradients (models/transformer.loss_fn
under torch.autograd, layers rematerialised) against the JAX package's
jax.value_and_grad(transformer.loss_fn), on the reduced config of every
arch of the JAX registry and of llama3.2-1b, in f32 (the attention-only
archs here, the recurrent, enc-dec and VLM archs in
test_torch_train_grads_rec.py), with JAX's own weights
carried across by convert.params_from_jax and JAX's gradients carried
across the same way.  Batches are drawn from a seed with numpy, as JAX's
tests/test_archs.py draws them (frames for Whisper, patches for InternVL).

Tolerances: the loss and nll within 1e-5 relative, the MoE aux within 1e-5
relative (f32 sums in another order); each gradient leaf within
1e-4 x max|g_jax| of that leaf + 1e-6 abs: the same operations, f32 sums in
another order, through up to a few layers of backward.  The weight-decay
mask (optimizer.is_matrix) is checked leaf by leaf against JAX's
_is_matrix carried across the same way: equal.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jcfg_registry
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.models import transformer as JT
from repro.train import optimizer as jopt_lib
from repro_torch import convert
from repro_torch.configs import registry as cfg_registry
from repro_torch.core import tree
from repro_torch.core.packed import EncodingConfig
from repro_torch.data import pipeline as data_lib
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt_lib

ENC = EncodingConfig(backend="xla")
JENC = JEncodingConfig(enabled=True, backend="xla")
ARCHS = tuple(jcfg_registry.ASSIGNED_ARCHS) + ("llama3.2-1b",)
REC_ARCHS = ("rwkv6-1.6b", "recurrentgemma-9b", "whisper-tiny", "internvl2-26b")


@pytest.fixture(autouse=True)
def one_thread():
    """The port's ops run on one CPU thread in these files: the tensors are
    tiny, and beside other test workers more threads only contend.  The
    process's setting is restored after each test."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def np_batch(cfg, b: int, s: int, seed: int = 0) -> dict:
    """JAX's tests/test_archs.py batch: tokens, labels, and frames or patches."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(1, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = (0.1 * rng.randn(b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = (0.1 * rng.randn(b, cfg.frontend_tokens, cfg.frontend_dim)
                          ).astype(np.float32)
    out["labels"] = rng.randint(1, cfg.vocab_size, (b, s)).astype(np.int32)
    return out


@functools.lru_cache(maxsize=None)
def model(arch: str):
    """(jcfg, jparams, cfg, params): JAX's reduced model and the port's copy."""
    jcfg = jcfg_registry.get_reduced(arch)
    cfg = cfg_registry.get_reduced(arch)
    jparams = jax.jit(functools.partial(JT.model_init, cfg=jcfg, enc=JENC))(
        jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, ENC, "cpu")
    return jcfg, jparams, cfg, params


def check_grads(got, want_np, cfg) -> int:
    """Compare the port's gradient tree with JAX's (numpy leaves) leaf by
    leaf; returns the number of leaves."""
    want = convert.params_from_jax(want_np, cfg, ENC, "cpu")
    got_leaves, want_leaves = tree.leaves_with_path(got), tree.leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        w = w.float().numpy()
        atol = 1e-4 * float(np.abs(w).max()) + 1e-6
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=atol,
                                   err_msg=tree.keystr(path))
    return len(got_leaves)


def check_loss_and_grads(arch: str) -> None:
    jcfg, jparams, cfg, params = model(arch)
    batch = np_batch(cfg, 2, 16)
    vg = jax.jit(jax.value_and_grad(functools.partial(JT.loss_fn, cfg=jcfg, enc=JENC),
                                    has_aux=True))
    (jloss, jm), jgrads = vg(jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    live = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss, m = T.loss_fn(tree.unflatten(params, live), data_lib.to_torch(batch, "cpu"),
                        cfg=cfg, enc=ENC)
    grads = tree.unflatten(params, list(torch.autograd.grad(loss, live)))

    loss, m = loss.detach(), {k: v.detach() for k, v in m.items()}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["nll"]), float(jm["nll"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5, atol=0)
    if cfg.num_experts:
        assert float(m["aux"]) > 0
    assert check_grads(grads, jax.tree.map(np.asarray, jgrads), cfg) == len(live)


def check_decay_mask(arch: str) -> None:
    """optimizer.is_matrix on every port leaf == JAX's _is_matrix on the leaf
    it came from (an MoE expert's leaf split out of JAX's stack included)."""
    _, jparams, cfg, params = model(arch)
    jmask = jax.tree_util.tree_map_with_path(
        lambda p, x: np.full(x.shape, jopt_lib._is_matrix(p)), jparams)
    want = convert.params_from_jax(jmask, cfg, ENC, "cpu")
    pairs = tree.leaves_with_path(want)
    for (path, m) in pairs:
        assert bool(m.all()) == bool(m.any()) == opt_lib.is_matrix(path), tree.keystr(path)
    assert any(opt_lib.is_matrix(p) for p, _ in pairs)
    assert not all(opt_lib.is_matrix(p) for p, _ in pairs)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in REC_ARCHS])
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in REC_ARCHS])
def test_decay_mask_matches_jax(arch):
    check_decay_mask(arch)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("dense_decode", [False, True], ids=["dispatch", "dense_decode"])
@pytest.mark.parametrize("groups", [0, 4])
def test_moe_aux_matches_jax_on_every_path(phase, dense_decode, groups):
    """moe_apply's load-balance loss, handed out through `aux=`, against the
    aux JAX's moe_apply returns on each of its paths (grouped dispatch,
    one queue, dense decode), f32, 1e-6 relative; without `aux` nothing is
    computed and the output is the same tensor."""
    from test_torch_moe import PHASES, _configs, _jax_moe, _weights, _x

    from repro_torch.models import layers as L

    jmoe, moe = _weights("none")
    jcfg, cfg = _configs(moe_dispatch_groups=groups, moe_dense_decode=dense_decode)
    tph, _ = PHASES[phase]
    x = _x((12, 1, 64) if phase == "decode" else (2, 12, 64), seed=5)
    want_out, want_aux = _jax_moe(jcfg, "none", phase)(jmoe, jnp.asarray(x))
    found = []
    got = L.moe_apply(moe, torch.from_numpy(x), cfg=cfg, enc=EncodingConfig(), phase=tph,
                      aux=found)
    assert len(found) == 1
    np.testing.assert_allclose(float(found[0]), float(want_aux), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    plain = L.moe_apply(moe, torch.from_numpy(x), cfg=cfg, enc=EncodingConfig(), phase=tph)
    assert torch.equal(plain, got)
