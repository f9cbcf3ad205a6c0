"""Tensor-parallel serving's pieces in the port against the JAX package,
in one process: the sharding classification against JAX's param_spec and
serving_cache_shardings, the ranks' shards reassembled into the full
params in every weight format, build_serving_mesh's errors, the
shard-aware quarantine and ShardedBlockAllocator (JAX's tests/test_tp_mesh.py
units on both packages).  The multi-rank engine runs are
tests/test_torch_tp_engine.py."""

import datetime
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as jcfg_registry
from repro.core.encoding import Phase as JPhase
from repro.core.packed import EncodingConfig as JEncodingConfig
from repro.kernels import registry as jregistry
from repro.models import transformer as JT
from repro.parallel import sharding as jsharding
from repro.serving import paged as jpaged
from repro_torch.configs import registry as cfg_registry
from repro_torch.core import packed
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import registry
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding
from repro_torch.serving import paged

ARCHS = sorted(jcfg_registry._ARCH_MODULES)
# Weight formats: (name, JAX encoding kwargs); "plain" stores w_t.
FORMATS = {"plain": dict(enabled=False), "packed": dict(enabled=True),
           "int8": dict(enabled=True, weight_quant="int8"),
           "int4": dict(enabled=True, weight_quant="int4")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: the plain versions run many small
    ops, which more threads only slow down where the suite's workers already
    share every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(tp: int):
    """A stand-in for a JAX mesh: param_spec and sanitize read only these."""
    return types.SimpleNamespace(shape={"model": tp}, axis_names=("model",))


def _jax_role(spec, leafname: str, ndim: int) -> str:
    """The role JAX's spec gives the "model" axis (the port's vocabulary)."""
    parts = list(spec) + [None] * (ndim - len(spec))
    if "model" not in parts:
        return "replicated"
    axis = parts.index("model")
    if leafname == "embed":
        return "vocab"
    if leafname in ("w_packed", "w_q"):
        return "column" if axis == ndim - 4 else "row"
    if leafname == "w_t":
        return "column" if axis == ndim - 2 else "row"
    return "column"  # a column projection's bias or int8 scales


def _names(path) -> list[str]:
    return jsharding._path_names(path)


# ---------------------------------------------------------------------------
# Classification


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_roles_match_jax_param_spec(arch, fmt):
    """Every leaf of the reduced JAX param tree: the port's role equals the
    one JAX's param_spec (fsdp off, as the JAX engine shards) gives it,
    but for the int4 leaves, which JAX replicates and the port splits like
    the int8 codes of the same projection."""
    jcfg = jcfg_registry.get_reduced(arch)
    tree = jax.eval_shape(lambda: JT.model_init(jax.random.PRNGKey(0), jcfg,
                                                JEncodingConfig(**FORMATS[fmt])))
    seen = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = _names(path)
        spec = jsharding.param_spec(path, leaf, _mesh(2), fsdp=False)
        want = _jax_role(spec, names[-1], leaf.ndim)
        got = sharding.param_role(names, leaf.ndim)
        if names[-1] in sharding.PORT_ONLY_SPLITS:
            assert want == "replicated", (names, spec)
            as_int8 = sharding.param_role(names[:-1] + ["w_q"], leaf.ndim)
            assert got == as_int8 and got in ("column", "row", "replicated"), (names, got)
        else:
            assert got == want, (names, spec, got)
        seen.add(got)
    assert {"vocab", "replicated"} <= seen


@pytest.mark.parametrize("arch", ARCHS)
def test_port_tree_roles_match_its_jax_names(arch):
    """The port's own param tree (per-layer lists, expert lists) classifies
    its leaves as the JAX names do: an expert's projection is owned by its
    list's name, never by the index."""
    cfg = cfg_registry.get_reduced(arch)
    params = T.model_init(cfg, EncodingConfig(weight_quant="int8"), seed=0, device="cpu")
    roles = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + [i])
        else:
            names = sharding.path_names(path)
            roles[tuple(names)] = sharding.param_role(names, node.dim())

    walk(params, [])
    for names, role in roles.items():
        owner = [n for n in names[:-1] if not n.startswith("[")][-1:] or [""]
        if names[-1] in ("w_q", "w_scale") and owner[0] in ("wq", "w_gate", "w_up"):
            assert role == "column", names
        if names[-1] == "w_q" and owner[0] in ("wo", "w_down"):
            assert role == "row", names
        if owner[0] == "router":
            assert role == "replicated", names
    assert roles[("embed",)] == "vocab"


def _jax_caches(jcfg):
    out = [jax.eval_shape(lambda: JT.cache_init(jcfg, 2, 32))]
    if all(t == "attn" for t in jcfg.block_pattern) and not jcfg.sliding_window:
        out += [jax.eval_shape(lambda kv=kv: JT.cache_init(
            jcfg, 2, 32, cache_mode="paged", block_size=8, num_pages=9, kv_quant=kv))
            for kv in ("bf16", "kv8", "kv4")]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_roles_match_jax_serving_cache_shardings(arch):
    """Dense and paged caches (bf16, kv8, kv4 pools): K/V data and scale
    pages on the kv-head axis, tables and recurrent state replicated, as
    serving_cache_shardings places them (a 1-device mesh keeps every
    axis, so its spec is the rule itself)."""
    jcfg = jcfg_registry.get_reduced(arch)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("model",))
    for caches in _jax_caches(jcfg):
        specs = jsharding.serving_cache_shardings(caches, mesh)
        for (path, leaf), sh in zip(jax.tree_util.tree_flatten_with_path(caches)[0],
                                    jax.tree_util.tree_leaves(specs)):
            parts = list(sh.spec) + [None] * (leaf.ndim - len(sh.spec))
            want = "heads" if parts[-2:] == ["model", None] else "replicated"
            assert "model" not in parts or want == "heads", (path, sh.spec)
            assert sharding.cache_role(_names(path), leaf.ndim) == want, (path, sh.spec)


# ---------------------------------------------------------------------------
# The shard plan and the shards


def test_plan_whole_head_replications():
    """The port's sanitize: whole heads and rows, or replication."""
    enc = EncodingConfig()
    q = cfg_registry.get_reduced("qwen2-1.5b", num_kv_heads=4)
    for tp in (2, 4):
        s = sharding.plan(q, enc, tp, tp - 1)
        assert s.attn_split and s.mlp_split and s.vocab_split and s.replicated == ()
        assert (s.cfg.num_heads, s.cfg.num_kv_heads, s.cfg.d_ff) == (4 // tp, 4 // tp, 128 // tp)
        assert (s.q_lo, s.kv_lo, s.vocab_lo) == (4 - 4 // tp, 4 - 4 // tp, 256 - 256 // tp)
    one = cfg_registry.get_reduced("llama3.2-1b")  # 4 query heads, 1 kv head
    s = sharding.plan(one, enc, 2, 1)
    assert s.replicated == ("kv_heads",) and (s.cfg.num_heads, s.cfg.num_kv_heads) == (2, 1)
    full = cfg_registry.get_config("qwen2-1.5b")  # 12 / 2 heads: G = 6
    assert [sharding.plan(full, enc, 4, r).kv_lo for r in range(4)] == [0, 0, 1, 1]
    assert sharding.plan(full, enc, 8, 0).replicated == ("attention",)
    yi = cfg_registry.get_config("yi-9b")
    s = sharding.plan(yi, enc, 4, 3)
    assert (s.cfg.num_heads, s.cfg.num_kv_heads, s.cfg.d_ff, s.kv_lo) == (8, 1, 2752, 3)
    assert sharding.plan(one, EncodingConfig(weight_quant="int4", quant_group=32), 4, 0
                         ).replicated == ("attention",)
    assert sharding.plan(one, enc, 3, 0).replicated == ("attention", "mlp", "vocab")
    for arch in ("rwkv6-1.6b", "recurrentgemma-9b"):
        with pytest.raises(NotImplementedError, match="the recurrent blocks at tp > 1"):
            sharding.plan(cfg_registry.get_reduced(arch), enc, 2, 0)
    # MoE serves at tp > 1: each expert's FFN columns split, the router whole.
    mix = cfg_registry.get_reduced("mixtral-8x22b")
    s = sharding.plan(mix, enc, 2, 1)
    assert s.mlp_split and (s.cfg.d_ff, s.ff_lo, s.cfg.num_experts) == (64, 64, 4)
    full = T.model_init(mix, enc, seed=0, device="cpu")["layers"][0]["moe"]
    moe = T.model_init(mix, enc, seed=0, device="cpu", shard=s)["layers"][0]["moe"]
    assert torch.equal(moe["router"]["w_packed"], full["router"]["w_packed"])
    d = mix.d_model
    assert _plain(moe["w_gate"][3], 64, d)["w"].shape == (64, d)
    assert _plain(moe["w_down"][3], d, 64)["w"].shape == (d, 64)
    sharding.plan(mix, enc, 1, 0)


def _plain(p, n, k, group=16):
    return packed.linear_plain(p, n, k, group=group)


def _assert_equal(a: dict, b: dict, what):
    assert a.keys() == b.keys(), what
    for name in a:
        assert torch.equal(a[name], b[name]), (what, name)


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("arch,kv", [("qwen2-1.5b", 4), ("llama3.2-1b", None), ("yi-9b", 2),
                                     ("mixtral-8x22b", None), ("grok-1-314b", None)])
def test_shards_reassemble_bit_for_bit(arch, kv, fmt):
    """Every rank's shard at tp = 2 and 4, unpacked and put back together,
    is the full param tree bit for bit (codes and scales included); each
    rank holds its own heads, FFN columns and vocabulary rows (an MoE
    layer: every expert's FFN columns, the router whole); model_init
    with shard= makes the same shard as slicing the full init."""
    kw = {} if kv is None else {"num_kv_heads": kv}
    cfg = cfg_registry.get_reduced(arch, **kw)
    enc = EncodingConfig(**FORMATS[fmt])
    full = T.model_init(cfg, enc, seed=3, device="cpu")
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    vp = sharding.vocab_padded(cfg)
    cache_mode = "dense" if cfg.sliding_window else "paged"
    for tp in (2, 4):
        shards = [sharding.plan(cfg, enc, tp, r) for r in range(tp)]
        parts = [sharding.shard_params(full, cfg, enc, s) for s in shards]
        for s, p in zip(shards, parts):
            assert p["tp_shard"] == (tp, s.rank)
            assert p["embed"].shape == (vp // tp, d)
            wq = _plain(p["layers"][0]["attn"]["wq"], s.cfg.num_heads * hd, d)
            assert next(iter(wq.values())).shape == (h // tp * hd, d)
            for _, ffn in _ffns(p["layers"][0]):
                wd = _plain(ffn["w_down"], d, s.cfg.d_ff)
                assert next(iter(wd.values())).shape[0] == d and s.cfg.d_ff == f // tp
            caches = T.cache_init(s.cfg, 1, 16, cache_mode=cache_mode, block_size=8,
                                  device="cpu")
            assert caches["layers"][0]["k"].shape[-2] == max(1, kvh // tp)
            mine = T.model_init(cfg, enc, seed=3, device="cpu", shard=s)
            for i, (lp, mp) in enumerate(zip(p["layers"], mine["layers"])):
                blocks = [("attn", lp["attn"], mp["attn"])] + [
                    (where, a, b) for (where, a), (_, b) in zip(_ffns(lp), _ffns(mp))]
                for where, a, b in blocks:
                    for name in a:
                        n, k = _nk(cfg, s.cfg, name)
                        _assert_equal(_plain(a[name], n, k), _plain(b[name], n, k),
                                      (tp, s.rank, i, where, name))
                if cfg.num_experts:  # the router replicated, bit for bit
                    for q in (lp, mp):
                        _assert_equal(q["moe"]["router"], full["layers"][i]["moe"]["router"],
                                      (tp, s.rank, i, "router"))
            assert torch.equal(mine["embed"], p["embed"])
        assert torch.equal(torch.cat([p["embed"] for p in parts]), full["embed"])
        for i, lp in enumerate(full["layers"]):
            whole = [("attn", lp["attn"], [p["layers"][i]["attn"] for p in parts])]
            for j, (where, ffn) in enumerate(_ffns(lp)):
                whole.append((where, ffn, [_ffns(p["layers"][i])[j][1] for p in parts]))
            for where, want_blk, got_blks in whole:
                for name, axis in (("wq", 0), ("wk", 0), ("wv", 0), ("wo", 1), ("w_gate", 0),
                                   ("w_up", 0), ("w_down", 1)):
                    if name not in want_blk:
                        continue
                    n, k = _nk(cfg, cfg, name)
                    want = _plain(want_blk[name], n, k)
                    got = [_plain(g[name], *_nk(cfg, s.cfg, name))
                           for s, g in zip(shards, got_blks)]
                    if name in ("wk", "wv") and kvh < tp:  # each kv head on tp / kv ranks
                        got = [g for j, g in enumerate(got) if j % (tp // kvh) == 0]
                    _assert_equal(_join(got, axis), want, (tp, i, where, name))
        if "head" in full:
            want = _plain(full["head"], cfg.vocab_size, d)
            got = _join([_plain(p["head"], vp // tp, d) for p in parts], 0)
            _assert_equal({k: v[: cfg.vocab_size] for k, v in got.items()}, want, (tp, "head"))
            assert all(not v[cfg.vocab_size:].any() for v in got.values())


def _ffns(lp: dict) -> list[tuple[str, dict]]:
    """A layer's FFN projections by place: its MLP, or each expert's
    w_gate/w_up/w_down."""
    if "mlp" in lp:
        return [("mlp", lp["mlp"])]
    moe = lp["moe"]
    return [(f"expert {e}", {name: moe[name][e] for name in ("w_gate", "w_up", "w_down")})
            for e in range(len(moe["w_gate"]))]


def _nk(full, loc, name) -> tuple[int, int]:
    """(N, K) of projection `name` of a layer with `loc`'s heads and FFN."""
    d, hd = full.d_model, full.head_dim
    return {"wq": (loc.num_heads * hd, d), "wk": (loc.num_kv_heads * hd, d),
            "wv": (loc.num_kv_heads * hd, d), "wo": (d, loc.num_heads * hd),
            "w_gate": (loc.d_ff, d), "w_up": (loc.d_ff, d), "w_down": (d, loc.d_ff)}[name]


def _join(parts: list[dict], axis: int) -> dict:
    """Plain projection slices put back together: on the rows (axis 0), or
    on the columns (axis 1; the per-channel scales and bias are whole)."""
    out = {}
    for name in parts[0]:
        if axis == 1 and name in ("s", "b"):
            assert all(torch.equal(p[name], parts[0][name]) for p in parts)
            out[name] = parts[0][name]
        else:
            out[name] = torch.cat([p[name] for p in parts], dim=axis)
    return out


# ---------------------------------------------------------------------------
# build_serving_mesh


def test_serving_mesh_errors_and_axes(tmp_path):
    """Never a silent mesh=1: a shape the world size cannot cover raises
    ValueError naming both counts and how to start the ranks; the axis
    names are JAX's; bad shapes are refused."""
    with pytest.raises(ValueError) as ei:
        mesh_lib.build_serving_mesh((2,))
    assert "needs 2 ranks" in str(ei.value) and "world size 1" in str(ei.value)
    assert "--mesh-shape 2" in str(ei.value)
    m = mesh_lib.build_serving_mesh((1,))
    assert m.axis_names == ("model",) and m.tp_group is None and m.tp_size == 1
    assert mesh_lib.build_serving_mesh((1, 1)).axis_names == ("data", "model")
    assert mesh_lib.build_serving_mesh((1, 1, 1)).axis_names == ("pod", "data", "model")
    for bad in ((), (0,), (1, 1, 1, 1)):
        with pytest.raises(ValueError):
            mesh_lib.build_serving_mesh(bad)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=30))
    try:
        with pytest.raises(ValueError, match=r"needs 4 ranks but the process group has 1"):
            mesh_lib.build_serving_mesh((4,))
        assert mesh_lib.build_serving_mesh((1,)).tp_size == 1
    finally:
        dist.destroy_process_group()


def test_mesh_helpers_match_jax():
    from repro.launch import mesh as jmesh

    for devices, mp in ((1, 1), (1, 4)):
        j = jmesh.make_mesh_for(devices, model_parallel=mp)
        p = mesh_lib.make_mesh_for(devices, model_parallel=mp)
        assert p.axis_names == j.axis_names and p.shape == dict(j.shape)
        assert mesh_lib.data_axes(p) == jmesh.data_axes(j)
        assert mesh_lib.model_axes(p) == jmesh.model_axes(j)
    assert mesh_lib.make_mesh_for(8, model_parallel=3).shape == {"data": 4, "model": 2}
    assert mesh_lib.data_axes(mesh_lib.Mesh(("pod", "data", "model"), {})) == ("pod", "data")
    assert mesh_lib.rank_backend(4, "cpu") == ("gloo", ["cpu"] * 4)


# ---------------------------------------------------------------------------
# Shard-aware quarantine (JAX's two tests, on both registries)


@pytest.fixture
def _clean_registries():
    registry.clear_quarantine()
    jregistry.clear_quarantine()
    yield
    registry.clear_quarantine()
    jregistry.clear_quarantine()


@pytest.mark.usefixtures("_clean_registries")
def test_shard_local_demotion_is_max_for_spmd_but_local_per_shard():
    snaps = []
    for reg, phase in ((jregistry, JPhase), (registry, Phase)):
        key = reg.attn_dispatch_key(phase.DECODE, 64, "cpu")
        reg.demote(key, failing="pallas", reason="chaos", requested="pallas", shard=1)
        assert reg.quarantine_level(key) > 0
        assert reg.quarantine_level(key, shard=0) == 0
        assert reg.quarantine_level(key, shard=1) > 0
        snap = reg.quarantine_snapshot()
        assert f"{key}@shard1" in snap and snap[f"{key}@shard1"]["shard"] == 1
        assert key not in snap
        assert reg.resolve_key(key, requested="pallas").backend == "xla"
        assert reg.resolve_key(key, requested="pallas", shard=0).backend == "pallas"
        snaps.append(snap)
    assert snaps[0] == snaps[1]


@pytest.mark.usefixtures("_clean_registries")
def test_global_demotion_applies_to_every_shard():
    snaps = []
    for reg, phase in ((jregistry, JPhase), (registry, Phase)):
        key = reg.attn_dispatch_key(phase.DECODE, 64, "cpu")
        reg.demote(key, failing="pallas", reason="global", requested="pallas")
        assert reg.quarantine_level(key, shard=0) > 0
        assert reg.quarantine_level(key, shard=3) > 0
        snaps.append(reg.quarantine_snapshot())
    assert snaps[0] == snaps[1]


# ---------------------------------------------------------------------------
# ShardedBlockAllocator (JAX's three tests, and a random op stream on both)


@pytest.mark.parametrize("lib", [jpaged, paged], ids=["jax", "port"])
def test_sharded_allocator_mirrors_and_audits(lib):
    alloc = lib.ShardedBlockAllocator(16, 8, shards=2)
    assert alloc.capacity == lib.BlockAllocator(16, 8).capacity
    assert len(alloc.shards) == 2
    pages = [alloc.alloc() for _ in range(3)]
    assert alloc.in_use() == 3
    assert alloc.stats["tp_shards"] == 2
    per = alloc.per_shard_stats()
    assert len(per) == 2 and per[0]["allocs"] == per[1]["allocs"] == 3
    alloc.audit([pages])
    alloc.free_pages(pages)
    alloc.audit([])


@pytest.mark.parametrize("lib", [jpaged, paged], ids=["jax", "port"])
def test_sharded_allocator_detects_divergence(lib):
    alloc = lib.ShardedBlockAllocator(16, 8, shards=2)
    a = alloc.alloc()
    alloc.shards[1].free_page(a)
    with pytest.raises(lib.AllocatorInvariantError, match="diverged"):
        alloc.alloc()


@pytest.mark.parametrize("lib", [jpaged, paged], ids=["jax", "port"])
def test_sharded_allocator_per_shard_audit_failure_names_shard(lib):
    alloc = lib.ShardedBlockAllocator(16, 8, shards=2)
    a = alloc.alloc()
    alloc.shards[1].free_page(a)
    with pytest.raises(lib.AllocatorInvariantError, match="shard 1"):
        alloc.audit([[a]])


@pytest.mark.parametrize("seed", range(3))
def test_sharded_allocator_random_ops_match_jax(seed):
    """One random stream of prompt plans, commits, shares, decode growth and
    frees on JAX's and the port's ShardedBlockAllocator: the same results,
    stats and per-shard stats after every op, and clean audits."""
    rng = np.random.RandomState(seed)
    kw = dict(shards=3, kv_quant="kv8", prefix_cache=True)
    allocs = [jpaged.ShardedBlockAllocator(24, 4, **kw), paged.ShardedBlockAllocator(24, 4, **kw)]
    held: list[list[int]] = [[], []]
    base = rng.randint(1, 50, 16).astype(np.int32)
    for _ in range(120):
        op = rng.randint(4)
        prompt = np.concatenate([base[: rng.randint(0, 17)],
                                 rng.randint(1, 50, rng.randint(1, 9)).astype(np.int32)])
        outs = []
        for a, tables in zip(allocs, held):
            if op == 0:  # admit a prompt that may share a prefix of `base`
                nb, shared = a.plan_prompt(prompt)
                plan = a.commit_prompt(prompt, nb, shared) if a.plan_fits(nb, shared) else None
                if plan is not None:
                    a.mark_written(plan.pages)
                    tables.append(list(plan.pages))
                outs.append(None if plan is None else (plan.pages, plan.shared))
            elif op == 1 and tables:  # decode growth
                p = a.alloc()
                if p is not None:
                    tables[0].append(p)
                outs.append(p)
            elif op == 2 and tables:  # a request finishes
                a.free_pages(tables.pop(0))
                outs.append(a.available())
            else:
                outs.append(a.in_use())
        assert outs[0] == outs[1], (op, outs)
        assert allocs[0].stats == allocs[1].stats
        assert allocs[0].per_shard_stats() == allocs[1].per_shard_stats()
        for a, tables in zip(allocs, held):
            a.audit(tables)
