#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

  1. build   every csrc/*.cu kernel with nvcc for sm_90a (one process per
             source, all started together) and print the card's name and
             power limit;
  2. kernels each of the four kernels against its plain PyTorch version at
             the full-width Llama-3.2-1B shapes, in bf16 and f32, with its
             time, the plain version's time, a library yardstick timed only
             (torch.matmul on the unpacked weight, SDPA), and the roofline
             bound computed from the shapes;
  3. forward a depth-2, full-width f32 model served through the kernels and
             through the plain backends on the card: identical tokens;
  4. serve   the full-depth, full-width bf16 Llama-3.2-1B (random weights from
             --seed): 8 requests, half sharing a 256-token prefix so the second
             wave runs the suffix prefill; every kernel's launch count must
             equal dispatches x layers x (7 projections or 1 attention).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json.
The script needs torch with CUDA and the repository's src/ beside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# file:line of the Pallas kernel each CUDA kernel replaces.
REPLACES = {
    "fused_gemv": "src/repro/kernels/fused_gemv.py:56",
    "fused_pack_mmt4d": "src/repro/kernels/fused_pack_mmt4d.py:59",
    "flash_prefill_attention": "src/repro/kernels/attn.py:465",
    "paged_decode_attention": "src/repro/kernels/attn.py:163",
}
SOURCES = {
    "fused_gemv": "src/repro_torch/csrc/fused_gemv.cu",
    "fused_pack_mmt4d": "src/repro_torch/csrc/fused_pack_mmt4d.cu",
    "flash_prefill_attention": "src/repro_torch/csrc/flash_prefill.cu",
    "paged_decode_attention": "src/repro_torch/csrc/paged_decode.cu",
}
# The shape whose numbers stand for each kernel in the JSON line: the one the
# serving run (phase 4) gives it most often, in bf16.
HEADLINE = {
    "fused_gemv": "bf16 M=4 K=2048 N=8192",
    "fused_pack_mmt4d": "bf16 M=2048 K=2048 N=8192",
    "flash_prefill_attention": "bf16 B=4 Sq=512 Sk=512 q_offset=0",
    "paged_decode_attention": "bf16 B=4 L=1",
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Device time of one call by CUDA events, mean over `iters` launches.
    With `flush`, a 256 MB buffer is written before every launch (outside
    the timed window) so the call finds the 50 MB L2 cold, as the serving
    step does: each layer's weights are read once per step."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)

    def ms(self, fn, *, iters: int = 10, warmup: int = 2, flush: bool = True) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        for i in range(iters):
            if flush:
                self.flush_buf.zero_()
            starts[i].record()
            fn()
            ends[i].record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound(target, *, bytes_moved: float, flops: float, dtype_name: str) -> tuple[float, str]:
    """Least time (ms) the card could take: max(bytes / memory rate, operations
    / peak rate for the inputs' type: bf16 tensor cores, or f32 CUDA cores)."""
    peak = target.peak_flops_bf16 if dtype_name == "bf16" else target.peak_flops_f32
    t_bytes = bytes_moved / target.hbm_bytes_per_s
    t_ops = flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch, dev, target, timer, results: dict) -> None:
    """Phase 2: every kernel against its plain version at the main path's
    full-width shapes, both dtypes."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import attn, fused_gemv, fused_pack_mmt4d, ref

    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    def record(name, key, *, err, tol, ms, plain_ms, library_ms, bytes_moved, flops, dname):
        b_ms, b_by = bound(target, bytes_moved=bytes_moved, flops=flops, dtype_name=dname)
        row = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=b_ms, bound_by=b_by)
        results.setdefault(name, {})[key] = row
        log(f"[kernel] {name:24s} {key:38s} err={err:.3e} (tol {tol:.0e}) ms={ms:.4f} "
            f"plain={plain_ms:.4f} library={library_ms:.4f} bound={b_ms:.4f} ({b_by})")
        if not err <= tol:
            raise AssertionError(f"{name} {key}: max abs error {err} exceeds {tol}")

    dtypes = [("bf16", torch.bfloat16), ("f32", torch.float32)]
    kn = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
    for dname, dt in dtypes:
        s = 2 if dname == "bf16" else 4
        for k, n in kn:
            w_t = rnd(n, k, scale=k**-0.5).to(dt)
            rhs4 = ref.pack(w_t, (128, 128))
            for m in (1, 4, 8):
                x = rnd(m, k).to(dt)
                got = fused_gemv.fused_gemv(x, rhs4)
                want = fused_gemv.fused_gemv_plain(x, rhs4)
                record("fused_gemv", f"{dname} M={m} K={k} N={n}",
                       err=(got - want).abs().max().item(), tol=1e-3,
                       ms=timer.ms(lambda: fused_gemv.fused_gemv(x, rhs4)),
                       plain_ms=timer.ms(lambda: fused_gemv.fused_gemv_plain(x, rhs4)),
                       library_ms=timer.ms(lambda: torch.matmul(x, w_t.t())),
                       bytes_moved=(m * k + n * k) * s + m * n * 4, flops=2 * m * n * k,
                       dname=dname)
            for m in (16, 512, 2048):
                x = rnd(m, k).to(dt)
                got = fused_pack_mmt4d.fused_pack_mmt4d(x, rhs4)
                want = fused_pack_mmt4d.fused_pack_mmt4d_plain(x, rhs4)
                record("fused_pack_mmt4d", f"{dname} M={m} K={k} N={n}",
                       err=(got - want).abs().max().item(), tol=1e-3,
                       ms=timer.ms(lambda: fused_pack_mmt4d.fused_pack_mmt4d(x, rhs4)),
                       plain_ms=timer.ms(
                           lambda: fused_pack_mmt4d.fused_pack_mmt4d_plain(x, rhs4), iters=3),
                       library_ms=timer.ms(lambda: torch.matmul(x, w_t.t())),
                       bytes_moved=(m * k + n * k) * s + m * n * 4, flops=2 * m * n * k,
                       dname=dname)
            del w_t, rhs4

    b, h, kvh, d = 4, 32, 8, 64
    for dname, dt in dtypes:
        s = 2 if dname == "bf16" else 4
        tol = 2e-2 if dname == "bf16" else 1e-4
        for sq, sk, q_off in ((512, 512, 0), (256, 512, 256)):
            q, k, v = rnd(b, sq, h, d).to(dt), rnd(b, sk, kvh, d).to(dt), rnd(b, sk, kvh, d).to(dt)
            got = attn.flash_prefill_attention(q, k, v, q_offset=q_off)
            want = attn.flash_prefill_attention_plain(q, k, v, q_offset=q_off)
            qpos = q_off + torch.arange(sq, device=dev)
            mask = torch.arange(sk, device=dev)[None, :] <= qpos[:, None]
            pairs = int(mask.sum().item())  # causal (query, key) pairs this run needs
            # SDPA yardstick on K/V expanded to the query heads (head = kv*G + j).
            qt = q.transpose(1, 2)
            kt, vt = (t.repeat_interleave(h // kvh, dim=2).transpose(1, 2) for t in (k, v))
            record("flash_prefill_attention", f"{dname} B={b} Sq={sq} Sk={sk} q_offset={q_off}",
                   err=(got.float() - want.float()).abs().max().item(), tol=tol,
                   ms=timer.ms(lambda: attn.flash_prefill_attention(q, k, v, q_offset=q_off)),
                   plain_ms=timer.ms(lambda: attn.flash_prefill_attention_plain(
                       q, k, v, q_offset=q_off), iters=3),
                   library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=mask)),
                   bytes_moved=(2 * b * sq * h * d + 2 * b * sk * kvh * d) * s,
                   flops=4 * b * h * d * pairs, dname=dname)

    bs, nb, pages = 16, 64, 257
    pos_list = [37, 300, 511, 900]
    rng = np.random.RandomState(0)
    for dname, dt in dtypes:
        s = 2 if dname == "bf16" else 4
        tol = 2e-2 if dname == "bf16" else 1e-4
        k_pool = rnd(pages, bs, kvh, d).to(dt)
        v_pool = rnd(pages, bs, kvh, d).to(dt)
        table = torch.from_numpy(
            np.stack([rng.permutation(np.arange(1, pages))[:nb] for _ in range(b)]).astype(np.int32)
        ).to(dev)
        for L in (1, 4):
            pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
            q = rnd(b, L, h, d).to(dt)
            got = attn.paged_decode_attention(q, k_pool, v_pool, table, pos)
            want = attn.paged_decode_attention_plain(q, k_pool, v_pool, table, pos)
            live = max(pos_list) + L
            kview, vview = (attn.paged_gather(p, table)[:, :live]
                            .repeat_interleave(h // kvh, dim=2).transpose(1, 2)
                            for p in (k_pool, v_pool))
            qpos = pos[:, None].long() + torch.arange(L, device=dev)
            amask = (torch.arange(live, device=dev) <= qpos[..., None])[:, None]
            keys = sum(p + L for p in pos_list)  # distinct cached keys each row reads
            pairs = sum(p + j + 1 for p in pos_list for j in range(L))
            qt = q.transpose(1, 2)
            record("paged_decode_attention", f"{dname} B={b} L={L}",
                   err=(got.float() - want.float()).abs().max().item(), tol=tol,
                   ms=timer.ms(lambda: attn.paged_decode_attention(q, k_pool, v_pool, table, pos)),
                   plain_ms=timer.ms(lambda: attn.paged_decode_attention_plain(
                       q, k_pool, v_pool, table, pos)),
                   library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                       qt, kview, vview, attn_mask=amask)),
                   bytes_moved=(2 * b * L * h * d + 2 * keys * kvh * d) * s + b * nb * 4 + b * 4,
                   flops=4 * h * d * pairs, dname=dname)
    torch.cuda.synchronize()


def forward_check(torch, dev, seed: int) -> dict:
    """Phase 3: depth-2, full-width f32 model; one batched prefill and 8
    decode steps through the kernels and through the plain backends."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving.config import EngineConfig

    cfg = dataclasses.replace(cfg_registry.get_config("llama3.2-1b"), num_layers=2,
                              dtype="float32")
    params = T.model_init(cfg, EncodingConfig(), seed=seed, device=dev)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in (100, 37, 250, 180)]
    outs = {}
    for label, enc in (("kernels", EncodingConfig(backend="fused", attn_backend="auto")),
                       ("plain", EncodingConfig(backend="reference", attn_backend="xla"))):
        eng = engine_lib.Engine(params, cfg, enc,
                                config=EngineConfig(slots=4, max_seq=512, block_size=16),
                                device=dev)
        for i, p in enumerate(prompts):
            eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=8))
        done = eng.run()
        st = eng.stats
        if st["dispatches"] != {"prefill": 1, "decode": 8}:
            raise AssertionError(f"{label}: dispatches {st['dispatches']}")
        outs[label] = {r.uid: r.generated for r in done}
    same = outs["kernels"] == outs["plain"]
    log(f"[forward] depth-2 f32 full width: kernel tokens == plain tokens: {same}")
    if not same:
        raise AssertionError(f"token mismatch: {outs}")
    del params
    torch.cuda.empty_cache()
    return outs


def serve(torch, dev, seed: int) -> dict:
    """Phase 4: the main path at full width and depth, bf16."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.kernels import attn, fused_gemv, fused_pack_mmt4d
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving.config import EngineConfig

    cfg = cfg_registry.get_config("llama3.2-1b")
    enc = EncodingConfig(backend="fused", attn_backend="auto")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.model_init(cfg, enc, seed=seed, device=dev)
    torch.cuda.synchronize()
    log(f"[serve] init {cfg.name} ({cfg.dtype}) in {time.perf_counter() - t0:.1f}s")
    eng = engine_lib.Engine(params, cfg, enc,
                            config=EngineConfig(slots=4, max_seq=1024, block_size=16),
                            device=dev)
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, cfg.vocab_size, 256).astype(np.int32)
    shared = {0, 4, 5, 6}  # wave 1 writes the prefix; wave 2 reuses it
    lengths = rng.randint(100, 501, 8)
    for i in range(8):
        if i in shared:
            tail = rng.randint(1, cfg.vocab_size, max(1, int(lengths[i]) - 256))
            prompt = np.concatenate([prefix, tail]).astype(np.int32)
        else:
            prompt = rng.randint(1, cfg.vocab_size, int(lengths[i])).astype(np.int32)
        if not eng.submit(engine_lib.Request(uid=i, prompt=prompt, max_new_tokens=32)):
            raise AssertionError(f"request {i} rejected")

    kernels = (fused_gemv.fused_gemv, fused_pack_mmt4d.fused_pack_mmt4d,
               attn.flash_prefill_attention, attn.paged_decode_attention)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}

    st = eng.stats
    tokens = sum(len(r.generated) for r in done)
    bad = [(r.uid, r.status, len(r.generated)) for r in done
           if r.status != "ok" or len(r.generated) != 32]
    if len(done) != 8 or bad:
        raise AssertionError(f"requests not all ok with 32 tokens: {bad}")
    eng.audit()
    if st["pages_in_use"] != 0:
        raise AssertionError(f"pages leaked: {st['pages_in_use']} in use after the run")
    if st["degraded"]:
        raise AssertionError(f"kernels quarantined: {st['degraded']}")
    if st["prefix_cache"]["hit_tokens"] <= 0:
        raise AssertionError("no prefix-cache hit")
    disp = st["dispatches"]
    layers = cfg.num_layers
    want = {
        "fused_gemv": disp["decode"] * layers * 7,
        "fused_pack_mmt4d": disp["prefill"] * layers * 7,
        "flash_prefill_attention": disp["prefill"] * layers,
        "paged_decode_attention": disp["decode"] * layers,
    }
    log(f"[serve] launches {launches} expected {want} dispatches {disp}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    wd = st["watchdog"]
    log(f"[serve] 8/8 requests ok, {tokens} tokens in {wall:.3f}s "
        f"({tokens / wall:.1f} tok/s incl. prefill); step p50 {wd['p50_ms']:.3f} ms "
        f"p99 {wd['p99_ms']:.3f} ms; prefix hit_tokens {st['prefix_cache']['hit_tokens']}; "
        f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return {"launches": launches, "dispatches": disp, "tokens": tokens, "wall_s": wall,
            "tok_s": tokens / wall, "step_p50_ms": wd["p50_ms"], "step_p99_ms": wd["p99_ms"],
            "hit_tokens": st["prefix_cache"]["hit_tokens"], "steps": st["steps"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs on a GPU",
              file=sys.stderr)
        return 1
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    from repro_torch.core import targets
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[build] card {smi}; python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] nvcc sm_90a: {len(reports)} of {len(build.sources())} sources built "
        f"in {build_s:.1f}s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")

    results: dict = {}
    timer = Timer(torch, dev)
    t0 = time.perf_counter()
    check_kernels(torch, dev, targets.H100, timer, results)
    log(f"[kernel] checks done in {time.perf_counter() - t0:.1f}s")
    del timer
    torch.cuda.empty_cache()
    forward_check(torch, dev, args.seed)
    served = serve(torch, dev, args.seed)

    table = []
    for name in REPLACES:
        row = results[name][HEADLINE[name]]
        table.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": served["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in results[name].values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": HEADLINE[name],
        })
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "kind": kind, "build_s": build_s, "kernels": results,
                   "serve": served, "table": table}, f, indent=1)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
