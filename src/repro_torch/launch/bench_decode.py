"""Device time of the decode-attention kernels at the serving shapes.

  PYTHONPATH=src python -m repro_torch.launch.bench_decode [--label NAME]

Times paged decode (bf16 and f32 queries; bf16, kv8 and kv4 pools; windows
L = 1, 5, 16, 256) and dense decode (S_c = 1024, L = 1 and 16) at the shapes
chip_smoke.py's phase 2 uses: B = 4, H = 32, KV = 8, D = 64, positions
{37, 300, 511, 900}, block 16.  Three numbers a shape, each the median of
--reps repeats:

  event_ms   CUDA events around one call after a 256 MB write that leaves
             the 50 MB L2 cold (chip_smoke.py's Timer): what phase 2 reports;
             the call's host time (the wrapper's Python) counts where it
             outlasts the write;
  kernel_ms  the decode kernel's own duration by torch.profiler, L2 cold:
             device time only;
  warm_ms    CUDA events over back-to-back calls, L2 warm, as inside a
             serving step: bounded by the host's issue rate.

The module only calls the wrappers' public signatures, so it times another
checkout's kernels too: run this file by path with PYTHONPATH set to that
checkout's src/.  Prints one JSON line; writes chiprun_out/bench_decode-<label>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess

import numpy as np
import torch


def _kernel_ms(fn, flush: torch.Tensor) -> float | None:
    """Summed duration of the device kernels one call of `fn` runs (the
    flush before it is outside the profile)."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    flush.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and "decode" in e.name]
    return sum(e.time_range.elapsed_us() for e in kern) / 1e3 if kern else None


def _event_ms(fn, flush: torch.Tensor | None, iters: int) -> float:
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        if flush is not None:
            flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def main(argv: list[str] | None = None) -> dict:
    from repro_torch.core import encoding
    from repro_torch.kernels import attn

    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_decode needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    b, h, kvh, d, bs, pages = 4, 32, 8, 64, 16, 257
    pos = torch.tensor([37, 300, 511, 900], dtype=torch.int32, device=dev)
    rng = np.random.RandomState(args.seed)
    table_full = torch.from_numpy(np.stack(
        [rng.permutation(pages - 1)[:80] + 1 for _ in range(b)]).astype(np.int32)).to(dev)

    def kv_data(kv, dt, *shape):
        x = torch.randn(shape, generator=gen, device=dev)
        if kv == "bf16":
            return x.to(dt), None
        return encoding.kv_layout(kv).quantize(x)

    cases = []
    for kv in ("bf16", "kv8", "kv4"):
        for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            k_pool, k_sc = kv_data(kv, dt, pages, bs, kvh, d)
            v_pool, v_sc = kv_data(kv, dt, pages, bs, kvh, d)
            kw = dict(k_scale=k_sc, v_scale=v_sc, kv_quant=kv)
            for L in (1, 5, 16, 256):
                nb = max(64, -(-(900 + L) // bs))
                table = table_full[:, :nb].contiguous()
                q = torch.randn(b, L, h, d, generator=gen, device=dev).to(dt)
                cases.append((f"paged {kv} {dname} L={L}", lambda q=q, k=k_pool, v=v_pool,
                              t=table, kw=kw: attn.paged_decode_attention(q, k, v, t, pos, **kw)))
            s_c = 1024
            kc, kcs = kv_data(kv, dt, b, s_c, kvh, d)
            vc, vcs = kv_data(kv, dt, b, s_c, kvh, d)
            kwd = dict(k_scale=kcs, v_scale=vcs, kv_quant=kv)
            for L in (1, 16):
                q = torch.randn(b, L, h, d, generator=gen, device=dev).to(dt)
                cases.append((f"dense {kv} {dname} S_c=1024 L={L}", lambda q=q, k=kc, v=vc,
                              kw=kwd: attn.dense_decode_attention(q, k, v, pos, **kw)))

    rows = {}
    for name, fn in cases:
        for _ in range(3):
            fn()
        ev = [_event_ms(fn, flush, 10) for _ in range(args.reps)]
        kern = [_kernel_ms(fn, flush) for _ in range(args.reps)]
        warm = [_event_ms(fn, None, 50) for _ in range(args.reps)]
        kern = [x for x in kern if x is not None]
        rows[name] = dict(event_ms=statistics.median(ev),
                          kernel_ms=statistics.median(kern) if kern else None,
                          warm_ms=statistics.median(warm))
        r = rows[name]
        km = "not measured" if r["kernel_ms"] is None else f"{r['kernel_ms']:.4f}"
        print(f"[bench] {args.label:8s} {name:28s} event {r['event_ms']:.4f}  kernel {km}  "
              f"warm {r['warm_ms']:.4f} ms", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = dict(label=args.label, card=card.strip(), rows=rows)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"bench_decode-{args.label}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(dict(label=args.label, card=out["card"])))
    return out


if __name__ == "__main__":
    main()
