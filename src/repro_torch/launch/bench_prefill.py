"""Device time of the prefill kernels at the serving shapes.

  PYTHONPATH=src python -m repro_torch.launch.bench_prefill [--label NAME]

Times the prefill GEMM (`fused_pack_mmt4d`: M = 16, 512, 2048 rows against
the Llama-3.2-1B projections K x N = 2048 x 2048, 2048 x 512, 2048 x 8192,
8192 x 2048) and flash prefill (B = 4, H = 32, KV = 8, D = 64: Sq = Sk = 512
at q_offset 0, and a suffix Sq = 256 over Sk = 512 at q_offset 256), in bf16
and f32, at the shapes chip_smoke.py's phase 2 uses, beside one library call
computing the same function (torch.matmul on the unpacked weight; SDPA with
the causal mask, and at q_offset 0 SDPA's own is_causal with enable_gqa).
Three numbers a shape, each the median of --reps repeats:

  event_ms   CUDA events around one call after a 256 MB write that leaves
             the 50 MB L2 cold (chip_smoke.py's Timer): what phase 2 reports;
  kernel_ms  the device kernels' own duration by torch.profiler, L2 cold;
  warm_ms    CUDA events over back-to-back calls, L2 warm.

The module only calls the wrappers' public signatures, so it times another
checkout's kernels too: run this file by path with PYTHONPATH set to that
checkout's src/.  Prints one line a shape and one JSON line; writes
chiprun_out/bench_prefill-<label>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess

import torch
import torch.nn.functional as F


def _kernel_ms(fn, flush: torch.Tensor) -> float | None:
    """Summed duration of the device kernels one call of `fn` runs (the
    flush before it is outside the profile)."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    flush.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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


def _causal_sdpa(q, k, v):
    """SDPA's own causal prefill over the grouped heads, where the installed
    torch takes enable_gqa; else None."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    except TypeError:
        return None
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)


def cases(dev, gen) -> list:
    """(name, fn) of every timed call: the kernels and their library calls."""
    from repro_torch.kernels import attn, fused_pack_mmt4d, ref

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    out = []
    for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for k, n in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)):
            w_t = rnd(n, k, scale=k**-0.5).to(dt)
            rhs4 = ref.pack(w_t, (128, 128))
            for m in (16, 512, 2048):
                x = rnd(m, k).to(dt)
                key = f"{dname} M={m} K={k} N={n}"
                out.append((f"gemm {key}", lambda x=x, r=rhs4:
                            fused_pack_mmt4d.fused_pack_mmt4d(x, r)))
                out.append((f"matmul {key}", lambda x=x, w=w_t: torch.matmul(x, w.t())))
        b, h, kvh, d = 4, 32, 8, 64
        for sq, sk, q_off in ((512, 512, 0), (256, 512, 256)):
            q, kk, v = rnd(b, sq, h, d).to(dt), rnd(b, sk, kvh, d).to(dt), rnd(b, sk, kvh, d).to(dt)
            key = f"{dname} B={b} Sq={sq} Sk={sk} q_offset={q_off}"
            out.append((f"flash {key}", lambda q=q, k=kk, v=v, o=q_off:
                        attn.flash_prefill_attention(q, k, v, q_offset=o)))
            mask = (torch.arange(sk, device=dev)[None, :]
                    <= q_off + torch.arange(sq, device=dev)[:, None])
            qt = q.transpose(1, 2)
            kt, vt = (t.repeat_interleave(h // kvh, dim=2).transpose(1, 2) for t in (kk, v))
            out.append((f"sdpa_masked {key}", lambda qt=qt, kt=kt, vt=vt, m=mask:
                        F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m)))
            causal = _causal_sdpa(q, kk, v) if q_off == 0 else None
            if causal is not None:
                out.append((f"sdpa_causal {key}", causal))
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_prefill needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    rows = {}
    for name, fn in cases(dev, gen):
        for _ in range(3):
            fn()
        ev = [_event_ms(fn, flush, 10) for _ in range(args.reps)]
        kern = [_kernel_ms(fn, flush) for _ in range(args.reps)]
        warm = [_event_ms(fn, None, 20) for _ in range(args.reps)]
        kern = [x for x in kern if x is not None]
        rows[name] = dict(event_ms=statistics.median(ev),
                          kernel_ms=statistics.median(kern) if kern else None,
                          warm_ms=statistics.median(warm))
        r = rows[name]
        km = "not measured" if r["kernel_ms"] is None else f"{r['kernel_ms']:.4f}"
        print(f"[bench] {args.label:8s} {name:48s} event {r['event_ms']:.4f}  kernel {km}  "
              f"warm {r['warm_ms']:.4f} ms", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = dict(label=args.label, card=card.strip(), rows=rows)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"bench_prefill-{args.label}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(dict(label=args.label, card=out["card"])))
    return out


if __name__ == "__main__":
    main()
