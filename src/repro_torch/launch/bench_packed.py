"""Device time of the packed GEMMs, the packed and plain-row GEMVs and the
prefill GEMM at the serving shapes.

  PYTHONPATH=src python -m repro_torch.launch.bench_packed [--label NAME] [--sweep]
      [--match PREFIX,...]

Times, against the Llama-3.2-1B projections K x N = 2048 x 2048, 2048 x
512, 2048 x 8192 and 8192 x 2048 (the shapes of chip_smoke.py's phase 2),
in bf16: `mmt4d` at 16, 20 and 256 rows packed in M0 = 8 blocks and 2048
rows in M0 = 128 slabs, `mmt4d_gemv` and `fused_gemv` at 1, 4 and 8 rows,
and `fused_pack_mmt4d` at 16, 512 and 2048 rows, each beside torch.matmul
on the unpacked weight at the same rows; in int8 (w8a8): `fused_gemv_q8`
at 1, 4 and 8 rows and `mmt4d_q8` at the packed GEMM's rows, beside
torch._int_mm plus the scale epilogue (rows padded to 32 where there are 16
or fewer: _int_mm takes more than 16); in
int4 (w4a8, groups 16 and 32): `mmt4d_q4` at the packed GEMM's rows and
`fused_gemv_q4` at 1, 4 and 8 rows (no PyTorch call computes int4 x int8);
and `batch_mmt4d` at chip_smoke.py's attention shapes in f32 and bf16,
beside torch.einsum.  The packed GEMMs' plain-row entries (`mmt4d_rows`,
`mmt4d_q8_rows`, `mmt4d_q4_rows` at the packed GEMMs' rows and M0,
`mmt4d_gemv_rows` at 1, 4 and 8) are timed beside their packed twins, and
the whole packed route, kernels/ops.py's encoded_matmul{,_q8,_q4} with
backend "pallas" (decode rows at M0 = 8, the 2048 rows as a prefill at M0 =
128; the w8a8/w4a8 routes quantize the bf16 rows first), at 16, 20, 256
and 2048 rows in each weight format: the route's calls are the same in
every tree, so its host_us and event_ms compare two trees' routes.
Four numbers a shape, each the median of --reps repeats (as
launch/bench_prefill.py):

  event_ms   CUDA events around one call after a 256 MB write that leaves
             the 50 MB L2 cold (chip_smoke.py's Timer): what phase 2 reports;
  kernel_ms  the device kernels' own duration by torch.profiler, L2 cold;
  warm_ms    CUDA events over back-to-back calls, L2 warm;
  host_us    host time a call over back-to-back calls, the device not
             waited for: the wrapper's own cost (checks, plan, tensor map,
             ctypes) as a decode step pays it.

Every kernel row also carries a checksum of its output's bytes, so two
checkouts' kernels can be compared bit for bit: the module calls only the
wrappers' public signatures, so run this file by path with PYTHONPATH set to
another checkout's src/ to time that tree.  --sweep (this tree's plans only)
adds the bf16 and int8 packed GEMMs at 64, 128 and 256 rows (M0 = 8) under
each body, the skinny body's K split at grid targets of 132, 264 and 528
blocks, `mmt4d_q4` at 16, 20, 256 and 2048 rows under both block widths
(16 and 64 columns) at those targets, and both decode GEMVs under each of
their plans (8 and 16 warps a block).  Prints one line a shape and one JSON line; writes
chiprun_out/bench_packed-<label>.json.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import time

import torch

from repro_torch.launch.bench_prefill import _event_ms, _kernel_ms

KN = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))


def checksum(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def _skinny_plans(m1: int, m0: int, n1: int, k1: int) -> list:
    """Skinny plans at the K splits that bring the grid to 132, 264 and 528
    blocks."""
    from repro_torch.kernels import mmt4d

    x, _, z = mmt4d.skinny_grid(m1, m0, n1, 1)
    splits = [min(k1, -(-target // (x * z))) for target in (132, 264, 528)]
    return [(target, ("skinny", mmt4d.SKINNY_BN, s)) for target, s in zip((132, 264, 528), splits)]


def _q4_plans(m1: int, m0: int, n1: int, k1: int) -> list:
    """int4 plans (this tree's only): 16-column blocks, and 64-column ones
    where a block holds 57-64 rows, at the K splits that bring the grid to
    132, 264 and 528 blocks."""
    from repro_torch.kernels import mmt4d_q4

    bns = [mmt4d_q4.Q4_BN]
    if mmt4d_q4.q4_groups(m1, m0)[0] > mmt4d_q4.Q4_ROWS - 8:
        bns.append(mmt4d_q4.Q4_WIDE_BN)
    out = []
    for bn in bns:
        x, _, z = mmt4d_q4.q4_grid(m1, m0, n1, bn, 1)
        for target in (132, 264, 528):
            out.append((target, ("skinny", bn, min(k1, -(-target // (x * z))))))
    return out


def _gemv_plans() -> list:
    """The w8a8/w4a8 decode GEMVs' plans (this tree's only): the
    decode-GEMV body at each warp count."""
    from repro_torch.kernels import fused_gemv

    return [("warps", fused_gemv.GEMV_BN, w) for w in fused_gemv.GEMV_WARPS]


def cases(dev, gen, sweep: bool) -> list:
    """(name, fn, checked) of every timed call: the kernels (checked: their
    output's checksum is printed) and their library calls."""
    from repro_torch.core.encoding import Phase
    from repro_torch.kernels import (batch_mmt4d, fused_gemv, fused_pack_mmt4d, mmt4d,
                                     mmt4d_gemv, mmt4d_q4, mmt4d_q8, ops, ref)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def scales(*shape):
        return (0.5 + torch.rand(shape, generator=gen, device=dev)) * 1e-2

    out = []
    for k, n in KN:
        k1, n1 = k // 128, n // 128
        w_t = rnd(n, k, scale=k**-0.5)
        rhs4 = ref.pack(w_t, (128, 128))
        lhs = {m: rnd(m, k) for m in (1, 4, 8, 16, 20, 256, 512, 2048)}
        for m in sorted(lhs):
            key = f"M={m} K={k} N={n}"
            x = lhs[m]
            if m <= 8:
                out.append((f"mmt4d_gemv {key}", lambda a=ref.pack(x, (m, 128)), r=rhs4:
                            mmt4d_gemv.mmt4d_gemv(a, r), True))
                out.append((f"mmt4d_gemv_rows {key}", lambda a=x, r=rhs4:
                            mmt4d_gemv.mmt4d_gemv_rows(a, r), True))
                out.append((f"fused_gemv {key}", lambda a=x, r=rhs4:
                            fused_gemv.fused_gemv(a, r), True))
            if m in (16, 20, 256, 2048):
                m0 = 128 if m == 2048 else 8
                out.append((f"mmt4d {key}", lambda a=ref.pack(x, (m0, 128)), r=rhs4:
                            mmt4d.mmt4d(a, r), True))
                out.append((f"mmt4d_rows {key}", lambda a=x, r=rhs4, m0=m0:
                            mmt4d.mmt4d_rows(a, r, m0), True))
                phase = Phase.PREFILL if m0 == 128 else Phase.DECODE
                out.append((f"route bf16 {key}", lambda a=x, r=rhs4, n=n, p=phase:
                            ops.encoded_matmul(a, r, n=n, phase=p, backend="pallas",
                                               out_dtype=torch.float32), True))
            if m in (16, 512, 2048):
                out.append((f"fused_pack_mmt4d {key}", lambda a=x, r=rhs4:
                            fused_pack_mmt4d.fused_pack_mmt4d(a, r), True))
            out.append((f"matmul {key}", lambda a=x, w=w_t: torch.matmul(a, w.t()), False))
        # int8: the decode GEMV and the packed GEMM beside _int_mm + the
        # epilogue on the same values
        w_q = int8(n, k)
        rhs4_q, s_w = ref.pack(w_q, (128, 128)), scales(n1, 128)
        for m in (1, 4, 8):
            key = f"M={m} K={k} N={n}"
            xq, s_a = int8(m, k), scales(m, 1)
            out.append((f"fused_gemv_q8 {key}", lambda a=xq, r=rhs4_q, sa=s_a, sw=s_w:
                        fused_gemv.fused_gemv_q8(a, r, sa, sw), True))
            xp = torch.nn.functional.pad(xq, (0, 0, 0, 32 - m))
            out.append((f"int_mm {key}", lambda a=xp, w=w_q.t(), sa=s_a, sw=s_w.reshape(-1), m=m:
                        (torch._int_mm(a, w)[:m].float() * sa) * sw, False))
            if sweep:
                for plan in _gemv_plans():
                    out.append((f"fused_gemv_q8 {'/'.join(map(str, plan))} {key}",
                                lambda a=xq, r=rhs4_q, sa=s_a, sw=s_w, p=plan:
                                fused_gemv.fused_gemv_q8(a, r, sa, sw, plan=p), True))
        for m in (16, 20, 256, 2048):
            key = f"M={m} K={k} N={n}"
            m0 = 128 if m == 2048 else 8
            xq, s_a = int8(m, k), scales(m)
            lhs4 = ref.pack(xq, (m0, 128))
            rows = lhs4.shape[0] * m0
            sa2 = torch.nn.functional.pad(s_a, (0, rows - m)).reshape(-1, m0)
            out.append((f"mmt4d_q8 {key}", lambda a=lhs4, r=rhs4_q, sa=sa2, sw=s_w:
                        mmt4d_q8.mmt4d_q8(a, r, sa, sw), True))
            out.append((f"mmt4d_q8_rows {key}", lambda a=xq, r=rhs4_q, sa=s_a, sw=s_w, m0=m0:
                        mmt4d_q8.mmt4d_q8_rows(a, r, sa, sw, m0), True))
            xp = torch.nn.functional.pad(xq, (0, 0, 0, 32 - m)) if m <= 16 else xq
            out.append((f"int_mm {key}", lambda a=xp, w=w_q.t(), sa=s_a, sw=s_w.reshape(-1), m=m:
                        (torch._int_mm(a, w)[:m].float() * sa[:, None]) * sw, False))
        # The w8a8 and w4a8 routes on weights quantized from w_t, bf16 rows.
        q8w = ops.pack_rhs_q8(w_t)
        q4w = {g: ops.pack_rhs_q4(w_t, group=g) for g in (16, 32)}
        for m in (16, 20, 256, 2048):
            key = f"M={m} K={k} N={n}"
            phase = Phase.PREFILL if m == 2048 else Phase.DECODE
            out.append((f"route w8a8 {key}", lambda a=lhs[m], w=q8w, n=n, p=phase:
                        ops.encoded_matmul_q8(a, *w, n=n, phase=p, backend="pallas",
                                              out_dtype=torch.float32), True))
            for group in (16, 32):
                out.append((f"route w4a8 g{group} {key}",
                            lambda a=lhs[m], w=q4w[group], n=n, p=phase, g=group:
                            ops.encoded_matmul_q4(a, *w, n=n, phase=p, group=g,
                                                  backend="pallas", out_dtype=torch.float32),
                            True))
        del q8w, q4w
        # int4: nibbles, bf16 group scales, the same int8 rows
        rhs4_p = torch.randint(0, 256, (n1, k1, 128, 64), generator=gen, device=dev,
                               dtype=torch.uint8)
        for group in (16, 32):
            s_w4 = scales(n1, k1, 128, 128 // group).to(torch.bfloat16)
            for m in (1, 4, 8):
                xq, s_a = int8(m, k), scales(m, 1)
                out.append((f"fused_gemv_q4 g{group} M={m} K={k} N={n}",
                            lambda a=xq, r=rhs4_p, sa=s_a, sw=s_w4, g=group:
                            mmt4d_q4.fused_gemv_q4(a, r, sa, sw, g), True))
                if sweep:
                    for plan in _gemv_plans():
                        out.append((f"fused_gemv_q4 {'/'.join(map(str, plan))} g{group} M={m} "
                                    f"K={k} N={n}", lambda a=xq, r=rhs4_p, sa=s_a, sw=s_w4,
                                    g=group, p=plan:
                                    mmt4d_q4.fused_gemv_q4(a, r, sa, sw, g, plan=p), True))
            for m in (16, 20, 256, 2048):
                key = f"g{group} M={m} K={k} N={n}"
                m0 = 128 if m == 2048 else 8
                xq = int8(m, k)
                lhs4 = ref.pack(xq, (m0, 128))
                sa2 = scales(lhs4.shape[0], m0)
                out.append((f"mmt4d_q4 {key}", lambda a=lhs4, r=rhs4_p, sa=sa2, sw=s_w4, g=group:
                            mmt4d_q4.mmt4d_q4(a, r, sa, sw, g), True))
                out.append((f"mmt4d_q4_rows {key}",
                            lambda a=xq, r=rhs4_p, sa=sa2.reshape(-1)[:m].contiguous(), sw=s_w4,
                            g=group, m0=m0: mmt4d_q4.mmt4d_q4_rows(a, r, sa, sw, g, m0), True))
                if sweep:
                    for target, plan in _q4_plans(lhs4.shape[0], m0, n1, k1):
                        out.append((f"mmt4d_q4 bn={plan[1]} target={target} splits={plan[2]} "
                                    f"{key}", lambda a=lhs4, r=rhs4_p, sa=sa2, sw=s_w4, g=group,
                                    p=plan: mmt4d_q4.mmt4d_q4(a, r, sa, sw, g, plan=p), True))
        if sweep:
            for m in (64, 128, 256):
                lhs4 = ref.pack(rnd(m, k), (8, 128))
                lhs4_q, sa2 = ref.pack(int8(m, k), (8, 128)), scales(m // 8, 8)
                wide = ("wide",) + fused_pack_mmt4d.gemm_tile_plan(m, n1)
                key = f"M={m} K={k} N={n}"
                out.append((f"mmt4d wide {wide[1]}x{wide[2]} {key}",
                            lambda a=lhs4, r=rhs4, p=wide: mmt4d.mmt4d(a, r, plan=p), True))
                out.append((f"mmt4d_q8 wide {wide[1]}x{wide[2]} {key}",
                            lambda a=lhs4_q, r=rhs4_q, sa=sa2, sw=s_w, p=wide:
                            mmt4d_q8.mmt4d_q8(a, r, sa, sw, plan=p), True))
                for target, plan in _skinny_plans(m // 8, 8, n1, k1):
                    name = f"skinny target={target} splits={plan[2]} {key}"
                    out.append((f"mmt4d {name}",
                                lambda a=lhs4, r=rhs4, p=plan: mmt4d.mmt4d(a, r, plan=p), True))
                    out.append((f"mmt4d_q8 {name}",
                                lambda a=lhs4_q, r=rhs4_q, sa=sa2, sw=s_w, p=plan:
                                mmt4d_q8.mmt4d_q8(a, r, sa, sw, plan=p), True))
            for m in (4, 20):
                m0 = min(m, 8)
                lhs4 = ref.pack(rnd(m, k), (m0, 128))
                lhs4_q = ref.pack(int8(m, k), (m0, 128))
                sa2 = scales(lhs4_q.shape[0], m0)
                for target, plan in _skinny_plans(lhs4.shape[0], m0, n1, k1):
                    name = f"skinny target={target} splits={plan[2]} M={m} K={k} N={n}"
                    out.append((f"mmt4d {name}",
                                lambda a=lhs4, r=rhs4, p=plan: mmt4d.mmt4d(a, r, plan=p), True))
                    out.append((f"mmt4d_q8 {name}",
                                lambda a=lhs4_q, r=rhs4_q, sa=sa2, sw=s_w, p=plan:
                                mmt4d_q8.mmt4d_q8(a, r, sa, sw, plan=p), True))
    # batch_mmt4d at chip_smoke.py's phase-2 shapes, beside einsum
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for label, (b, m1, n1, k1, m0, n0, k0) in (("scores", (128, 8, 8, 1, 16, 16, 64)),
                                                   ("context", (128, 8, 4, 2, 16, 16, 64)),
                                                   ("tile64", (32, 2, 2, 2, 64, 64, 64))):
            lhs = torch.randn((b, m1, k1, m0, k0), generator=gen, device=dev).to(dtype)
            rhs = torch.randn((b, n1, k1, n0, k0), generator=gen, device=dev).to(dtype)
            out.append((f"batch_mmt4d {dname} {label}", lambda a=lhs, r=rhs:
                        batch_mmt4d.batch_mmt4d(a, r), True))
            out.append((f"einsum {dname} {label}", lambda a=lhs, r=rhs:
                        torch.einsum("zmkac,znkbc->zmnab", a, r), False))
    return out


def _host_us(fn, calls: int = 50) -> float:
    """Host microseconds a call over `calls` back-to-back calls, the device
    not waited for inside the window."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--match", default="",
                    help="time only the cases whose name starts with one of these "
                         "comma-separated prefixes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_packed needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    rows = {}
    prefixes = tuple(p for p in args.match.split(",") if p)
    for name, fn, checked in cases(dev, gen, args.sweep):
        if prefixes and not name.startswith(prefixes):
            continue
        try:
            for _ in range(3):
                fn()
        except (ValueError, AttributeError, TypeError) as e:  # another tree's kernel that
            # does not take this shape or plan, or has no such entry
            print(f"[bench] {args.label:8s} {name:58s} refused: {e}", flush=True)
            continue
        ev = [_event_ms(fn, flush, 10) for _ in range(args.reps)]
        kern = [_kernel_ms(fn, flush) for _ in range(args.reps)]
        warm = [_event_ms(fn, None, 20) for _ in range(args.reps)]
        host = [_host_us(fn) for _ in range(args.reps)]
        kern = [x for x in kern if x is not None]
        r = rows[name] = dict(event_ms=statistics.median(ev),
                              kernel_ms=statistics.median(kern) if kern else None,
                              warm_ms=statistics.median(warm), host_us=statistics.median(host))
        if checked:
            r["checksum"] = checksum(fn())
        km = "not measured" if r["kernel_ms"] is None else f"{r['kernel_ms']:.4f}"
        print(f"[bench] {args.label:8s} {name:58s} event {r['event_ms']:.4f}  kernel {km}  "
              f"warm {r['warm_ms']:.4f} ms  host {r['host_us']:.1f} us  "
              f"{r.get('checksum', '')}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = dict(label=args.label, card=card.strip(), rows=rows)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"bench_packed-{args.label}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(dict(label=args.label, card=out["card"])))
    return out


if __name__ == "__main__":
    main()
