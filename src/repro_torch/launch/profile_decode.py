"""Where a decode (or prefill) step's time goes on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode [--prefill] [--slots N]
      [--arch qwen2-1.5b | --arch mixtral-8x22b --layers 8 --max-seq 8192
       | --arch grok-1-314b --layers 4 | --arch rwkv6-1.6b | --arch recurrentgemma-9b]

Serves --slots (default 4) requests of the full-width bf16 --arch model
(Llama-3.2-1B by default; random weights from --seed; as many slots, max_seq 1024, block 16, the
serving path chip_smoke.py drives), lets prefill and the first decode step
run, then records --steps decode steps under torch.profiler.  With more
slots than the decode GEMV takes rows (8), the projections route by the
registry ("auto", as chip_smoke.py's slots16 run): a 16-slot decode step
runs the packed GEMM (`mmt4d`).  Prints the host wall time per step, the
device busy time per step (sum of kernel durations: one stream, so kernels
do not overlap), the idle share, kernel launches per step, and device time
by kernel name.  Writes the table to chiprun_out/profile_decode.json.
--quant w8a8 | w4a8 (with --quant-group) profiles int8 or int4 weights;
--kv-quant kv8 | kv4 profiles a quantized KV pool (quantize-on-write and the
decode kernel's int8 / nibble path); --sample temperature samples every
request at --temperature (the sampler's elementwise ops and the copy of the
temperatures join each step).  --prefill profiles the step that admits
--slots (four) fresh --prompt-len (default 512) prompts instead: one
batched 4 x 512 = 2048-row prefill (and the first decode of the four
slots), --steps times, each after the previous requests have drained (a
warm-up batch runs first, outside the profile); it writes
chiprun_out/profile_prefill.json.  --layers N cuts the depth to N layers at
full width (Mixtral-8x22B's 56 layers and Grok-1-314B's 64 do not fit one
card in bf16; the output names the cut; the recurrent families decode
grouped on the dense cache, one dispatch per group of slots at a position); --max-seq sets the engine's max_seq (1024 by
default; a windowed model's ring holds min(max_seq, window) slots).
--mesh-shape N profiles N-way tensor-parallel serving: the ranks start as
launch/serve.py starts them (NCCL with a card each, gloo where they share
one), every rank runs the same steps on its shard, and rank 0 profiles its
own; the output adds the host ops that took the most self time.  MoE too:
`--arch mixtral-8x22b --mesh-shape 4 --quant w8a8 --max-seq 8192` profiles
Mixtral at full depth on four cards.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import itertools
import json
import math
import os
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import encoding
from repro_torch.core.packed import QUANT_KEYS, EncodingConfig
from repro_torch.kernels import build
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.config import EngineConfig


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="tokens a prompt (default 300; 512 with --prefill)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (full width)")
    ap.add_argument("--max-seq", dest="max_seq", type=int, default=1024)
    ap.add_argument("--prefill", action="store_true",
                    help="profile the step that runs a batched prefill")
    ap.add_argument("--out", default=None)
    ap.add_argument("--quant", default="none", choices=sorted(QUANT_KEYS.values()))
    ap.add_argument("--quant-group", dest="quant_group", type=int, default=16)
    ap.add_argument("--kv-quant", dest="kv_quant", default="bf16", choices=encoding.KV_QUANTS)
    ap.add_argument("--sample", default="greedy", choices=["greedy", "temperature"])
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--mesh-shape", dest="mesh_shape", default="1",
                    help="tensor-parallel degree N: N ranks, rank 0 profiles")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = _parser().parse_args(argv)
    ranks = math.prod(EngineConfig.from_args(args).mesh_shape)
    if ranks == 1:
        return _profile(args, "cuda", 0)
    build.build_all()  # once, before the ranks start
    return mesh_lib.launch_ranks(_profile_rank, ranks, argv, device="cuda")[0]


def _profile_rank(rank: int, world: int, device: str, argv) -> dict:
    del world
    return _profile(_parser().parse_args(argv), device, rank)


def _profile(args, device: str, rank: int) -> dict:
    config = EngineConfig.from_args(args)
    prompt_len = args.prompt_len or (512 if args.prefill else 300)
    kind = "prefill" if args.prefill else "decode"
    out_path = args.out or f"chiprun_out/profile_{kind}.json"

    dev = T.resolve_device(device)
    cfg = registry.get_config(args.arch)
    depth = cfg.num_layers
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    weight_quant = {v: k for k, v in QUANT_KEYS.items()}[args.quant]
    backend = "fused" if args.slots <= encoding.GEMV_MAX_ROWS else "auto"
    enc = EncodingConfig(backend=backend, attn_backend="auto", weight_quant=weight_quant,
                         quant_group=args.quant_group)
    shard = (sharding.plan(cfg, enc, config.tp_shards, rank) if config.tp_shards > 1
             else None)
    params = T.model_init(cfg, enc, seed=args.seed, device=dev, shard=shard)
    eng = engine_lib.Engine(params, cfg, enc,
                            config=EngineConfig(slots=args.slots, max_seq=args.max_seq,
                                                block_size=16, kv_quant=args.kv_quant,
                                                sample=args.sample,
                                                mesh_shape=config.mesh_shape),
                            device=dev)
    rng = np.random.RandomState(args.seed)
    uid = itertools.count()

    def submit(max_new):  # one fresh prompt a slot: no prefix-cache hits
        for _ in range(args.slots):
            prompt = rng.randint(1, cfg.vocab_size, prompt_len).astype(np.int32)
            eng.submit(engine_lib.Request(uid=next(uid), prompt=prompt, max_new_tokens=max_new,
                                          temperature=args.temperature))

    by_name: dict[str, list[float]] = collections.defaultdict(lambda: [0.0, 0])
    host_ops: collections.Counter[str] = collections.Counter()
    wall = 0.0

    def profiled(n_steps: int) -> None:
        """Run n_steps steps under the profiler (rank 0; the other ranks of
        a mesh run the same steps unprofiled); add their host time, their
        device kernels and their host ops' self time to the totals."""
        nonlocal wall
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with (contextlib.nullcontext() if rank
              else torch.profiler.profile(activities=acts)) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                eng.step()
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
        if rank:
            return
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                row = by_name[e.name]
                row[0] += e.time_range.elapsed_us() / 1e3
                row[1] += 1
        for a in prof.key_averages():
            host_ops[a.key] += a.self_cpu_time_total / 1e3

    if args.prefill:
        for i in range(args.steps + 1):  # the first batch warms up, unprofiled
            submit(max_new=2)
            if i:
                profiled(1)
            eng.run()  # drain, outside the window
            torch.cuda.synchronize()
    else:
        submit(max_new=args.steps + 4)
        for _ in range(3):  # prefill + first decode steps, outside the window
            eng.step()
        torch.cuda.synchronize()
        profiled(args.steps)
    busy = sum(v[0] for v in by_name.values())
    launches = sum(v[1] for v in by_name.values())
    step_ms = 1e3 * wall / args.steps
    busy_ms = busy / args.steps
    if rank:
        return {}
    out = {
        "card": torch.cuda.get_device_name(0),
        "mesh_shape": list(config.mesh_shape),
        "arch": args.arch,
        "layers": cfg.num_layers,
        "reduced": ([] if cfg.num_layers == depth
                    else [f"depth cut to {cfg.num_layers} of {depth} layers, full width"]),
        "max_seq": args.max_seq,
        "decode_weight_stream_bytes": sum(T.decode_weight_stream_bytes(cfg, enc).values()),
        "cache_mode": eng.cache_mode,
        "step_kind": kind,
        "prompt_len": prompt_len,
        "quant": args.quant,
        "kv_quant": args.kv_quant,
        "sample": args.sample,
        "slots": args.slots,
        "steps": args.steps,
        "host_ms_per_step": step_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms if step_ms else None,
        "kernel_launches_per_step": launches / args.steps,
        "kernels": sorted(
            ({"name": k, "ms_per_step": v[0] / args.steps, "count_per_step": v[1] / args.steps}
             for k, v in by_name.items()),
            key=lambda r: -r["ms_per_step"],
        ),
        "host_self_ms_per_step": {k: v / args.steps for k, v in host_ops.most_common(15)},
    }
    for cut in out["reduced"]:
        print(f"[profile] reduced: {cut}")
    print(f"[profile] {out['card']} {args.arch} ({args.quant}, {args.kv_quant}, {args.sample}, "
          f"{args.slots} slots, mesh {'x'.join(map(str, config.mesh_shape))}): "
          f"{args.steps} {kind} steps, host {step_ms:.3f} ms/step, "
          f"device busy {busy_ms:.3f} ms/step, idle share {out['device_idle_share']:.3f}, "
          f"{out['kernel_launches_per_step']:.0f} kernel launches/step")
    if not by_name:
        print("[profile] the profiler recorded no device activity")
    for r in out["kernels"][:15]:
        print(f"[profile] {r['ms_per_step']:8.4f} ms/step  x{r['count_per_step']:6.1f}  {r['name'][:90]}")
    for name, ms in out["host_self_ms_per_step"].items():
        print(f"[profile] host self {ms:8.3f} ms/step  {name[:90]}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
