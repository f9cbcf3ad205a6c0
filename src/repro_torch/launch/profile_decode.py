"""Where a decode step's time goes on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode

Serves four requests of the full-width bf16 Llama-3.2-1B (random weights from
--seed; 4 slots, max_seq 1024, block 16, the serving path chip_smoke.py
drives), lets prefill and the first decode step run, then records --steps
decode steps under torch.profiler.  Prints the host wall time per step, the
device busy time per step (sum of kernel durations: one stream, so kernels
do not overlap), the idle share, kernel launches per step, and device time
by kernel name.  Writes the table to chiprun_out/profile_decode.json.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.packed import EncodingConfig
from repro_torch.models import transformer as T
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.config import EngineConfig


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, default=300)
    ap.add_argument("--out", default="chiprun_out/profile_decode.json")
    args = ap.parse_args(argv)

    dev = T.resolve_device("cuda")
    cfg = registry.get_config("llama3.2-1b")
    enc = EncodingConfig(backend="fused", attn_backend="auto")
    params = T.model_init(cfg, enc, seed=args.seed, device=dev)
    eng = engine_lib.Engine(params, cfg, enc,
                            config=EngineConfig(slots=4, max_seq=1024, block_size=16),
                            device=dev)
    rng = np.random.RandomState(args.seed)
    for i in range(4):
        prompt = rng.randint(1, cfg.vocab_size, args.prompt_len).astype(np.int32)
        eng.submit(engine_lib.Request(uid=i, prompt=prompt, max_new_tokens=args.steps + 4))
    for _ in range(3):  # prefill + first decode steps, outside the window
        eng.step()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    by_name: dict[str, list[float]] = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = by_name[e.name]
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    busy = sum(v[0] for v in by_name.values())
    launches = sum(v[1] for v in by_name.values())
    step_ms = 1e3 * wall / args.steps
    busy_ms = busy / args.steps
    out = {
        "card": torch.cuda.get_device_name(0),
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
    }
    print(f"[profile] {out['card']}: {args.steps} decode steps, host {step_ms:.3f} ms/step, "
          f"device busy {busy_ms:.3f} ms/step, idle share {out['device_idle_share']:.3f}, "
          f"{out['kernel_launches_per_step']:.0f} kernel launches/step")
    if not by_name:
        print("[profile] the profiler recorded no device activity")
    for r in out["kernels"][:15]:
        print(f"[profile] {r['ms_per_step']:8.4f} ms/step  x{r['count_per_step']:6.1f}  {r['name'][:90]}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
