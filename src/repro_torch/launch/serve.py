"""Serving CLI of the port: random-weight Llama-3.2-1B on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b

serves the full-width model on CUDA through the hand-written kernels
(--backend fused, --attn-backend auto).  --reduced serves the CPU smoke-test
size of the same family; --device cpu runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import build
from repro_torch.models import transformer as T
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.config import EngineConfig


def main(argv: list[str] | None = None) -> list[engine_lib.Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the CPU smoke-test size of --arch (f32)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--backend", default="fused",
                    choices=["reference", "xla", "fused", "auto"])
    ap.add_argument("--attn-backend", default="auto", choices=["xla", "pallas", "auto"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="paged pool size; small values force preemption")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="radix-tree prefix cache (--no-prefix-cache disables)")
    args = ap.parse_args(argv)

    config = EngineConfig.from_args(args)
    cfg = registry.get_reduced(args.arch) if args.reduced else registry.get_config(args.arch)
    enc = EncodingConfig(enabled=True, backend=args.backend, attn_backend=args.attn_backend)
    params = T.model_init(cfg, enc, seed=args.seed, device=args.device)
    eng = engine_lib.Engine(params, cfg, enc, config=config, device=args.device)
    if eng.device.type == "cuda":
        build.build_all()  # compile outside the timed run (a no-op once built)

    rng = np.random.RandomState(args.seed)
    t0 = time.perf_counter()
    for i in range(args.requests):
        plen = rng.randint(args.prompt_len // 2, args.prompt_len + 1)
        prompt = rng.randint(1, cfg.vocab_size, size=plen).astype(np.int32)
        eng.submit(engine_lib.Request(uid=i, prompt=prompt, max_new_tokens=args.max_new))
    done = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.generated) for r in done)
    stats = eng.stats_view()
    print(f"[serve] {cfg.name} on {eng.device}: {len(done)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new / dt:.2f} tok/s incl. prefill)")
    print(f"[serve] attn_backend={stats['attn_backend'][0]} "
          f"dispatches={stats['dispatches']} degraded={len(stats['degraded'][0])} "
          f"step p50={stats['watchdog']['p50_ms']:.2f}ms p99={stats['watchdog']['p99_ms']:.2f}ms")
    pc = stats["prefix_cache"]
    print(f"[serve] paged: peak_active={stats['peak_active']} pages={stats['pages_total']} "
          f"peak_in_use={stats['peak_in_use']} preemptions={stats['preemptions']} "
          f"prefix hit_rate={pc['hit_rate']:.3f} hit_tokens={pc['hit_tokens']}")
    for r in done[: min(4, len(done))]:
        print(f"  req {r.uid}: prompt[:4]={r.prompt[:4].tolist()} -> gen[:8]={r.generated[:8]}")
    return done


if __name__ == "__main__":
    main()
