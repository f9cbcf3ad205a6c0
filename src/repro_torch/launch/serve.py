"""Serving CLI of the port: a random-weight model of the registry on the card
(Llama-3.2-1B by default; --arch qwen2-1.5b, qwen2.5-14b, qwen2.5-32b, yi-9b,
mixtral-8x22b, grok-1-314b, rwkv6-1.6b or recurrentgemma-9b).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b

serves the full-width model on CUDA through the hand-written kernels
(--backend fused, --attn-backend auto).  --reduced serves the CPU smoke-test
size of the same family; --device cpu runs the kernels' plain versions.
--spec-decode (with --draft-k) verifies prompt-lookup drafts in one window
dispatch per step; --token-budget N runs every step as one mixed
chunked-prefill + decode dispatch of at most N tokens, with --slo-class
naming the requests' class; --backend pallas routes every projection
through the packed mmt4d kernels.  --quant w8a8 | w4a8 serves int8 weights
(per output channel) or int4 weights (one bf16 scale per --quant-group K
elements, 16 by default, 32 the llama.cpp Q4_0 block) through the quantized
kernels; the run prints the weight bytes each decode step streams.
--kv-quant kv8 | kv4 stores the paged KV pool as int8 or packed int4 with
float32 scale pages (the run prints the pool bytes per cached token);
--cache-mode dense serves from the dense (slots, max_seq) cache through the
dense decode kernel, and --decode-mode grouped decodes one group of slots at
the same position per dispatch (on the dense cache).  --sample temperature
samples every request at --temperature (0.8 by default; 0 keeps a request
greedy) with JAX's Threefry-2x32 noise from --seed; it switches spec decode
and the token budget off, as in the JAX engine.  --layers N cuts the depth
to N layers at full width (the run reports the cut): Mixtral-8x22B's 56
layers hold 282 GB of bf16 weights, so one card serves it at depth 8, e.g.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
      --layers 8 --max-seq 8192 --prompt-len 4500

Mixtral has a 4096-token sliding window: it serves on the dense ring cache
(min(max_seq, window) slots), and prompts may be longer than the window.
Grok-1-314B (MoE, no window) serves on the paged cache; its 64 layers hold
~620 GB of bf16 weights, so one card serves it at --layers 4.  RWKV6-1.6B
and RecurrentGemma-9B (recurrent state; RecurrentGemma's local attention
has a 2048-token window and head dim 256) serve on the dense cache with
grouped decode, one prefill per admission; the run prints the state bytes
a slot holds.  Whisper-tiny and InternVL2-26B take frames or patches beside
their tokens, which the engine (token batches only, as the JAX engine) does
not: --arch whisper-tiny or internvl2-26b exits with the engine's refusal,
and those models run through models/transformer.greedy_generate (README).

--mesh-shape N serves N-way tensor parallel (as in the JAX CLI: "2", or
"2x4" for 2 replicas of 4-way TP): the CLI starts the N ranks itself
(launch/mesh.launch_ranks: spawn, one process a rank, NCCL with a card
each, gloo on the CPU or where the ranks share one card), builds the
kernels once before they start, and each rank makes only its shard of the
weights; rank 0 prints.  A rehearsal on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --arch qwen2-1.5b --mesh-shape 2

Tensor parallelism serves the attention-only token families (Llama,
Qwen2/2.5, Yi) and MoE (Mixtral, Grok: each rank every expert's FFN
columns and the whole router); the recurrent families exit with the
engine's refusal at N > 1.  Mixtral-8x22B at full depth in w8a8 on four
cards (~141 GB of weights, a quarter a card; each rank draws and slices one
expert projection at a time):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
      --mesh-shape 4 --quant w8a8 --max-seq 8192
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import encoding
from repro_torch.core.packed import QUANT_KEYS, EncodingConfig
from repro_torch.kernels import build
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.config import EngineConfig


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the CPU smoke-test size of --arch (f32)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (full width; reported as a cut)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--backend", default="fused",
                    choices=["reference", "xla", "fused", "pallas", "auto"])
    ap.add_argument("--attn-backend", default="auto", choices=["xla", "pallas", "auto"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="paged pool size; small values force preemption")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="radix-tree prefix cache (--no-prefix-cache disables)")
    ap.add_argument("--spec-decode", dest="spec_decode", action="store_true",
                    help="speculative decode with the prompt-lookup drafter")
    ap.add_argument("--draft-k", dest="draft_k", type=int, default=4)
    ap.add_argument("--token-budget", dest="token_budget", type=int, default=None,
                    help="tokens per mixed chunked-prefill + decode step")
    ap.add_argument("--slo-class", dest="slo_class", default="standard",
                    choices=["interactive", "standard", "batch"],
                    help="SLO class of the requests (token-budget admission order)")
    ap.add_argument("--quant", default="none", choices=sorted(QUANT_KEYS.values()),
                    help="weight format: w8a8 = int8 per output channel, w4a8 = group int4")
    ap.add_argument("--quant-group", dest="quant_group", type=int, default=16,
                    help="w4a8 K elements per scale (16 default; 32 = llama.cpp Q4_0)")
    ap.add_argument("--kv-quant", dest="kv_quant", default="bf16", choices=encoding.KV_QUANTS,
                    help="paged KV pool layout: bf16 (activation dtype), kv8, kv4")
    ap.add_argument("--cache-mode", dest="cache_mode", default="paged",
                    choices=["paged", "dense"], help="KV cache: page pool or dense rows")
    ap.add_argument("--decode-mode", dest="decode_mode", default="vectorized",
                    choices=["vectorized", "grouped"],
                    help="one decode dispatch per step, or one per position group")
    ap.add_argument("--sample", default="greedy", choices=["greedy", "temperature"],
                    help="temperature: per-request temperature sampling (a key per "
                         "decode dispatch; disables --spec-decode and --token-budget)")
    ap.add_argument("--temperature", type=float, default=0.8,
                    help="per-request sampling temperature (--sample temperature)")
    ap.add_argument("--mesh-shape", dest="mesh_shape", default="1",
                    help='serving mesh: "2" = 2-way tensor parallel, "2x4" = 2 replicas x '
                         "4-way; the CLI starts that many ranks")
    return ap


def main(argv: list[str] | None = None) -> list[engine_lib.Request]:
    args = _parser().parse_args(argv)
    config = EngineConfig.from_args(args)
    cfg = registry.get_reduced(args.arch) if args.reduced else registry.get_config(args.arch)
    try:
        engine_lib.check_servable(cfg)
        sharding.check_servable(cfg, config.tp_shards)
    except NotImplementedError as err:
        raise SystemExit(f"[serve] --arch {args.arch}: {err}") from None
    ranks = math.prod(config.mesh_shape)
    if ranks == 1:
        return _serve(args, args.device, verbose=True)
    if torch.device(args.device).type == "cuda":
        build.build_all()  # once, before the ranks start: they would race in one build dir
    return mesh_lib.launch_ranks(_serve_rank, ranks, argv, device=args.device)[0]


def _serve_rank(rank: int, world: int, device: str, argv) -> list[engine_lib.Request]:
    """One rank of `main`: the same requests on every rank, rank 0 prints."""
    del world
    return _serve(_parser().parse_args(argv), device, verbose=rank == 0)


def _serve(args, device: str, *, verbose: bool) -> list[engine_lib.Request]:
    config = EngineConfig.from_args(args)
    cfg = registry.get_reduced(args.arch) if args.reduced else registry.get_config(args.arch)
    depth = cfg.num_layers
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    weight_quant = {v: k for k, v in QUANT_KEYS.items()}[args.quant]
    enc = EncodingConfig(enabled=True, backend=args.backend, attn_backend=args.attn_backend,
                         weight_quant=weight_quant, quant_group=args.quant_group)
    shard = None
    if config.tp_shards > 1:  # make only this rank's part of the weights
        shard = sharding.plan(cfg, enc, config.tp_shards,
                              torch.distributed.get_rank() % config.tp_shards)
    params = T.model_init(cfg, enc, seed=args.seed, device=device, shard=shard)
    eng = engine_lib.Engine(params, cfg, enc, config=config, device=device)
    if eng.device.type == "cuda":
        build.build_all()  # compile outside the timed run (a no-op once built)
    say = print if verbose else (lambda *a, **k: None)

    rng = np.random.RandomState(args.seed)
    t0 = time.perf_counter()
    for i in range(args.requests):
        plen = rng.randint(args.prompt_len // 2, args.prompt_len + 1)
        prompt = rng.randint(1, cfg.vocab_size, size=plen).astype(np.int32)
        eng.submit(engine_lib.Request(uid=i, prompt=prompt, max_new_tokens=args.max_new,
                                      slo_class=args.slo_class,
                                      temperature=args.temperature))
    done = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.generated) for r in done)
    stats = eng.stats_view()  # every rank: at tp > 1 it gathers the ranks' page counters
    if cfg.num_layers != depth:
        say(f"[serve] reduced: depth cut to {cfg.num_layers} of {depth} layers, full width")
    say(f"[serve] {cfg.name} on {eng.device}: {len(done)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new / dt:.2f} tok/s incl. prefill)")
    if eng.tp_shards > 1:
        loc = eng.model_cfg
        say(f"[serve] tensor parallel: {eng.tp_shards} ranks (mesh "
              f"{'x'.join(map(str, config.mesh_shape))}, {eng.mesh.backend}); rank 0 holds "
              f"{loc.num_heads} query and {loc.num_kv_heads} kv heads, {loc.d_ff} FFN columns"
              f"{f' of each of {loc.num_experts} experts' if loc.num_experts else ''}, "
              f"{eng.shard.vocab_rows} vocabulary rows; whole-head replications "
              f"{list(eng.shard.replicated)}; collectives {dict(collectives.counts)}")
    say(f"[serve] attn_backend={stats['attn_backend'][0]} "
          f"dispatches={stats['dispatches']} degraded={len(stats['degraded'][0])} "
          f"step p50={stats['watchdog']['p50_ms']:.2f}ms p99={stats['watchdog']['p99_ms']:.2f}ms")
    itemsize = torch.empty((), dtype=cfg.activation_dtype).element_size()
    kv_bytes = encoding.kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                                           itemsize=itemsize, kv_quant=stats["kv_quant"])
    say(f"[serve] cache={stats['cache_mode']} decode={stats['decode_mode']} "
          f"kv={stats['kv_quant']} ({kv_bytes} bytes per cached token) sample={stats['sample']} "
          f"downgrades={stats.get('config_downgrades', [])}")
    if not T.attention_only(cfg):
        say(f"[serve] cache bytes a slot (K/V rows and recurrent state): "
              f"{T.cache_bytes(eng.caches) // eng.slots}")
    wb = T.decode_weight_stream_bytes(cfg, enc)
    say(f"[serve] weights streamed per decode step ({args.quant}): projections "
          f"{wb['projections'] / 1e6:.1f} MB + head {wb['head'] / 1e6:.1f} MB = "
          f"{sum(wb.values()) / 1e6:.1f} MB")
    if stats["cache_mode"] == "paged":
        pc = stats["prefix_cache"]
        say(f"[serve] paged: peak_active={stats['peak_active']} pages={stats['pages_total']} "
              f"peak_in_use={stats['peak_in_use']} preemptions={stats['preemptions']} "
              f"prefix hit_rate={pc['hit_rate']:.3f} hit_tokens={pc['hit_tokens']}")
    if "spec" in stats:
        sp = stats["spec"]
        say(f"[serve] spec: proposed={sp['proposed']} accepted={sp['accepted']} "
              f"acceptance={sp['acceptance_rate']:.3f} "
              f"mean_accepted_len={sp['mean_accepted_len']:.3f}")
    if "continuous" in stats:
        say(f"[serve] token budget: {stats['continuous']}")
    for r in done[: min(4, len(done))]:
        say(f"  req {r.uid}: prompt[:4]={r.prompt[:4].tolist()} -> gen[:8]={r.generated[:8]}")
    return done


if __name__ == "__main__":
    main()
