"""Training CLI of the port (counterpart of repro/launch/train.py): trains a
random-weight model of the registry for N steps on SyntheticPacked data,
with checkpoints, restart from the latest one, the straggler watchdog and
optional int8 gradient compression.

  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --full --layers 2 --steps 20

The reduced config is the default (--full for the real widths); --layers N
and --d-model D cut it.  It runs on the card by default and raises without
CUDA; --device cpu runs on the CPU.  --dtype bfloat16 | float32 overrides
the config's.  The projections run on the plain "xla" (packed layout) or
"reference" route: the hand-written kernels are forward-only, so a train
step refuses them (train/trainer.py).  With --ckpt-dir, a checkpoint is
written every --ckpt-every steps and at the end, and a run started on a
directory that holds one resumes from its latest step.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import registry
from repro_torch.core.packed import EncodingConfig
from repro_torch.data import pipeline as data_lib
from repro_torch.models import transformer as T
from repro_torch.parallel import compression
from repro_torch.runtime import watchdog as wd_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import trainer as trainer_lib


def build(args) -> tuple:
    """(cfg, enc) from the flags, as JAX's launch/train.build."""
    cfg = registry.get_reduced(args.arch) if args.reduced else registry.get_config(args.arch)
    over = {}
    if args.d_model:
        over.update(d_model=args.d_model, num_heads=max(4, args.d_model // 64),
                    num_kv_heads=max(1, args.d_model // 128), head_dim=64,
                    d_ff=args.d_ff or 4 * args.d_model,
                    rnn_width=args.d_model if cfg.rnn_width else 0)
    if args.layers:
        over["num_layers"] = args.layers
    if args.vocab:
        over["vocab_size"] = args.vocab
    if args.dtype:
        over["dtype"] = args.dtype
    if over:
        cfg = dataclasses.replace(cfg, **over)
    return cfg, EncodingConfig(enabled=not args.no_encoding, backend=args.backend)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--backend", default="xla", choices=["xla", "reference"],
                    help="the projections' route: the plain packed mmt4d ('xla') or the "
                         "plain unpacked matmul ('reference'); the CUDA kernels run the "
                         "forward only and have no backward, so training refuses them")
    ap.add_argument("--no-encoding", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> list[float]:
    args = parse_args(argv)
    device = T.resolve_device(args.device)
    cfg, enc = build(args)
    print(f"[train] arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"params~{cfg.param_count()/1e6:.1f}M backend={args.backend} "
          f"encoding={'on' if enc.enabled else 'off'}")

    opt_cfg = opt_lib.OptimizerConfig(peak_lr=args.lr, warmup_steps=max(5, args.steps // 20),
                                      decay_steps=args.steps)
    params = T.model_init(cfg, enc, seed=args.seed, device=device)
    opt_state = opt_lib.init(params)
    comp_state = compression.init_state(params) if args.compress_grads else None

    start = 0
    if args.ckpt_dir:
        latest = ckpt_lib.latest_step(args.ckpt_dir)
        if latest is not None:
            state = ckpt_lib.restore(args.ckpt_dir, latest, {"params": params, "opt": opt_state},
                                     device=device)
            params, opt_state = state["params"], state["opt"]
            start = latest
            print(f"[train] resumed from step {start}")

    data = data_lib.SyntheticPacked(
        data_lib.DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed))
    step_fn = trainer_lib.make_train_step(cfg, enc, opt_cfg, microbatches=args.microbatches,
                                          compress_grads=args.compress_grads)
    saver = ckpt_lib.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    watchdog = wd_lib.StepWatchdog()

    losses = []
    for step in range(start, args.steps):
        batch = data_lib.to_torch(data.batch(step), device)
        watchdog.step_start()
        params, opt_state, metrics, comp_state = step_fn(params, opt_state, batch, comp_state)
        loss = float(metrics["loss"])  # waits for the step
        watchdog.step_end()
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step={step} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} ewma_s={watchdog.ewma:.3f}")
        if saver and (step + 1) % args.ckpt_every == 0:
            saver.save({"params": params, "opt": opt_state}, step + 1)
    if saver:
        saver.save({"params": params, "opt": opt_state}, args.steps)
        saver.wait()
    if losses:
        print(f"[train] done. first-10 mean={np.mean(losses[:10]):.4f} "
              f"last-10 mean={np.mean(losses[-10:]):.4f}")
    return losses


if __name__ == "__main__":
    main()
