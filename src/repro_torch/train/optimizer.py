"""AdamW with global-norm clipping and a warmup + cosine schedule
(counterpart of repro/train/optimizer.py), as plain functions over the
port's parameter trees.

Not torch.optim.AdamW: that one applies its bias correction in another
order, puts eps elsewhere and scales the decoupled decay differently.  Here
every leaf follows the JAX package's arithmetic operation for operation in
f32, and the new value is cast back to the leaf's dtype.  Weight decay
applies only to matmul weights (packed or plain, the embedding, an MoE
expert's); the packed layout's zero padding stays exactly zero (its
gradient is zero and decay multiplies zero).  The moments are f32 by
default, bf16 with moment_dtype="bfloat16"; `step` is a 0-dim int32 tensor
on the params' device, so a step never waits for the host.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import tree

# The last dict key of a matmul weight's path (an MoE expert's leaf sits
# under moe["w_gate"][j]["w_packed"]; JAX's under moe["w_gate"]["w_packed"]).
MATRIX_KEYS = ("w_packed", "w_t", "embed", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # or "bfloat16"


def is_matrix(path: tuple) -> bool:
    """Whether weight decay applies to the leaf at `path`: its last dict
    key names a matmul weight."""
    last = next((k for k in reversed(path) if isinstance(k, str)), "")
    return last in MATRIX_KEYS


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The f32 learning rate at `step` (an int32 tensor): linear warmup to
    peak_lr, then a cosine down to min_lr at decay_steps."""
    warm = cfg.peak_lr * (step + 1) / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params, cfg: OptimizerConfig | None = None) -> dict:
    """Zero moments of every leaf's shape, in cfg.moment_dtype (f32 without
    a cfg), and step 0."""
    mdt = getattr(torch, cfg.moment_dtype) if cfg else torch.float32
    leaves = tree.leaves(params)
    device = leaves[0].device

    def zeros(p):
        return tree.tree_map(lambda x: torch.zeros(x.shape, dtype=mdt, device=x.device), p)

    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.float())) for g in tree.leaves(grads)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def apply_updates(params, grads, state: dict, cfg: OptimizerConfig):
    """One AdamW step.  Returns (new_params, new_state, {"lr", "grad_norm"})."""
    step = state["step"]
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** (step.float() + 1)
    bc2 = 1 - b2 ** (step.float() + 1)

    new_p, new_mu, new_nu = [], [], []
    for (path, p), g, mu, nu in zip(tree.leaves_with_path(params), tree.leaves(grads),
                                    tree.leaves(state["mu"]), tree.leaves(state["nu"])):
        g = g.float() * scale
        mu_n = b1 * mu.float() + (1 - b1) * g
        nu_n = b2 * nu.float() + (1 - b2) * torch.square(g)
        step_dir = (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + cfg.eps)
        wd = cfg.weight_decay if is_matrix(path) else 0.0
        pf = p.float()
        new_p.append((pf - lr * (step_dir + wd * pf)).to(p.dtype))
        new_mu.append(mu_n.to(mu.dtype))
        new_nu.append(nu_n.to(nu.dtype))
    new_state = {"mu": tree.unflatten(params, new_mu), "nu": tree.unflatten(params, new_nu),
                 "step": step + 1}
    return tree.unflatten(params, new_p), new_state, {"lr": lr, "grad_norm": gnorm}
