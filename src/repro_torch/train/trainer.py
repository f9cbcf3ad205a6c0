"""train_step: loss -> gradients -> (optional compression) -> AdamW
(counterpart of repro/train/trainer.py).

Gradients come from torch.autograd.grad over the parameter leaves, which
the step never mutates: it returns new trees, as the JAX step does.
Microbatches run one after another (JAX's lax.scan over batch slices), their
gradients summed in f32 and divided by their count, so the activation peak
is one microbatch's.

Training runs on the plain projections only.  A projection that reaches a
hand-written kernel (backend "pallas", "fused" or "auto", or int8/int4
weights) is a ctypes launch with no backward, so make_train_step refuses
such an encoding, as JAX cannot take jax.grad through a pallas_call.
Attention never takes a kernel under Phase.TRAIN (models/layers.py).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree
from repro_torch.core.packed import EncodingConfig
from repro_torch.models import transformer as T
from repro_torch.parallel import compression
from repro_torch.train import optimizer as opt_lib

KERNEL_BACKENDS = ("pallas", "fused", "auto")


def check_trainable(enc: EncodingConfig) -> None:
    """Raise ValueError where `enc` would route a projection to a kernel."""
    if enc.backend in KERNEL_BACKENDS:
        raise ValueError(
            f"training needs the plain projections: backend {enc.backend!r} launches the "
            "hand-written CUDA kernels, which have no backward (a ctypes launch is opaque "
            "to autograd); use backend='xla' or 'reference'")
    if enc.weight_quant != "none":
        raise ValueError(
            f"training needs unquantized weights: weight_quant {enc.weight_quant!r} runs "
            "integer codes through the quantized kernels and has no gradient")


def value_and_grad(params, batch: dict, cfg: ModelConfig, enc: EncodingConfig):
    """(loss, metrics, grads) of transformer.loss_fn: grads in the params'
    tree and dtypes; a leaf the loss does not reach gets zeros, as jax.grad
    gives."""
    pairs = tree.leaves_with_path(params)
    live = [p.detach().requires_grad_(True) for _, p in pairs]
    loss, metrics = T.loss_fn(tree.unflatten(params, live), batch, cfg=cfg, enc=enc)
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree.unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, enc: EncodingConfig, opt_cfg: opt_lib.OptimizerConfig,
                    *, microbatches: int = 1, compress_grads: bool = False):
    """Returns train_step(params, opt_state, batch, compress_state=None) ->
    (new_params, new_opt_state, metrics, new_compress_state); metrics hold
    f32 scalar tensors "loss", "nll", "aux" (each averaged over the
    microbatches), "lr" and "grad_norm".  `batch` is a dict of tensors on the
    params' device (data/pipeline.to_torch)."""
    check_trainable(enc)
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def train_step(params, opt_state, batch: dict, compress_state=None):
        if microbatches > 1:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} is not a multiple of microbatches {microbatches}")
            mb = b // microbatches
            gsum = loss = metrics = None
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l_i, m_i, g_i = value_and_grad(params, part, cfg, enc)
                g_i = [g.float() for g in tree.leaves(g_i)]
                if gsum is None:
                    gsum, loss, metrics = g_i, l_i, m_i
                else:
                    gsum = [a + g for a, g in zip(gsum, g_i)]
                    loss = loss + l_i
                    metrics = {k: metrics[k] + m_i[k] for k in metrics}
            grads = tree.unflatten(params, [g / microbatches for g in gsum])
            loss = loss / microbatches
            metrics = {k: v / microbatches for k, v in metrics.items()}
        else:
            loss, metrics, grads = value_and_grad(params, batch, cfg, enc)

        new_compress_state = compress_state
        if compress_grads and compress_state is not None:
            grads, new_compress_state = compression.compress_decompress(grads, compress_state)
        new_params, new_opt, om = opt_lib.apply_updates(params, grads, opt_state, opt_cfg)
        return new_params, new_opt, {"loss": loss, **metrics, **om}, new_compress_state

    return train_step


def make_eval_step(cfg: ModelConfig, enc: EncodingConfig):
    """Returns eval_step(params, batch) -> {"loss", "nll", "aux"}, without
    autograd."""
    def eval_step(params, batch: dict) -> dict:
        with torch.no_grad():
            loss, metrics = T.loss_fn(params, batch, cfg=cfg, enc=enc)
        return {"loss": loss, **metrics}

    return eval_step
