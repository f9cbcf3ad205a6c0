"""Weight bridge: the JAX package's parameter pytree -> the port's params.

    np_params = jax.tree.map(np.asarray, jax_params)
    params = params_from_jax(np_params, cfg, enc, device="cpu")

The JAX model stacks layers along a leading group axis (one group per
repetition of `block_pattern`); the port keeps a list of per-layer dicts,
so every stacked leaf is split along that axis.  bfloat16 arrays move as
raw 16-bit words (`torch.from_numpy` has no bfloat16): the ml_dtypes array
is viewed as uint16, handed to torch, and viewed back as torch.bfloat16, so
every bit survives.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packed import EncodingConfig


def to_torch(a: np.ndarray, device: torch.device | str) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: torch takes ownership
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(node)


def params_from_jax(np_params: dict, cfg: ModelConfig, enc: EncodingConfig,
                    device: torch.device | str) -> dict:
    """Port params from the JAX pytree (leaves as numpy arrays)."""
    if enc.weight_quant != "none":
        raise NotImplementedError(
            "quantized weights wait for the quantized-serving slice (ROADMAP)"
        )
    pattern = tuple(cfg.block_pattern)
    if pattern != ("attn",) or "tail" in np_params:
        raise NotImplementedError(f"block pattern {pattern} waits for its family's slice")
    (group,) = np_params["groups"]  # one block per pattern position
    n_layers = cfg.num_layers
    layers = [_tree(group, lambda a, i=i: to_torch(a[i], device)) for i in range(n_layers)]
    out = {
        "embed": to_torch(np_params["embed"], device),
        "final_norm": _tree(np_params["final_norm"], lambda a: to_torch(a, device)),
        "layers": layers,
    }
    if "head" in np_params:
        out["head"] = _tree(np_params["head"], lambda a: to_torch(a, device))
    return out
