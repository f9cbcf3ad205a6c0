"""Weight bridge: the JAX package's parameter pytree -> the port's params.

    np_params = jax.tree.map(np.asarray, jax_params)
    params = params_from_jax(np_params, cfg, enc, device="cpu")

The JAX model stacks layers along a leading group axis: params["groups"]
holds one tree per position of `block_pattern`, each stacked over the
repetitions of the pattern, and params["tail"] (where num_layers is not a
multiple of the pattern) one unstacked tree per position of the partial
group.  The port keeps a list of per-layer dicts in layer order: position
i of group g is layer g * len(pattern) + i, and the tail follows, so every
stacked leaf is split along its group axis.  Recurrent blocks' leaves
(mu, w0, w_lora_*, u, cm_mu, conv_w, conv_b, lam) carry over as they are.  bfloat16 arrays move as
raw 16-bit words (`torch.from_numpy` has no bfloat16): the ml_dtypes array
is viewed as uint16, handed to torch, and viewed back as torch.bfloat16, so
every bit survives.  Quantized projections (`enc.weight_quant` "int8" or
"int4") carry their leaves as they are: w_q (int8), w_scale (f32), w_q4
(uint8 nibbles) and w_scale4 (bf16), bit for bit, so the port serves the
JAX package's quantized weights, not a requantization of its own.

An MoE layer's experts are stacked once more in JAX, (layers, E, ...) on
every leaf of w_gate, w_up and w_down; the port keeps a list of E
per-expert projections, each leaf split along that axis as it is (packed
layouts are never repacked).  The router is one projection per layer.

An enc-dec model's encoder is one more stacked group, params["enc_layers"]
(a 1-tuple: the pattern ("enc_attn",) over encoder_layers), split into the
port's list; enc_final_norm, dec_pos_embed and a VLM's projector carry over
as they are.

Any tree of the params' structure comes across the same way: gradients
through params_from_jax, and the optimizer state through
opt_state_from_jax (its mu and nu are two such trees; step is kept).
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


# The weight leaf of a projection in each weight format.
_WEIGHT_KEY = {"none": "w_packed", "int8": "w_q", "int4": "w_q4"}


def _keys(node) -> set:
    if not isinstance(node, dict):
        return set()
    return set(node).union(*(_keys(v) for v in node.values()))


def params_from_jax(np_params: dict, cfg: ModelConfig, enc: EncodingConfig,
                    device: torch.device | str) -> dict:
    """Port params from the JAX pytree (leaves as numpy arrays)."""
    pattern = tuple(cfg.block_pattern)
    groups = tuple(np_params["groups"])  # one stacked tree per pattern position
    tail = tuple(np_params.get("tail", ()))
    n_groups = cfg.num_layers // len(pattern)
    if len(groups) != len(pattern) or len(tail) != cfg.num_layers % len(pattern):
        raise ValueError(f"the JAX params hold {len(groups)} pattern positions and a tail "
                         f"of {len(tail)}, not the layout of {cfg.num_layers} layers of "
                         f"pattern {pattern}")
    want = _WEIGHT_KEY[enc.weight_quant] if enc.enabled else "w_t"
    if want not in _keys(groups[0]):
        raise ValueError(f"the JAX params hold no {want!r} leaves: they were made for "
                         f"another weight format than weight_quant={enc.weight_quant!r}")
    layers = [_tree(groups[i], lambda a, g=g: to_torch(a[g], device))
              for g in range(n_groups) for i in range(len(pattern))]
    layers += [_tree(t, lambda a: to_torch(a, device)) for t in tail]
    for layer in layers:
        if "moe" in layer:
            moe = layer["moe"]
            for name in ("w_gate", "w_up", "w_down"):
                moe[name] = [{key: leaf[j] for key, leaf in moe[name].items()}
                             for j in range(cfg.num_experts)]
    out = {
        "embed": to_torch(np_params["embed"], device),
        "final_norm": _tree(np_params["final_norm"], lambda a: to_torch(a, device)),
        "layers": layers,
    }
    if "head" in np_params:
        out["head"] = _tree(np_params["head"], lambda a: to_torch(a, device))
    if "enc_layers" in np_params:
        (stacked,) = tuple(np_params["enc_layers"])
        out["enc_layers"] = [_tree(stacked, lambda a, g=g: to_torch(a[g], device))
                             for g in range(cfg.encoder_layers)]
    for name in ("enc_final_norm", "dec_pos_embed", "projector"):
        if name in np_params:
            out[name] = _tree(np_params[name], lambda a: to_torch(a, device))
    return out


def opt_state_from_jax(np_opt: dict, cfg: ModelConfig, enc: EncodingConfig,
                       device: torch.device | str) -> dict:
    """The port's AdamW state (train/optimizer.init's layout) from the JAX
    package's {"mu", "nu", "step"} (leaves as numpy arrays): mu and nu
    through params_from_jax, step as a 0-dim int32 tensor."""
    return {"mu": params_from_jax(np_opt["mu"], cfg, enc, device),
            "nu": params_from_jax(np_opt["nu"], cfg, enc, device),
            "step": torch.tensor(int(np_opt["step"]), dtype=torch.int32, device=device)}
