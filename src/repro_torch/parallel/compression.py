"""int8 gradient compression with error feedback (counterpart of
repro/parallel/compression.py).

Each gradient leaf, plus the error carried from the last step, is quantized
to int8 with one symmetric scale, and dequantized; the quantization error
is carried into the next step, so the compressed trajectory tracks the
exact one (Karimireddy et al., 2019).  On one card nothing crosses a link:
the round trip runs for its effect on the update, as in the JAX package
without a mesh.  torch.round rounds half to even, as jnp.round does.
"""

from __future__ import annotations

import torch

from repro_torch.core import tree


def init_state(params) -> dict:
    return {"error": tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)}


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(grads, state: dict):
    """The error-feedback int8 round trip.  Returns (f32 gradients, new
    state)."""
    new_g, new_e = [], []
    for g, e in zip(tree.leaves(grads), tree.leaves(state["error"])):
        corrected = g.float() + e
        deq = _dequantize(*_quantize(corrected))
        new_g.append(deq)
        new_e.append(corrected - deq)
    return tree.unflatten(grads, new_g), {"error": tree.unflatten(grads, new_e)}
