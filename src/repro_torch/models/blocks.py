"""Block-level dispatch (counterpart of repro/models/blocks.py).  Only the
attention block is ported; recurrent and encoder-decoder blocks wait for
their families' slices (ROADMAP)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def attn_block_init(gen, cfg: ModelConfig, enc, *, device) -> dict:
    if cfg.num_experts:
        raise NotImplementedError("MoE blocks wait for the MoE family slice (ROADMAP)")
    return {
        "ln1": L.norm_init(cfg, device=device),
        "attn": L.attention_init(gen, cfg, enc, device=device),
        "ln2": L.norm_init(cfg, device=device),
        "mlp": L.mlp_init(gen, cfg, enc, device=device),
    }


def attn_block_apply(params, x, *, cfg, enc, phase, cache, pos):
    """Pre-norm attention + MLP; `cache` is updated in place."""
    x = x + L.attention_apply(
        params["attn"], L.norm_apply(params["ln1"], x, cfg),
        cfg=cfg, enc=enc, phase=phase, cache=cache, pos=pos,
    )
    y = L.norm_apply(params["ln2"], x, cfg)
    return x + L.mlp_apply(params["mlp"], y, cfg=cfg, enc=enc, phase=phase)
