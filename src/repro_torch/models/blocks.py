"""Block-level dispatch (counterpart of repro/models/blocks.py).  Only the
attention block is ported, with an MLP or (num_experts > 0) an MoE; the
recurrent and encoder-decoder blocks wait for their families' slices
(ROADMAP)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def attn_block_init(gen, cfg: ModelConfig, enc, *, device) -> dict:
    p = {
        "ln1": L.norm_init(cfg, device=device),
        "attn": L.attention_init(gen, cfg, enc, device=device),
        "ln2": L.norm_init(cfg, device=device),
    }
    if cfg.num_experts:
        p["moe"] = L.moe_init(gen, cfg, enc, device=device)
    else:
        p["mlp"] = L.mlp_init(gen, cfg, enc, device=device)
    return p


def attn_block_apply(params, x, *, cfg, enc, phase, cache, pos):
    """Pre-norm attention + MLP (or MoE); `cache` is updated in place.  The
    MoE's aux loss is training's and is not computed here."""
    x = x + L.attention_apply(
        params["attn"], L.norm_apply(params["ln1"], x, cfg),
        cfg=cfg, enc=enc, phase=phase, cache=cache, pos=pos,
    )
    y = L.norm_apply(params["ln2"], x, cfg)
    if cfg.num_experts:
        return x + L.moe_apply(params["moe"], y, cfg=cfg, enc=enc, phase=phase)
    return x + L.mlp_apply(params["mlp"], y, cfg=cfg, enc=enc, phase=phase)
