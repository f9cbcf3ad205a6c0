"""Block-level dispatch (counterpart of repro/models/blocks.py): one
init / apply / cache-init triple per block type.

  attn  pre-norm attention + (MLP | MoE)   [dense, MoE, the hybrid's attention]
  rec   pre-norm RG-LRU + MLP              [RecurrentGemma]
  rwkv  RWKV-6 time mix + channel mix      [RWKV]

All share the signature init(gen, cfg, enc, device=) -> params and
apply(params, x, cfg=, enc=, phase=, cache=, pos=) -> x; `cache` (a dict of
tensors, or None) is updated in place: the attention block writes its K/V
into the cache tensors, the recurrent blocks put their new state tensors
into the dict.  The encoder-decoder blocks wait for their family's slice
(ROADMAP)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R


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


def rec_block_init(gen, cfg: ModelConfig, enc, *, device) -> dict:
    return {
        "ln1": L.norm_init(cfg, device=device),
        "rglru": R.rglru_init(gen, cfg, enc, device=device),
        "ln2": L.norm_init(cfg, device=device),
        "mlp": L.mlp_init(gen, cfg, enc, device=device),
    }


def rec_block_apply(params, x, *, cfg, enc, phase, cache, pos):
    """Pre-norm RG-LRU + MLP; the new state goes into `cache`."""
    h, new_state = R.rglru_apply(params["rglru"], L.norm_apply(params["ln1"], x, cfg),
                                 cfg=cfg, enc=enc, phase=phase, state=cache)
    if cache is not None:
        cache.update(new_state)
    x = x + h
    y = L.norm_apply(params["ln2"], x, cfg)
    return x + L.mlp_apply(params["mlp"], y, cfg=cfg, enc=enc, phase=phase)


def rwkv_block_init(gen, cfg: ModelConfig, enc, *, device) -> dict:
    return R.rwkv_init(gen, cfg, enc, device=device)


def rwkv_block_apply(params, x, *, cfg, enc, phase, cache, pos):
    """The RWKV-6 block; the new state goes into `cache`."""
    out, new_state = R.rwkv_apply(params, x, cfg=cfg, enc=enc, phase=phase, state=cache)
    if cache is not None:
        cache.update(new_state)
    return out


def _state_cache(state_init):
    def init(cfg, batch, max_seq, *, device):
        del max_seq  # a recurrent state does not grow with the sequence
        return state_init(cfg, batch, device=device)
    return init


BLOCKS = {
    "attn": (attn_block_init, attn_block_apply, L.attn_cache_init),
    "rec": (rec_block_init, rec_block_apply, _state_cache(R.rglru_state_init)),
    "rwkv": (rwkv_block_init, rwkv_block_apply, _state_cache(R.rwkv_state_init)),
}
