"""Block-level dispatch (counterpart of repro/models/blocks.py): one
init / apply / cache-init triple per block type.

  attn         pre-norm attention + (MLP | MoE)  [dense, MoE, the hybrid's attention]
  rec          pre-norm RG-LRU + MLP             [RecurrentGemma]
  rwkv         RWKV-6 time mix + channel mix     [RWKV]
  encdec_attn  decoder block: self + cross attention + MLP  [Whisper decoder]
  enc_attn     bidirectional encoder block       [Whisper encoder]

All share the signature init(gen, cfg, enc, device=) -> params and
apply(params, x, cfg=, enc=, phase=, cache=, pos=, extra=, aux=) -> x; `cache` (a
dict of tensors, or None) is updated in place: the attention blocks write
their K/V into the cache tensors, the recurrent blocks put their new state
tensors into the dict.  `extra` is the encoder output (B, Te, d_model) at
an enc-dec prefill, else None; only encdec_attn reads it.  `aux`, where a
list, receives the block's training aux losses (JAX's blocks return them
beside x): an MoE layer's load-balance loss; the other blocks have none and
add nothing.  Serving passes no list and computes no aux."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.encoding import Phase
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R


def attn_block_init(gen, cfg: ModelConfig, enc, *, device, take_expert=None) -> dict:
    """`take_expert`: moe_init's `take` (an MoE layer's experts)."""
    p = {
        "ln1": L.norm_init(cfg, device=device),
        "attn": L.attention_init(gen, cfg, enc, device=device),
        "ln2": L.norm_init(cfg, device=device),
    }
    if cfg.num_experts:
        p["moe"] = L.moe_init(gen, cfg, enc, device=device, take=take_expert)
    else:
        p["mlp"] = L.mlp_init(gen, cfg, enc, device=device)
    return p


def attn_block_apply(params, x, *, cfg, enc, phase, cache, pos, extra=None, aux=None,
                     tp=None):
    """Pre-norm attention + MLP (or MoE); `cache` is updated in place.  An
    MoE layer appends its load-balance loss to `aux` where it is a list.
    `tp` (a parallel/sharding.Shard) runs the rank's heads and FFN columns
    (an MoE layer's: every expert's)."""
    x = x + L.attention_apply(
        params["attn"], L.norm_apply(params["ln1"], x, cfg),
        cfg=cfg, enc=enc, phase=phase, cache=cache, pos=pos, tp=tp,
    )
    y = L.norm_apply(params["ln2"], x, cfg)
    if cfg.num_experts:
        return x + L.moe_apply(params["moe"], y, cfg=cfg, enc=enc, phase=phase, aux=aux,
                               tp=tp)
    return x + L.mlp_apply(params["mlp"], y, cfg=cfg, enc=enc, phase=phase, tp=tp)


def rec_block_init(gen, cfg: ModelConfig, enc, *, device) -> dict:
    return {
        "ln1": L.norm_init(cfg, device=device),
        "rglru": R.rglru_init(gen, cfg, enc, device=device),
        "ln2": L.norm_init(cfg, device=device),
        "mlp": L.mlp_init(gen, cfg, enc, device=device),
    }


def rec_block_apply(params, x, *, cfg, enc, phase, cache, pos, extra=None, aux=None):
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


def rwkv_block_apply(params, x, *, cfg, enc, phase, cache, pos, extra=None, aux=None):
    """The RWKV-6 block; the new state goes into `cache`."""
    out, new_state = R.rwkv_apply(params, x, cfg=cfg, enc=enc, phase=phase, state=cache)
    if cache is not None:
        cache.update(new_state)
    return out


def enc_attn_block_init(gen, cfg: ModelConfig, enc, *, device) -> dict:
    return {
        "ln1": L.norm_init(cfg, device=device),
        "attn": L.attention_init(gen, cfg, enc, device=device),
        "ln2": L.norm_init(cfg, device=device),
        "mlp": L.mlp_init(gen, cfg, enc, device=device),
    }


def enc_attn_block_apply(params, x, *, cfg, enc, phase, cache, pos, extra=None, aux=None):
    """Pre-norm bidirectional attention (no RoPE, no cache; a DECODE phase
    runs it as PREFILL, as JAX does) + MLP."""
    x = x + L.attention_apply(
        params["attn"], L.norm_apply(params["ln1"], x, cfg), cfg=cfg, enc=enc,
        phase=Phase.PREFILL if phase is Phase.DECODE else phase, cache=None,
        causal=False, use_rope=False,
    )
    y = L.norm_apply(params["ln2"], x, cfg)
    return x + L.mlp_apply(params["mlp"], y, cfg=cfg, enc=enc, phase=phase)


def encdec_block_init(gen, cfg: ModelConfig, enc, *, device) -> dict:
    return {
        "ln1": L.norm_init(cfg, device=device),
        "self_attn": L.attention_init(gen, cfg, enc, device=device),
        "ln_x": L.norm_init(cfg, device=device),
        "cross_attn": L.attention_init(gen, cfg, enc, device=device),
        "ln2": L.norm_init(cfg, device=device),
        "mlp": L.mlp_init(gen, cfg, enc, device=device),
    }


def encdec_block_apply(params, x, *, cfg, enc, phase, cache, pos, extra=None, aux=None):
    """The Whisper decoder block: pre-norm self attention without RoPE on
    the dense cache's "k"/"v", then cross attention, then the MLP.

    With `extra` (the encoder output, at prefill) cross attention runs
    through attention_apply(kv_src=extra), which projects the cross K/V
    once, attends them and writes them to the cache's "cross_k"/"cross_v"
    (JAX projects them twice, inside attention_apply and again for the
    cache, from the same weights and inputs).  Without it (a decode) only
    the q and o projections run, over the cached cross K/V."""
    x = x + L.attention_apply(
        params["self_attn"], L.norm_apply(params["ln1"], x, cfg), cfg=cfg, enc=enc,
        phase=phase, cache=cache, pos=pos, use_rope=False,
    )
    xq = L.norm_apply(params["ln_x"], x, cfg)
    if extra is not None:
        x = x + L.attention_apply(
            params["cross_attn"], xq, cfg=cfg, enc=enc,
            phase=Phase.PREFILL if phase is Phase.DECODE else phase, cache=cache,
            kv_src=extra,
        )
    elif cache is None:
        raise ValueError("a decoder step without the encoder output needs the cross cache")
    else:
        x = x + L.cross_attention_apply(params["cross_attn"], xq, cache["cross_k"],
                                        cache["cross_v"], cfg=cfg, enc=enc, phase=phase)
    y = L.norm_apply(params["ln2"], x, cfg)
    return x + L.mlp_apply(params["mlp"], y, cfg=cfg, enc=enc, phase=phase)


def encdec_cache_init(cfg: ModelConfig, batch: int, max_seq: int, *, device) -> dict:
    """The self attention's dense K/V rows (attn_cache_init) and the cross
    K/V, (batch, frontend_tokens, KV, D) each in the activation dtype, one
    flat dict (JAX nests the first two under "self")."""
    shape = (batch, cfg.frontend_tokens, cfg.num_kv_heads, cfg.head_dim)
    dt = cfg.activation_dtype
    return {**L.attn_cache_init(cfg, batch, max_seq, device=device),
            "cross_k": torch.zeros(shape, dtype=dt, device=device),
            "cross_v": torch.zeros(shape, dtype=dt, device=device)}


def _state_cache(state_init):
    def init(cfg, batch, max_seq, *, device):
        del max_seq  # a recurrent state does not grow with the sequence
        return state_init(cfg, batch, device=device)
    return init


BLOCKS = {
    "attn": (attn_block_init, attn_block_apply, L.attn_cache_init),
    "rec": (rec_block_init, rec_block_apply, _state_cache(R.rglru_state_init)),
    "rwkv": (rwkv_block_init, rwkv_block_apply, _state_cache(R.rwkv_state_init)),
    "enc_attn": (enc_attn_block_init, enc_attn_block_apply, lambda *a, **kw: None),
    "encdec_attn": (encdec_block_init, encdec_block_apply, encdec_cache_init),
}
