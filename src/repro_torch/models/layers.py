"""Shared model layers (counterpart of repro/models/layers.py).

Every dense projection routes through core/packed.linear_apply, so the
paper's encoding applies to all of them.  Caches are updated in place where
the JAX package donates buffers: the paged decode write goes straight into
the per-layer page pool with index_put_, and prefill writes its K/V into the
(temporary, dense) cache it was handed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import packed
from repro_torch.core.encoding import Phase
from repro_torch.kernels import attn as attn_kernels
from repro_torch.kernels import registry as registry_lib

# The plain attention of the "xla" attention backend.
attention_decode = attn_kernels.decode_attention_plain
paged_gather = attn_kernels.paged_gather

# ---------------------------------------------------------------------------
# Norms


def norm_init(cfg: ModelConfig, *, device, dim: int | None = None) -> dict:
    d = dim or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm_kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * params["scale"] + params["bias"]
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * params["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding with f32 angles.  x (B, S, H, D),
    positions (B, S) integer."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Plain prefill attention (the "xla" attention backend)


def attention_chunked(q, k, v, *, causal: bool, window: int, q_chunk: int,
                      q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, KV, D) -> (B, Sq, H, D).  One query chunk
    at a time, so the live score block is (q_chunk x Sk) per head."""
    outs = [
        attn_kernels.flash_prefill_attention_plain(
            q[:, i:i + q_chunk], k, v, causal=causal, window=window, q_offset=q_offset + i
        )
        for i in range(0, q.shape[1], q_chunk)
    ]
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Attention layer (projections + cache plumbing)


def attention_init(gen, cfg: ModelConfig, enc: packed.EncodingConfig, *, device) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    kw = dict(enc=enc, dtype=cfg.activation_dtype, device=device)
    return {
        "wq": packed.linear_init(gen, d, h * hd, use_bias=cfg.qkv_bias, **kw),
        "wk": packed.linear_init(gen, d, kvh * hd, use_bias=cfg.qkv_bias, **kw),
        "wv": packed.linear_init(gen, d, kvh * hd, use_bias=cfg.qkv_bias, **kw),
        "wo": packed.linear_init(gen, h * hd, d, **kw),
    }


def attention_apply(
    params: dict,
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    enc: packed.EncodingConfig,
    phase: Phase,
    cache: dict | None = None,
    pos: torch.Tensor | int = 0,
) -> torch.Tensor:
    """Self-attention with RoPE; updates `cache` in place.

    `pos` is an int (every row starts at the same position: prefill offset)
    or a (B,) tensor (decode: row b's x[:, 0] sits at pos[b]).  At DECODE the
    cache is the paged pool {"k", "v": (P, bs, KV, D), "table": (B, NB)}:
    row b writes token j into page table[b, (pos+j)//bs] at offset
    (pos+j) % bs, then attends its live pages.  At PREFILL an int pos > 0
    attends cache[:, :pos] before the new keys (suffix prefill over a cached
    prefix), and the new K/V are written to cache[:, pos:pos+S]."""
    b, s, d = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = cfg.sliding_window
    if window and cache is not None:
        raise NotImplementedError(
            "sliding-window caches wait for their family's slice (ROADMAP)"
        )
    q = packed.linear_apply(params["wq"], x, n=h * hd, phase=phase, enc=enc).reshape(b, s, h, hd)
    k = packed.linear_apply(params["wk"], x, n=kvh * hd, phase=phase, enc=enc).reshape(b, s, kvh, hd)
    v = packed.linear_apply(params["wv"], x, n=kvh * hd, phase=phase, enc=enc).reshape(b, s, kvh, hd)
    steps = torch.arange(s, device=x.device)
    if isinstance(pos, torch.Tensor):
        positions = pos.to(x.device).long()[:, None] + steps[None, :]
    else:
        positions = (pos + steps)[None, :].expand(b, s)
    q = rope_apply(q, positions, cfg.rope_theta)
    k = rope_apply(k, positions, cfg.rope_theta)

    if phase is Phase.DECODE:
        if cache is None or "table" not in cache:
            raise NotImplementedError(
                "decode runs on the paged cache only; the dense cache and "
                "dense_decode_attention wait for the dense-cache slice (ROADMAP)"
            )
        table = cache["table"]
        bs_page = cache["k"].shape[1]
        # Window pads past the last logical block clamp to the final table entry.
        blk = torch.clamp(positions // bs_page, max=table.shape[1] - 1)
        pg = torch.gather(table.long(), 1, blk)
        off = positions % bs_page
        cache["k"].index_put_((pg, off), k)
        cache["v"].index_put_((pg, off), v)
        choice = registry_lib.select_attn(
            phase=Phase.DECODE, s=table.shape[1] * bs_page, target=enc.target,
            requested=enc.attn_backend,
        )
        if choice.backend == "pallas":
            out = attn_kernels.paged_decode_attention(
                q, cache["k"], cache["v"], table, positions[:, 0]
            )
        else:
            out = attention_decode(
                q, paged_gather(cache["k"], table), paged_gather(cache["v"], table),
                positions[:, 0],
            )
    else:
        q_off = 0
        k_att, v_att = k, v
        if isinstance(pos, int) and pos > 0 and cache is not None:
            k_att = torch.cat([cache["k"][:, :pos], k], dim=1)
            v_att = torch.cat([cache["v"][:, :pos], v], dim=1)
            q_off = pos
        choice = registry_lib.select_attn(
            phase=Phase.PREFILL, s=k_att.shape[1], target=enc.target,
            requested=enc.attn_backend,
        )
        if choice.backend == "pallas" and phase is not Phase.TRAIN:
            out = attn_kernels.flash_prefill_attention(
                q, k_att, v_att, causal=True, window=window, q_offset=q_off
            )
        else:
            out = attention_chunked(
                q, k_att, v_att, causal=True, window=window, q_chunk=cfg.q_chunk,
                q_offset=q_off,
            )
        if cache is not None:
            if "table" in cache:
                raise ValueError("paged caches are decode-only; prefill writes a "
                                 "temporary dense cache the engine scatters into pages")
            cache["k"][:, q_off:q_off + s] = k
            cache["v"][:, q_off:q_off + s] = v
    return packed.linear_apply(params["wo"], out.reshape(b, s, h * hd), n=d, phase=phase, enc=enc)


def attn_cache_init(cfg: ModelConfig, batch: int, max_seq: int, *, device) -> dict:
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    dt = cfg.activation_dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def attn_paged_cache_init(cfg: ModelConfig, batch: int, max_seq: int, *, block_size: int,
                          num_pages: int, device, table: torch.Tensor | None = None) -> dict:
    """A page pool + the per-slot block table (page 0 is the scratch page idle
    rows write to; tables start on it).  Layers may share one `table`."""
    if cfg.sliding_window:
        raise ValueError("paged cache excludes sliding-window configs")
    nb = -(-max_seq // block_size)
    shape = (num_pages, block_size, cfg.num_kv_heads, cfg.head_dim)
    dt = cfg.activation_dtype
    if table is None:
        table = torch.zeros((batch, nb), dtype=torch.int32, device=device)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "table": table}


# ---------------------------------------------------------------------------
# MLP


def mlp_init(gen, cfg: ModelConfig, enc: packed.EncodingConfig, *, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(enc=enc, dtype=cfg.activation_dtype, device=device)
    if cfg.mlp_kind == "swiglu":
        return {
            "w_gate": packed.linear_init(gen, d, f, **kw),
            "w_up": packed.linear_init(gen, d, f, **kw),
            "w_down": packed.linear_init(gen, f, d, **kw),
        }
    return {
        "w_up": packed.linear_init(gen, d, f, use_bias=True, **kw),
        "w_down": packed.linear_init(gen, f, d, use_bias=True, **kw),
    }


def mlp_apply(params, x, *, cfg: ModelConfig, enc, phase: Phase) -> torch.Tensor:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        gate = packed.linear_apply(params["w_gate"], x, n=f, phase=phase, enc=enc)
        up = packed.linear_apply(params["w_up"], x, n=f, phase=phase, enc=enc)
        hidden = F.silu(gate.float()).to(x.dtype) * up
    else:
        up = packed.linear_apply(params["w_up"], x, n=f, phase=phase, enc=enc)
        hidden = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    return packed.linear_apply(params["w_down"], hidden, n=d, phase=phase, enc=enc)
