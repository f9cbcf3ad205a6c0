"""Shared model layers (counterpart of repro/models/layers.py).

Every dense projection routes through core/packed.linear_apply, so the
paper's encoding applies to all of them.  Caches are updated in place where
the JAX package donates buffers: the decode write goes straight into the
per-layer page pool (quantized on write for kv8/kv4 pools) or dense cache
with index_put_, and prefill writes its K/V into the dense cache it was
handed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import encoding
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

    `pos` is an int or a 0-dim tensor (every row at the same position:
    prefill offset, or grouped decode) or a (B,) tensor (decode: row b's
    x[:, 0] sits at pos[b]).  At DECODE an S > 1 window writes all S
    positions, then attends masked-causally, on either cache:
      paged {"k", "v": (P, bs, KV, Ds), "table": (B, NB) [, "k_scale",
      "v_scale": (P, bs, KV, 1)]}: row b writes token j into page
      table[b, (pos+j)//bs] at offset (pos+j) % bs (quantized on write for
      kv8/kv4 pools, data and scale at the same page ids), then attends its
      live pages;
      dense {"k", "v": (B, S_c, KV, D)}: row b writes slot pos+j (a (B,) pos
      clamps at the cache edge; a shared pos writes one slot column), then
      attends slots <= pos+j.
    At PREFILL an int pos > 0 attends cache[:, :pos] before the new keys
    (suffix prefill over a cached prefix), and the new K/V are written to
    cache[:, pos:pos+S]."""
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
    per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
    if per_row:
        positions = pos.to(x.device).long()[:, None] + steps[None, :]
    else:
        pos = int(pos)
        positions = (pos + steps)[None, :].expand(b, s)
    q = rope_apply(q, positions, cfg.rope_theta)
    k = rope_apply(k, positions, cfg.rope_theta)

    if phase is Phase.DECODE:
        if cache is None:
            raise ValueError("decode needs a KV cache")
        if "table" in cache:
            out = _paged_decode(q, k, v, cache, positions, enc=enc)
        else:
            out = _dense_decode(q, k, v, cache, positions, None if per_row else pos, enc=enc,
                                window=window)
    else:
        q_off = 0
        k_att, v_att = k, v
        if pos > 0 and cache is not None:
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


def _paged_decode(q, k, v, cache: dict, positions: torch.Tensor, *, enc) -> torch.Tensor:
    """Write the window's K/V into the page pool (quantized on write for a
    kv8/kv4 pool, whose layout its dtype names), then attend the live pages.

    Pads past the last logical block clamp to the final table entry (JAX's
    contract).  The engine widens the table to cover every window
    (Engine._live_table_width), so a pad inside the table lands on the
    scratch page or on a masked future offset of a private page.  index_put_
    writes duplicate indices in no fixed order on CUDA; the only duplicates
    are such pads (and idle rows on scratch), whose values are never read
    unmasked."""
    table = cache["table"]
    bs_page = cache["k"].shape[1]
    layout = encoding.kv_layout_for_storage(cache["k"].dtype)
    blk = torch.clamp(positions // bs_page, max=table.shape[1] - 1)
    pg = torch.gather(table.long(), 1, blk)
    off = positions % bs_page
    if layout.quantized:
        k, k_scale = layout.quantize(k)
        v, v_scale = layout.quantize(v)
        cache["k_scale"].index_put_((pg, off), k_scale)
        cache["v_scale"].index_put_((pg, off), v_scale)
    cache["k"].index_put_((pg, off), k)
    cache["v"].index_put_((pg, off), v)
    choice = registry_lib.select_attn(
        phase=Phase.DECODE, s=table.shape[1] * bs_page, target=enc.target,
        requested=enc.attn_backend, kv=layout.name,
    )
    if choice.backend == "pallas":
        return attn_kernels.paged_decode_attention(
            q, cache["k"], cache["v"], table, positions[:, 0], k_scale=cache.get("k_scale"),
            v_scale=cache.get("v_scale"), kv_quant=layout.name,
        )
    k_view, v_view = paged_gather(cache["k"], table), paged_gather(cache["v"], table)
    if layout.quantized:
        # The plain fallback: gather the quantized view and its scale view,
        # dequantize, then the plain decode attention.
        k_view = layout.dequantize(k_view, paged_gather(cache["k_scale"], table))
        v_view = layout.dequantize(v_view, paged_gather(cache["v_scale"], table))
    return attention_decode(q, k_view, v_view, positions[:, 0])


def _dense_decode(q, k, v, cache: dict, positions: torch.Tensor, shared_pos: int | None, *,
                  enc, window: int) -> torch.Tensor:
    """Write the window's K/V into the dense (B, S_c, KV, D) cache, then
    attend it.  A (B,) pos scatters each row's own slots, clamped at the
    cache edge (the engine caps every window so a clamped slot is only ever
    a pad colliding with other pads); a shared pos writes one slot column,
    its start clamped so the window fits, as JAX's dynamic_update_slice.
    Rejected draft and pad slots stay masked until a real write lands."""
    b, s = positions.shape
    s_c = cache["k"].shape[1]
    if shared_pos is None:
        rows = torch.arange(b, device=q.device)[:, None].expand(b, s)
        wslot = torch.clamp(positions, max=s_c - 1)
        cache["k"].index_put_((rows, wslot), k)
        cache["v"].index_put_((rows, wslot), v)
        pos = positions[:, 0]
    else:
        start = min(shared_pos, s_c - s)
        cache["k"][:, start:start + s] = k
        cache["v"][:, start:start + s] = v
        pos = shared_pos
    choice = registry_lib.select_attn(
        phase=Phase.DECODE, s=s_c, target=enc.target, requested=enc.attn_backend,
    )
    if choice.backend == "pallas" and (s == 1 or window == 0):
        return attn_kernels.dense_decode_attention(q, cache["k"], cache["v"], pos,
                                                   window=window)
    return attention_decode(q, cache["k"], cache["v"], pos, window)


def attn_cache_init(cfg: ModelConfig, batch: int, max_seq: int, *, device) -> dict:
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    dt = cfg.activation_dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def attn_paged_cache_init(cfg: ModelConfig, batch: int, max_seq: int, *, block_size: int,
                          num_pages: int, device, kv_quant: str = "bf16",
                          table: torch.Tensor | None = None) -> dict:
    """A page pool + the per-slot block table (page 0 is the scratch page idle
    rows write to; tables start on it).  Layers may share one `table`.

    `kv_quant` picks the KVLayout (core/encoding): bf16 keeps pools in the
    activation dtype; kv8/kv4 store int8 / packed-nibble uint8 pools (head
    dim D/2 for kv4) plus float32 `k_scale`/`v_scale` scale pages of shape
    (P, bs, KV, 1), so one page id addresses a block's data and scales."""
    if cfg.sliding_window:
        raise ValueError("paged cache excludes sliding-window configs")
    nb = -(-max_seq // block_size)
    layout = encoding.kv_layout(kv_quant)
    dt = layout.storage_dtype if layout.quantized else cfg.activation_dtype
    shape = (num_pages, block_size, cfg.num_kv_heads, layout.storage_head_dim(cfg.head_dim))
    if table is None:
        table = torch.zeros((batch, nb), dtype=torch.int32, device=device)
    out = {"k": torch.zeros(shape, dtype=dt, device=device),
           "v": torch.zeros(shape, dtype=dt, device=device),
           "table": table}
    if layout.quantized:
        sshape = layout.scale_shape((num_pages, block_size), cfg.num_kv_heads)
        out["k_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
        out["v_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
    return out


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
