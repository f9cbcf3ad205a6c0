"""Shared model layers (counterpart of repro/models/layers.py).

Every dense projection routes through core/packed.linear_apply, so the
paper's encoding applies to all of them.  Caches are updated in place where
the JAX package donates buffers: the decode write goes straight into the
per-layer page pool (quantized on write for kv8/kv4 pools) or dense cache
with index_put_, and prefill writes its K/V into the dense cache it was
handed.  A sliding-window model's dense cache is a ring of
S_c = min(max_seq, window) slots: position p lives in slot p mod S_c.
Cross attention (cross_kv, cross_attention_apply) attends every key of its
source with no mask: the flash kernel non-causally at prefill, the dense
decode kernel over the cached cross K/V at decode.

The MoE block (moe_init, moe_apply) is the JAX package's capacity-bounded
token-choice top-k dispatch, rule for rule; its experts are a list of
projections, each run on its own capacity buffer as JAX's vmap runs them.
Its Switch load-balance aux loss (moe_aux) is training's: moe_apply hands
it out only to a caller that passes an `aux` list, so serving pays nothing
for it.

Under tensor parallelism (`tp`, a parallel/sharding.Shard) attention_apply,
mlp_apply and moe_apply run on the rank's heads and FFN columns (`cfg`
carries their local counts) and sum their row-parallel output (wo, w_down)
over the group in f32 before the cast (packed.linear_apply's row_group; an
MoE layer's E experts' w_down in one all-reduce).
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
    kv_src: torch.Tensor | None = None,
    causal: bool = True,
    use_rope: bool = True,
    tp=None,
) -> torch.Tensor:
    """Self-attention with RoPE (none where `use_rope` is False); updates
    `cache` in place.  With `kv_src` (B, Te, d_model) it is cross attention
    instead (cross_attention_apply): K and V projected from kv_src, no RoPE,
    no self-attention cache read or write, every query attending all Te
    keys; a `cache` given with it is the cross cache, whose "cross_k" and
    "cross_v" take the projected K/V for the decode steps.  `causal`
    False lets every query of a prefill attend every key (the encoder); a
    decode is masked-causal over its cache either way.

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
      attends slots <= pos+j; under a sliding window the cache is a ring
      (slot (pos+j) mod S_c, L = 1) read with JAX's ring mask.
    At PREFILL an int pos > 0 attends the cached keys before the new ones
    (cache[:, :pos], or under a window the last min(pos, S_c) positions from
    the ring), and the new K/V are written to cache[:, pos:pos+S], or under
    a window each position p to ring slot p mod S_c (_prefill_write).

    `tp` (a parallel/sharding.Shard): `cfg` holds the rank's query and kv
    heads, its cache their pages, and wo's output is summed over the group
    (packed.linear_apply's row_group) where the plan splits attention."""
    b, s, d = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = cfg.sliding_window
    if kv_src is not None:
        k, v = cross_kv(params, kv_src, cfg=cfg, enc=enc, phase=phase)
        if cache is not None:
            cache["cross_k"].copy_(k)
            cache["cross_v"].copy_(v)
        return cross_attention_apply(params, x, k, v, cfg=cfg, enc=enc, phase=phase)
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
    if use_rope:
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)

    if phase is Phase.DECODE:
        if cache is None:
            raise ValueError("decode needs a KV cache")
        # An MoE layer routes every row, idle slots and pads included, and
        # their capacity claims reach the live rows: their K/V writes must
        # land the same way every run (_last_write_wins).
        settle = cfg.num_experts > 0
        if "table" in cache:
            out = _paged_decode(q, k, v, cache, positions, enc=enc, settle=settle)
        else:
            out = _dense_decode(q, k, v, cache, positions, None if per_row else pos, enc=enc,
                                window=window, settle=settle)
    else:
        q_off = 0
        k_att, v_att = k, v
        if pos > 0 and cache is not None:
            k_prior, v_prior = _cached_prefix(cache, pos, window)
            k_att = torch.cat([k_prior, k], dim=1)
            v_att = torch.cat([v_prior, v], dim=1)
            q_off = k_prior.shape[1]
        choice = registry_lib.select_attn(
            phase=Phase.PREFILL, s=k_att.shape[1], target=enc.target,
            requested=enc.attn_backend,
        )
        if choice.backend == "pallas" and phase is not Phase.TRAIN:
            out = attn_kernels.flash_prefill_attention(
                q, k_att, v_att, causal=causal, window=window, q_offset=q_off
            )
        else:
            out = attention_chunked(
                q, k_att, v_att, causal=causal, window=window, q_chunk=cfg.q_chunk,
                q_offset=q_off,
            )
        if cache is not None:
            if "table" in cache:
                raise ValueError("paged caches are decode-only; prefill writes a "
                                 "temporary dense cache the engine scatters into pages")
            _prefill_write(cache, k, v, pos, window)
    group = tp.group if tp is not None and tp.attn_split else None
    return packed.linear_apply(params["wo"], out.reshape(b, s, h * hd), n=d, phase=phase,
                               enc=enc, row_group=group)


def cross_kv(params: dict, src: torch.Tensor, *, cfg: ModelConfig, enc,
             phase: Phase) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross attention's K and V (B, Te, KV, D), projected from the
    encoder states `src` (B, Te, d_model) by its wk and wv."""
    b, te, _ = src.shape
    kvd = cfg.num_kv_heads * cfg.head_dim
    shape = (b, te, cfg.num_kv_heads, cfg.head_dim)
    k = packed.linear_apply(params["wk"], src, n=kvd, phase=phase, enc=enc).reshape(shape)
    v = packed.linear_apply(params["wv"], src, n=kvd, phase=phase, enc=enc).reshape(shape)
    return k, v


def cross_attention_apply(params: dict, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          cfg: ModelConfig, enc, phase: Phase) -> torch.Tensor:
    """Cross attention of x (B, S, d_model) over the cross K/V (B, Te, KV,
    D): the q projection, every query attending all Te keys (no mask, no
    RoPE), the o projection.  Where the registry picks the kernels, a
    prefill runs flash prefill with causal=False (Sq = S, Sk = Te) and a
    decode the dense decode kernel over the cross cache with every row at
    pos = Te - 1 (which attends slots 0 .. Te - 1: all of them); else the
    plain versions (JAX: its chunked reference and attention_decode)."""
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    te = k.shape[1]
    q = packed.linear_apply(params["wq"], x, n=h * hd, phase=phase, enc=enc).reshape(b, s, h, hd)
    choice = registry_lib.select_attn(
        phase=Phase.DECODE if phase is Phase.DECODE else Phase.PREFILL, s=te,
        target=enc.target, requested=enc.attn_backend,
    )
    kernel = choice.backend == "pallas" and phase is not Phase.TRAIN
    if phase is Phase.DECODE:
        out = (attn_kernels.dense_decode_attention(q, k, v, te - 1) if kernel
               else attention_decode(q, k, v, te - 1))
    elif kernel:
        out = attn_kernels.flash_prefill_attention(q, k, v, causal=False)
    else:
        out = attention_chunked(q, k, v, causal=False, window=0, q_chunk=cfg.q_chunk)
    return packed.linear_apply(params["wo"], out.reshape(b, s, h * hd), n=d, phase=phase, enc=enc)


def _cached_prefix(cache: dict, pos: int, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The cached K/V a prefill at offset `pos` attends before its own keys,
    in position order: cache[:, :pos], or under a window the last
    min(pos, S_c) positions gathered from their ring slots (the window mask
    is relative, so the shorter key run starting at pos - n is exact).  JAX
    attends no cached keys under a window; the port's chunked prefill needs
    them to equal a single-shot prefill."""
    if not window:
        return cache["k"][:, :pos], cache["v"][:, :pos]
    s_c = cache["k"].shape[1]
    n = min(pos, s_c)
    slots = torch.arange(pos - n, pos, device=cache["k"].device) % s_c
    return cache["k"][:, slots], cache["v"][:, slots]


def _prefill_write(cache: dict, k: torch.Tensor, v: torch.Tensor, pos: int,
                   window: int) -> None:
    """Write a prefill's K/V (positions pos .. pos+S-1) into the dense cache,
    in place: rows pos .. pos+S-1, or under a window each position p to ring
    slot p mod S_c, so a prompt longer than the ring keeps its last S_c keys,
    rolled onto their own slots.

    Where S is a multiple of S_c, or pos + S <= S_c, this equals JAX's write
    bit for bit.  Elsewhere JAX writes the last S_c keys to slots 0..S_c-1
    (repro/models/layers.py, the `window > 0 and s >= s_c` branch), which
    the decode's ring mask and ring write do not assume; the port follows
    JAX's uncached windowed forward there (tests/test_torch_window.py)."""
    s_c, s = cache["k"].shape[1], k.shape[1]
    if not window:
        cache["k"][:, pos:pos + s] = k
        cache["v"][:, pos:pos + s] = v
    elif s >= s_c:
        shift = (pos + s) % s_c  # the first kept position, pos + s - s_c, lands there
        cache["k"].copy_(torch.roll(k[:, s - s_c:], shift, dims=1))
        cache["v"].copy_(torch.roll(v[:, s - s_c:], shift, dims=1))
    else:
        slots = torch.arange(pos, pos + s, device=k.device) % s_c
        cache["k"][:, slots] = k
        cache["v"][:, slots] = v


def _last_write_wins(slot: torch.Tensor, *values: torch.Tensor) -> list[torch.Tensor]:
    """`values` (B, L, ...) as a window writes them to the cache slots `slot`
    (B, L), with every write to a slot that the window writes more than
    once replaced by the last such write in row-major order.  index_put_
    lands duplicate indices in no fixed order on CUDA; with this every
    duplicate carries the same value, so every run leaves what a serial
    scatter (the CPU's, against which the tests hold the JAX engine) leaves."""
    flat = slot.reshape(-1)
    n = flat.numel()
    order = torch.argsort(flat, stable=True)  # equal slots in window order
    key = flat[order]
    idx = torch.arange(n, device=flat.device)
    ends = torch.ones(n, dtype=torch.bool, device=flat.device)
    ends[:-1] = key[1:] != key[:-1]
    # For each sorted write, the last write of its run of equal slots.
    last = torch.where(ends, idx, n).flip(0).cummin(0).values.flip(0)
    winner = torch.empty_like(order)
    winner[order] = order[last]
    return [x.reshape(n, *x.shape[2:])[winner].reshape(x.shape) for x in values]


def _paged_decode(q, k, v, cache: dict, positions: torch.Tensor, *, enc,
                  settle: bool = False) -> torch.Tensor:
    """Write the window's K/V into the page pool (quantized on write for a
    kv8/kv4 pool, whose layout its dtype names), then attend the live pages.

    Pads past the last logical block clamp to the final table entry (JAX's
    contract).  The engine widens the table to cover every window
    (Engine._live_table_width), so a pad inside the table lands on the
    scratch page or on a masked future offset of a private page, and every
    idle row writes the scratch page at offset 0, then reads it there.  Such
    writes are the only duplicates; where those rows' values reach a live
    row (`settle`: an MoE layer's capacity), _last_write_wins settles them."""
    table = cache["table"]
    bs_page = cache["k"].shape[1]
    layout = encoding.kv_layout_for_storage(cache["k"].dtype)
    blk = torch.clamp(positions // bs_page, max=table.shape[1] - 1)
    pg = torch.gather(table.long(), 1, blk)
    off = positions % bs_page
    if settle:
        k, v = _last_write_wins(pg * bs_page + off, k, v)
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
                  enc, window: int, settle: bool = False) -> torch.Tensor:
    """Write the window's K/V into the dense (B, S_c, KV, D) cache, then
    attend it.  A (B,) pos scatters each row's own slots, clamped at the
    cache edge (the engine caps every window so a clamped slot is only ever
    a pad colliding with other pads); a shared pos writes one slot column,
    its start clamped so the window fits, as JAX's dynamic_update_slice.
    Under a sliding window both write slot pos mod S_c of the ring instead.
    Rejected draft and pad slots stay masked until a real write lands.
    `settle` as _paged_decode's: duplicate slots take their last write."""
    b, s = positions.shape
    s_c = cache["k"].shape[1]
    if shared_pos is None:
        rows = torch.arange(b, device=q.device)[:, None].expand(b, s)
        wslot = (torch.remainder(positions, s_c) if window
                 else torch.clamp(positions, max=s_c - 1))
        if settle:
            k, v = _last_write_wins(rows * s_c + wslot, k, v)
        cache["k"].index_put_((rows, wslot), k)
        cache["v"].index_put_((rows, wslot), v)
        pos = positions[:, 0]
    else:
        start = shared_pos % s_c if window else min(shared_pos, s_c - s)
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
    """The dense (batch, S_c, KV, D) K/V rows; S_c is max_seq, or the ring
    width min(max_seq, window) under a sliding window."""
    s_c = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    shape = (batch, s_c, cfg.num_kv_heads, cfg.head_dim)
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


def mlp_apply(params, x, *, cfg: ModelConfig, enc, phase: Phase, tp=None) -> torch.Tensor:
    """SwiGLU or GELU MLP; under `tp` on the rank's d_ff columns (cfg.d_ff),
    w_down's output summed over the group where the plan splits the MLP."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        gate = packed.linear_apply(params["w_gate"], x, n=f, phase=phase, enc=enc)
        up = packed.linear_apply(params["w_up"], x, n=f, phase=phase, enc=enc)
        hidden = F.silu(gate.float()).to(x.dtype) * up
    else:
        up = packed.linear_apply(params["w_up"], x, n=f, phase=phase, enc=enc)
        hidden = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    group = tp.group if tp is not None and tp.mlp_split else None
    return packed.linear_apply(params["w_down"], hidden, n=d, phase=phase, enc=enc,
                               row_group=group)


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, capacity-bounded scatter dispatch)


def moe_init(gen, cfg: ModelConfig, enc: packed.EncodingConfig, *, device,
             take=None) -> dict:
    """The router (f32 in the unquantized formats, as in JAX) and E experts'
    SwiGLU projections, each a list of E per-expert projections drawn from
    `gen` in order: router, gates, ups, downs.  `take(name, p)`, where
    given, replaces each expert projection as soon as it is drawn (a
    tensor-parallel rank keeps its slice: transformer.model_init(shard=))."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    kw = dict(enc=enc, dtype=cfg.activation_dtype, device=device)
    take = take or (lambda name, p: p)
    out = {"router": packed.linear_init(gen, d, e, enc=enc, dtype=torch.float32, device=device)}
    for name, (k, n) in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d))):
        out[name] = [take(name, packed.linear_init(gen, k, n, **kw)) for _ in range(e)]
    return out


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k over the last axis: the k largest values and their
    indices, equal values in index order (a stable descending sort), never
    torch.topk's unspecified order among ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(cfg: ModelConfig, t: int) -> tuple[int, int]:
    """(groups, cap) of a dispatch of `t` rows, dead and padded rows
    included: group-local queues when moe_dispatch_groups > 1 divides t,
    and cap = max(1, int(capacity_factor * (t / groups) * k / E)) rows per
    expert and group."""
    groups = cfg.moe_dispatch_groups if cfg.moe_dispatch_groups > 1 else 1
    if t % groups:
        groups = 1
    tg = t // groups
    return groups, max(1, int(cfg.capacity_factor * tg * cfg.experts_per_token / cfg.num_experts))


def moe_runs_dense(cfg: ModelConfig, phase: Phase) -> bool:
    """Whether every expert runs on every row (moe_dense_decode, at decode)."""
    return cfg.moe_dense_decode and phase is Phase.DECODE


def moe_expert_rows(cfg: ModelConfig, t: int, phase: Phase) -> int:
    """Rows each expert's projections take in a dispatch of `t` rows: all t
    where moe_runs_dense, else its groups x cap buffer."""
    if moe_runs_dense(cfg, phase):
        return t
    groups, cap = moe_capacity(cfg, t)
    return groups * cap


def moe_route(params: dict, xt: torch.Tensor, *, cfg: ModelConfig, enc,
              phase: Phase) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router of rows xt (T, D): (probs (T, E), gate (T, k), expert ids
    (T, k)).  f32 logits of the router projection on the rows cast to f32
    (exact; JAX's contraction promotes a bf16 row the same way against the
    f32 router), softmax, top_k (ties to the lower expert), and the gate
    renormalised by max(sum, 1e-9)."""
    logits = packed.linear_apply(params["router"], xt.float(), n=cfg.num_experts,
                                 phase=phase, enc=enc, out_dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = top_k(probs, cfg.experts_per_token)
    return probs, gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9), eidx


def moe_positions(eidx: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Each (row, choice)'s place in its expert's queue and whether it is
    kept, both (groups, T / groups, k): slot-major (every row's first
    choice before any row's second), group-local (moe_capacity), kept while
    the place is below cap."""
    t, k = eidx.shape
    e = cfg.num_experts
    groups, cap = moe_capacity(cfg, t)
    tg = t // groups
    onehot = F.one_hot(eidx, e)  # (T, k, E) int64
    oh_g = onehot.reshape(groups, tg, k, e).transpose(1, 2).reshape(groups, k * tg, e)
    pos_flat = (torch.cumsum(oh_g, dim=1) - oh_g) * oh_g
    position = pos_flat.sum(-1).reshape(groups, k, tg).transpose(1, 2)
    return position, position < cap


def _experts_apply(params: dict, xs, *, cfg: ModelConfig, enc, phase: Phase,
                   tp=None) -> torch.Tensor:
    """Every expert's SwiGLU on its rows, xs[i] (rows, D) for expert i, as
    JAX's vmapped _expert_matmul runs each expert: three projections
    through the registry at the rows' count.  (E, rows, D) in the rows'
    dtype.  Under `tp` (a Shard whose plan splits the FFN) each expert runs
    on the rank's FFN columns and the E w_down partials are summed over the
    group before the cast, in one all-reduce for all experts (and one
    absmax all-reduce with int8/int4 weights: packed.linear_apply_row_parallel)."""
    f, d = cfg.d_ff, cfg.d_model
    hidden = []
    for i, xe in enumerate(xs):
        gate = packed.linear_apply(params["w_gate"][i], xe, n=f, phase=phase, enc=enc)
        up = packed.linear_apply(params["w_up"][i], xe, n=f, phase=phase, enc=enc)
        hidden.append(F.silu(gate.float()).to(xe.dtype) * up)
    if tp is not None and tp.mlp_split:
        ys = packed.linear_apply_row_parallel(params["w_down"], hidden, n=d, phase=phase,
                                              enc=enc, row_group=tp.group)
    else:
        ys = [packed.linear_apply(w, h, n=d, phase=phase, enc=enc)
              for w, h in zip(params["w_down"], hidden)]
    return torch.stack(ys)


def moe_aux(probs: torch.Tensor, eidx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The Switch load-balance loss of one dispatch, as JAX computes it on
    every MoE path: E x sum over experts of (mean router probability) x
    (mean number of choices of the expert per row).  probs (T, E), eidx (T, k)."""
    onehot = F.one_hot(eidx, cfg.num_experts).float()  # (T, k, E)
    return cfg.num_experts * torch.sum(probs.mean(dim=0) * onehot.sum(dim=1).mean(dim=0))


def moe_apply(params: dict, x: torch.Tensor, *, cfg: ModelConfig, enc,
              phase: Phase, aux: list | None = None, tp=None) -> torch.Tensor:
    """Capacity-bounded token-choice top-k MoE (JAX layers.moe_apply, rule
    for rule).  x (B, S, D) -> (B, S, D).

    Router: moe_route.  Every one of the B x S rows routes and takes
    capacity, dead and padded slots included.  Rank: moe_positions; a pair
    past `cap` is dropped: it adds 0 at cap - 1 and its gate weight is 0.
    Each expert runs on its buffer of moe_expert_rows rows (groups x cap);
    the combine sums gate x keep x y over the k choices in f32.  Where
    moe_runs_dense, every expert runs on every row and the combine goes
    through the (T, E) gate matrix.  moe_shard_map falls back to this grouped path, as JAX's does
    without a mesh (one card).
    Where `aux` is a list, the dispatch's load-balance loss (moe_aux) is
    appended to it; serving passes none and computes none.

    Under tensor parallelism (`tp`, a parallel/sharding.Shard: `cfg` holds
    the rank's FFN columns, the router is whole) every rank routes the same
    replicated rows through the same router at the same shapes, so all
    ranks agree on the top-k, the queue places, the capacity drops and
    `keep`; each expert runs on the rank's columns, and the partial outputs
    are summed over the group before the cast and the combine
    (_experts_apply), as one card casts its expert outputs before it."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    probs, gate, eidx = moe_route(params, xt, cfg=cfg, enc=enc, phase=phase)
    if aux is not None:
        aux.append(moe_aux(probs, eidx, cfg))

    rows = moe_expert_rows(cfg, t, phase)
    if moe_runs_dense(cfg, phase):
        ys = _experts_apply(params, [xt] * e, cfg=cfg, enc=enc, phase=phase,
                            tp=tp)  # (E, T, D)
        wfull = torch.zeros((t, e), dtype=torch.float32, device=x.device)
        wfull.scatter_(1, eidx, gate)
        out = torch.einsum("etd,te->td", ys.float(), wfull)
        return out.to(x.dtype).reshape(b, s, d)

    groups, cap = moe_capacity(cfg, t)
    tg = t // groups
    position, keep = moe_positions(eidx, cfg)
    eidx_g = eidx.reshape(groups, tg, k)
    gate_g = gate.reshape(groups, tg, k)
    xt_g = xt.reshape(groups, tg, d)

    # Dispatch into (G, E, cap, D) buffers: kept pairs own distinct slots,
    # dropped ones add 0 at cap - 1, as JAX's scatter-add does.
    safe_pos = torch.where(keep, position, cap - 1)
    contrib = keep.to(x.dtype)
    gsel = torch.arange(groups, device=x.device)[:, None, None].expand(groups, tg, k)
    buf = torch.zeros((groups, e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((gsel, eidx_g, safe_pos), xt_g[:, :, None, :] * contrib[..., None],
                   accumulate=True)

    buf_e = buf.transpose(0, 1)  # (E, G, cap, D)
    ys = _experts_apply(params, [buf_e[i].reshape(rows, d) for i in range(e)], cfg=cfg,
                        enc=enc, phase=phase, tp=tp).reshape(e, groups, cap, d)

    gathered = ys.transpose(0, 1)[gsel, eidx_g, safe_pos]  # (G, tg, k, D)
    w = (gate_g * keep).float()[..., None]
    out = (gathered.float() * w).sum(dim=2).to(x.dtype)
    return out.reshape(b, s, d)
