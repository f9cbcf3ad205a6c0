"""Attention kernels: GQA flash prefill (causal or not), and decode read
straight from the paged KV pool or from a dense cache (counterpart of
repro/kernels/attn.py: flash_prefill_attention, paged_decode_attention and
dense_decode_attention).

CUDA sources: csrc/flash_prefill.cu, csrc/paged_decode.cu and
csrc/dense_decode.cu, three entries into one body, csrc/decode_attn.cuh,
with two addressing policies (prefill reads its K/V as a dense cache of Sk
slots, every query row at q_offset + i).  Each wrapper launches
its kernel for CUDA tensors and takes its plain version only for tensors on
the CPU.  Head h of a query reads kv head h // G (G = H / KV), i.e. head =
kv*G + j, the JAX package's grouping.  Rows with no valid key come back 0,
never NaN.

The decode kernels take every KV layout of core/encoding.KVLayout: raw
pools in the query's dtype ("bf16": bf16 or f32), int8 pools ("kv8") and
packed-nibble uint8 pools ("kv4", head dim D/2), the quantized ones with
float32 scale pages (..., KV, 1) beside them, dequantized as float(q) *
scale.  Each keeps a launch count per layout (`launches_by_kv`) beside the
total (`launches`).  All three split a row's keys across thread blocks by
one plan, `decode_split_plan`, and merge the splits inside the same launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import encoding
from repro_torch.kernels import build

# The decode kernels' storage codes (csrc/decode_attn.cuh): pools in the
# query's dtype, int8, packed nibbles.
_KV_CODES = {"bf16": 0, "kv8": 1, "kv4": 2}

# The decode kernels' tiling (csrc/decode_attn.cuh: QT, KT): query rows
# (l, j) a block, keys a staged tile (split ranges are multiples of it), and
# the blocks the split plan aims for: two per SM of the H100's 132.
DECODE_TILE_ROWS = 64
DECODE_KEY_TILE = 64
DECODE_TARGET_BLOCKS = 264
DECODE_MAX_SPLITS = 64  # the merge's weights fill a (64 rows, 64 splits) table
SMEM_MAX = 227 * 1024   # shared memory an H100 block may take
# Head dims the body is built for; 256 (RecurrentGemma) on unquantized
# dense caches and prefill only, on the CUDA cores.
HEAD_DIMS = (16, 32, 64, 128)
WIDE_HEAD_DIM = 256


def decode_smem_bytes(itemsize: int, d: int, qt: int, *, tc: bool,
                      kv_quant: str = "bf16") -> tuple[int, int]:
    """(dynamic shared-memory bytes a block takes, K/V buffers) for `qt`
    query rows a tile, mirroring Geo in csrc/decode_attn.cuh: 64-key K and
    V tiles of padded rows, double-buffered where 64 query rows' CUDA-core
    state fits beside them in SMEM_MAX, else single-buffered."""
    lay = encoding.kv_layout(kv_quant)
    elem = 1 if lay.quantized else itemsize
    rb = d * elem // (2 if kv_quant == "kv4" else 1)  # bytes a staged row
    ch = min(rb, 16)
    stage = DECODE_KEY_TILE * (rb + ch)
    buf = 2 * stage + (2 * DECODE_KEY_TILE * 4 if lay.quantized else 0)
    deq = 2 * DECODE_KEY_TILE * (d + 8) * 2 if tc and lay.quantized else 0

    def cuda_rows(n):
        return 0 if tc else (n * d + n * (DECODE_KEY_TILE + 1) + 3 * n) * 4

    nbuf = 2 if 2 * buf + deq + cuda_rows(DECODE_TILE_ROWS) <= SMEM_MAX else 1
    run = nbuf * buf + deq + cuda_rows(qt)
    return max(run, (qt * DECODE_MAX_SPLITS + qt) * 4), nbuf


def decode_split_plan(b: int, kvh: int, L: int, g: int, live_keys: int) -> tuple[int, int]:
    """How the decode kernels split keys across blocks: (splits,
    keys_per_split).  The grid holds b * kvh * tiles * splits blocks (tiles
    = ceil(L * g / 64) query-row tiles); splits is the least count of
    64-key-aligned ranges of `live_keys` keys (the host's bound: the table's
    or the cache's width) of equal size that brings the grid to
    DECODE_TARGET_BLOCKS, at most one range per 64 keys and
    DECODE_MAX_SPLITS ranges, each range holding keys at the bound.  It
    depends on key counts only, never on pages, so the paged and the dense
    kernel run the same split on the same keys."""
    tiles = -(-(L * g) // DECODE_TILE_ROWS)
    chunks = max(1, -(-live_keys // DECODE_KEY_TILE))
    want = min(chunks, DECODE_MAX_SPLITS,
               max(1, -(-DECODE_TARGET_BLOCKS // (b * kvh * tiles))))
    per = chunks // want  # key tiles a split: splits >= want
    return -(-chunks // per), per * DECODE_KEY_TILE


def decode_split_range(split: int, splits: int, keys_per_split: int,
                       n_live: int, first: int = 0) -> tuple[int, int]:
    """Keys [lo, hi) of split `split` in a block whose rows attend keys
    first .. n_live - 1 (n_live <= the plan's live_keys; first 0, or the
    64-aligned start of a prefill band), as the kernel computes them: those
    keys cut into `splits` equal 64-aligned ranges, so a split past the
    row's last key is empty (lo == hi) and writes only an empty state."""
    chunks = max(0, -(-(n_live - first) // DECODE_KEY_TILE))
    per = min(keys_per_split, -(-chunks // splits) * DECODE_KEY_TILE)
    lo = first + split * per
    return lo, max(lo, min(n_live, lo + per))


# Per device: the split counters (one int per (row, kv head, tile)), zeroed
# once when made; every launch leaves them zero again.
_split_counters: dict = {}


def _split_scratch(q: torch.Tensor, kvh: int, live_keys: int):
    """The plan for `q` and, when it splits, the f32 partial-state scratch
    and the counters: (splits, keys_per_split, part, cnt), the last two
    None for a single split."""
    b, L, h, d = q.shape
    g = h // kvh
    splits, kps = decode_split_plan(b, kvh, L, g, live_keys)
    if splits == 1:
        return splits, kps, None, None
    qt = min(DECODE_TILE_ROWS, L * g)
    tiles = -(-(L * g) // DECODE_TILE_ROWS)
    n = b * kvh * tiles
    part = torch.empty(n * splits * qt * (2 + d), dtype=torch.float32, device=q.device)
    cnt = _split_counters.get(q.device)
    if cnt is None or cnt.numel() < n:
        cnt = torch.zeros(max(n, 4096), dtype=torch.int32, device=q.device)
        _split_counters[q.device] = cnt
    return splits, kps, part, cnt


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def masked_softmax(s: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with `valid` masking; rows with no valid
    entry come back all-zero instead of NaN."""
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m) * valid
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def _row_positions(pos, b: int, device) -> torch.Tensor:
    """Scalar or (B,) position of q[:, 0] -> (B,) int64 on `device`.  A
    Python int is filled on the device: copying it from the host would
    wait for the stream to drain (cross attention's decode passes Te - 1
    at every layer)."""
    if not isinstance(pos, torch.Tensor):
        return torch.full((b,), int(pos), dtype=torch.int64, device=device)
    p = pos.to(device=device, dtype=torch.int64)
    return p.reshape(-1).expand(b) if p.dim() == 0 else p


def _live_keys(pos, b: int, L: int, cap: int, device) -> int:
    """Keys 0 .. the last a full-attention window attends, as a count (at
    most `cap`): every key past it is masked for every row."""
    return min(cap, int(_row_positions(pos, b, device).max()) + L)


# ---------------------------------------------------------------------------
# Decode over a cache view, the page pool or a dense cache


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos, window: int = 0) -> torch.Tensor:
    """Decode attention over a dense (B, S_c, KV, D) view: query l of row b
    sits at pos[b] + l and attends slots <= pos[b] + l (masked-causal inside
    an L > 1 window).  With `window` > 0 the cache is a ring of S_c slots
    holding the last positions (L = 1 only): rows still inside their first
    window take the prefix mask, wrapped rows the ring age
    (qpos - slot) mod S_c < min(qpos + 1, window), as JAX's
    layers.attention_decode.  q (B, L, H, D) -> (B, L, H, D) in q's dtype."""
    b, L, h, d = q.shape
    s_c, kvh = k_cache.shape[1], k_cache.shape[2]
    if L > 1 and window:
        raise ValueError(f"an L > 1 window needs full attention (window 0), got {window}")
    g = h // kvh
    qg = q.float().reshape(b, L, kvh, g, d) * d**-0.5
    s = torch.einsum("blkgd,bskd->blkgs", qg, k_cache.float())
    qpos = _row_positions(pos, b, q.device)[:, None] + torch.arange(L, device=q.device)
    qpos = qpos[..., None]  # (B, L, 1)
    slot = torch.arange(s_c, device=q.device)
    if window > 0:
        ring = torch.remainder(qpos - slot, s_c) < torch.clamp(qpos + 1, max=window)
        valid = torch.where(qpos < window, slot <= qpos, ring)
    else:
        valid = slot <= qpos  # (B, L, S_c)
    p = masked_softmax(s, valid[:, :, None, None, :])
    out = torch.einsum("blkgs,bskd->blkgd", p, v_cache.float())
    return out.reshape(b, L, h, d).to(q.dtype)


def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(P, bs, KV, D) pool + (B, NB) page ids -> (B, NB*bs, KV, D) view of
    each row's logical positions, in order."""
    b, nb = table.shape
    return pool[table.long()].reshape(b, nb * pool.shape[1], *pool.shape[2:])


def _dequant(kv_quant: str, k, v, k_scale, v_scale):
    """Quantized K/V and their scales -> float32 K/V (bf16 passes through)."""
    if kv_quant == "bf16":
        return k, v
    lay = encoding.kv_layout(kv_quant)
    return lay.dequantize(k, k_scale), lay.dequantize(v, v_scale)


def paged_decode_attention_plain(q, k_pool, v_pool, table, pos, *, k_scale=None,
                                 v_scale=None, kv_quant: str = "bf16") -> torch.Tensor:
    """What the paged kernel computes, in plain PyTorch: gather the live
    keys of every row's table (and their scale pages), dequantize, then
    decode attention over that view."""
    b, L = q.shape[:2]
    bs = k_pool.shape[1]
    live = _live_keys(pos, b, L, table.shape[1] * bs, q.device)
    t = table[:, : -(-live // bs)]

    def view(pool):
        return None if pool is None else paged_gather(pool, t)[:, :live].contiguous()

    k, v = _dequant(kv_quant, view(k_pool), view(v_pool), view(k_scale), view(v_scale))
    return decode_attention_plain(q, k, v, pos)


def dense_decode_attention_plain(q, k_cache, v_cache, pos, *, window: int = 0, k_scale=None,
                                 v_scale=None, kv_quant: str = "bf16") -> torch.Tensor:
    """What the dense kernel computes, in plain PyTorch: (full attention) the
    live keys of the (B, S_c, KV, Ds) cache, or (a ring window) all S_c
    slots, dequantized, then decode attention with the window's mask.  With
    a page table that is the identity this equals the paged version bit for
    bit: the same keys go through the same operations."""
    b, L = q.shape[:2]
    live = k_cache.shape[1]
    if window == 0:
        live = _live_keys(pos, b, L, live, q.device)

    def view(c):
        return None if c is None else c[:, :live].contiguous()

    k, v = _dequant(kv_quant, view(k_cache), view(v_cache), view(k_scale), view(v_scale))
    return decode_attention_plain(q, k, v, pos, window)


def _check_decode(name, q, k, v, k_scale, v_scale, kv_quant, lead_ok) -> None:
    """Shapes, layout and dtypes a decode wrapper takes (both devices)."""
    lay = encoding.kv_layout(kv_quant)
    b, L, h, d = q.shape
    kvh, ds = k.shape[2], k.shape[3]
    if v.shape != k.shape or not lead_ok or h % kvh or ds != lay.storage_head_dim(d):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k/v {tuple(k.shape)} / "
                         f"{tuple(v.shape)} do not fit kv_quant={kv_quant!r}")
    if lay.quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: kv_quant={kv_quant!r} takes scale pages exactly when "
                         "it is quantized")
    want = lay.storage_dtype if lay.quantized else q.dtype
    if k.dtype != want or v.dtype != want:
        raise ValueError(f"{name}: {kv_quant} K/V of dtype {k.dtype}/{v.dtype}, want {want}")
    if lay.quantized:
        sshape = (*k.shape[:3], 1)
        if (tuple(k_scale.shape) != sshape or tuple(v_scale.shape) != sshape
                or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
            raise ValueError(f"{name}: scales must be float32 of shape {sshape}")


def _check_card(name: str, q: torch.Tensor, kvh: int, *, wide: bool) -> None:
    """What the shared body takes on the card (csrc/decode_attn.cuh): D in
    HEAD_DIMS, or WIDE_HEAD_DIM where `wide` (unquantized dense caches and
    prefill).  A shape it refuses raises; it never falls back to the plain
    version."""
    if q.device.type != "cuda":
        raise RuntimeError(f"{name} runs on cuda (or cpu: plain), not {q.device}")
    b, L, h, d = q.shape
    dims = HEAD_DIMS + ((WIDE_HEAD_DIM,) if wide else ())
    if d not in dims or h // kvh > 32 or L > 65535:
        raise ValueError(f"{name} kernel takes D in {dims}, G <= 32 and "
                         f"L <= 65535, got D={d}, G={h // kvh}, L={L}")


def _scale_ptrs(k_scale, v_scale):
    if k_scale is None:
        return None, None
    return build.aligned(k_scale).data_ptr(), build.aligned(v_scale).data_ptr()


@functools.cache
def _paged_kernel():
    return build.entry(
        "paged_decode", "paged_decode_attention",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           table: torch.Tensor, pos, *, k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           kv_quant: str = "bf16") -> torch.Tensor:
    """q (B, L, H, D) against pools (P, bs, KV, Ds) through table (B, NB)
    int32 and pos (B,) int32 (position of q[:, 0]), any window L (the kernel
    tiles the L*G query rows 64 at a time and splits keys by
    decode_split_plan over the table's NB*bs keys).  `kv_quant` names the pools'
    layout; kv8/kv4 take `k_scale`/`v_scale` pages (P, bs, KV, 1) float32.
    Only live pages are read.  Plain version on the CPU; on a CUDA tensor
    the kernel runs or this raises."""
    b, L, h, d = q.shape
    _, bs, kvh, _ = k_pool.shape
    _check_decode("paged_decode_attention", q, k_pool, v_pool, k_scale, v_scale, kv_quant,
                  table.shape[0] == b)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, table, pos, k_scale=k_scale,
                                            v_scale=v_scale, kv_quant=kv_quant)
    _check_card("paged_decode_attention", q, kvh, wide=False)
    q, k_pool, v_pool = build.aligned(q), build.aligned(k_pool), build.aligned(v_pool)
    ks, vs = _scale_ptrs(k_scale, v_scale)
    table = table.to(torch.int32).contiguous()
    posv = _row_positions(pos, b, q.device).to(torch.int32).contiguous()
    out = torch.empty_like(q)
    splits, kps, part, cnt = _split_scratch(q, kvh, table.shape[1] * bs)
    err = _paged_kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs, table.data_ptr(),
        posv.data_ptr(), out.data_ptr(), _ptr(part), _ptr(cnt), b, L, h, kvh, d, bs,
        table.shape[1], splits, kps, d**-0.5, build.dtype_code(q.dtype), _KV_CODES[kv_quant],
        build.stream_ptr(q.device),
    )
    build.check(err, "paged_decode", "paged_decode_attention launch")
    paged_decode_attention.launches += 1
    paged_decode_attention.launches_by_kv[kv_quant] += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_by_kv = dict.fromkeys(encoding.KV_QUANTS, 0)


@functools.cache
def _dense_kernel():
    return build.entry(
        "dense_decode", "dense_decode_attention",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )


def dense_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           pos, *, window: int = 0, k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           kv_quant: str = "bf16") -> torch.Tensor:
    """q (B, L, H, D) against a dense cache (B, S_c, KV, Ds); pos scalar or
    (B,), the position of q[:, 0].  `window` 0 is full attention over slots
    <= pos + l (any L, masked-causal); `window` > 0 a ring cache (L = 1,
    bf16/f32 only).  kv8/kv4 take `k_scale`/`v_scale` (B, S_c, KV, 1)
    float32.  Plain version on the CPU; on a CUDA tensor the kernel runs or
    this raises."""
    b, L, h, d = q.shape
    _, s_c, kvh, _ = k_cache.shape
    if window < 0 or (window and (L > 1 or kv_quant != "bf16")):
        raise ValueError(f"dense_decode_attention: window={window} takes L = 1 and "
                         f"unquantized caches, got L={L}, kv_quant={kv_quant!r}")
    _check_decode("dense_decode_attention", q, k_cache, v_cache, k_scale, v_scale, kv_quant,
                  k_cache.shape[0] == b)
    if q.device.type == "cpu":
        return dense_decode_attention_plain(q, k_cache, v_cache, pos, window=window,
                                            k_scale=k_scale, v_scale=v_scale,
                                            kv_quant=kv_quant)
    _check_card("dense_decode_attention", q, kvh, wide=kv_quant == "bf16")
    q, k_cache, v_cache = build.aligned(q), build.aligned(k_cache), build.aligned(v_cache)
    ks, vs = _scale_ptrs(k_scale, v_scale)
    posv = _row_positions(pos, b, q.device).to(torch.int32).contiguous()
    out = torch.empty_like(q)
    splits, kps, part, cnt = _split_scratch(q, kvh, s_c)
    err = _dense_kernel()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ks, vs, posv.data_ptr(),
        out.data_ptr(), _ptr(part), _ptr(cnt), b, L, h, kvh, d, s_c, window, splits, kps,
        d**-0.5,
        build.dtype_code(q.dtype), _KV_CODES[kv_quant], build.stream_ptr(q.device),
    )
    build.check(err, "dense_decode", "dense_decode_attention launch")
    dense_decode_attention.launches += 1
    dense_decode_attention.launches_by_kv[kv_quant] += 1
    return out


dense_decode_attention.launches = 0
dense_decode_attention.launches_by_kv = dict.fromkeys(encoding.KV_QUANTS, 0)


# ---------------------------------------------------------------------------
# Flash prefill


def flash_prefill_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                                  q_offset: int = 0) -> torch.Tensor:
    """What the flash kernel computes, in plain PyTorch: the full masked
    score matrix.  q (B, Sq, H, D); k, v (B, Sk, KV, D); query i sits at
    q_offset + i."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, sq, kvh, g, d) * d**-0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    valid = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        valid &= kpos <= qpos
    if window > 0:
        valid &= kpos > qpos - window
    p = masked_softmax(s, valid)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


@functools.cache
def _flash_kernel():
    return build.entry(
        "flash_prefill", "flash_prefill_attention",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    )


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            q_offset: int = 0) -> torch.Tensor:
    """Tiled GQA prefill, causal (key tiles above the diagonal, q_offset
    included, or below a `window` band are never read) or with causal=False
    every query over all Sk keys (an encoder; cross attention, Sq != Sk).
    The card runs the decode kernels' body over K/V as a dense cache (split by
    decode_split_plan over the Sk keys, as dense decode does), so with
    causal=True, window=0 it gives dense_decode_attention's bits for
    pos = q_offset.  Plain version on the CPU; on a CUDA tensor the kernel
    runs or this raises."""
    b, sq, h, d = q.shape
    _, sk, kvh, dk = k.shape
    if dk != d or v.shape != k.shape or k.shape[0] != b or h % kvh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v, causal=causal, window=window,
                                             q_offset=q_offset)
    _check_card("flash_prefill_attention", q, kvh, wide=True)
    if sk < 1 or q_offset < 0 or window < 0:
        raise ValueError(f"flash kernel takes Sk >= 1, q_offset >= 0 and window >= 0, "
                         f"got Sk={sk}, q_offset={q_offset}, window={window}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"k/v dtype {k.dtype}/{v.dtype} != query dtype {q.dtype}")
    q, k, v = build.aligned(q), build.aligned(k), build.aligned(v)
    out = torch.empty_like(q)
    splits, kps, part, cnt = _split_scratch(q, kvh, sk)
    err = _flash_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(part), _ptr(cnt),
        b, sq, sk, h, kvh, d, q_offset, int(causal), window, splits, kps, d**-0.5,
        build.dtype_code(q.dtype), build.stream_ptr(q.device),
    )
    build.check(err, "flash_prefill", "flash_prefill_attention launch")
    flash_prefill_attention.launches += 1
    flash_prefill_attention.launches_noncausal += not causal
    return out


flash_prefill_attention.launches = 0
flash_prefill_attention.launches_noncausal = 0  # the causal=False share of `launches`
