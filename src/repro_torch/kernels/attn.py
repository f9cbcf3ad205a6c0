"""Attention kernels: causal GQA flash prefill and decode read straight from
the paged KV pool (counterpart of repro/kernels/attn.py:
flash_prefill_attention and paged_decode_attention).

CUDA sources: csrc/flash_prefill.cu and csrc/paged_decode.cu.  Each wrapper
launches its kernel for CUDA tensors and takes its plain version only for
tensors on the CPU.  Head h of a query reads kv head h // G (G = H / KV),
i.e. head = kv*G + j, the JAX package's grouping.  Rows with no valid key
come back 0, never NaN.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


def masked_softmax(s: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with `valid` masking; rows with no valid
    entry come back all-zero instead of NaN."""
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m) * valid
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def _row_positions(pos, b: int, device) -> torch.Tensor:
    """Scalar or (B,) position of q[:, 0] -> (B,) int64 on `device`."""
    p = torch.as_tensor(pos, device=device).to(torch.int64)
    return p.reshape(-1).expand(b) if p.dim() == 0 else p


# ---------------------------------------------------------------------------
# Decode over a cache view / the page pool


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos) -> torch.Tensor:
    """Decode attention over a dense (B, S_c, KV, D) view: query l of row b
    sits at pos[b] + l and attends slots <= pos[b] + l (masked-causal inside
    an L > 1 window).  q (B, L, H, D) -> (B, L, H, D) in q's dtype."""
    b, L, h, d = q.shape
    s_c, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, L, kvh, g, d) * d**-0.5
    s = torch.einsum("blkgd,bskd->blkgs", qg, k_cache.float())
    qpos = _row_positions(pos, b, q.device)[:, None] + torch.arange(L, device=q.device)
    valid = torch.arange(s_c, device=q.device) <= qpos[..., None]  # (B, L, S_c)
    p = masked_softmax(s, valid[:, :, None, None, :])
    out = torch.einsum("blkgs,bskd->blkgd", p, v_cache.float())
    return out.reshape(b, L, h, d).to(q.dtype)


def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(P, bs, KV, D) pool + (B, NB) page ids -> (B, NB*bs, KV, D) view of
    each row's logical positions, in order."""
    b, nb = table.shape
    return pool[table.long()].reshape(b, nb * pool.shape[1], *pool.shape[2:])


def paged_decode_attention_plain(q, k_pool, v_pool, table, pos) -> torch.Tensor:
    """What the paged kernel computes, in plain PyTorch: gather the live
    blocks of every row's table, then decode attention over that view."""
    bs = k_pool.shape[1]
    L = q.shape[1]
    last = int(_row_positions(pos, q.shape[0], q.device).max()) + L - 1
    live = min(table.shape[1], last // bs + 1)
    return decode_attention_plain(
        q, paged_gather(k_pool, table[:, :live]), paged_gather(v_pool, table[:, :live]), pos
    )


@functools.cache
def _paged_kernel():
    return build.entry(
        "paged_decode", "paged_decode_attention",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    )


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           table: torch.Tensor, pos, *, kv_quant: str = "bf16") -> torch.Tensor:
    """q (B, L, H, D) against pools (P, bs, KV, D) through table (B, NB) int32
    and pos (B,) int32 (position of q[:, 0]), any window L (the kernel tiles
    the L*G query rows 32 at a time).  Only live pages are read.  Plain
    version on the CPU; on a CUDA tensor the kernel runs or this raises."""
    if kv_quant != "bf16":
        raise NotImplementedError(
            f"paged_decode_attention: kv_quant={kv_quant!r} waits for the "
            "quantized-KV slice (ROADMAP, TPU kernels to port)"
        )
    b, L, h, d = q.shape
    _, bs, kvh, dk = k_pool.shape
    if dk != d or v_pool.shape != k_pool.shape or table.shape[0] != b or h % kvh:
        raise ValueError(f"shapes q {tuple(q.shape)}, pools {tuple(k_pool.shape)}, "
                         f"table {tuple(table.shape)} do not fit")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, table, pos)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_decode_attention runs on cuda (or cpu: plain), not {q.device}")
    if d not in (16, 32, 64, 128) or h // kvh > 32:
        raise ValueError(f"paged decode kernel takes D in 16/32/64/128 and "
                         f"G <= 32, got D={d}, G={h // kvh}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"pool dtype {k_pool.dtype} != query dtype {q.dtype}")
    q, k_pool, v_pool = build.aligned(q), build.aligned(k_pool), build.aligned(v_pool)
    table = table.to(torch.int32).contiguous()
    posv = _row_positions(pos, b, q.device).to(torch.int32).contiguous()
    out = torch.empty_like(q)
    err = _paged_kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        posv.data_ptr(), out.data_ptr(), b, L, h, kvh, d, bs, table.shape[1],
        d**-0.5, build.dtype_code(q.dtype), build.stream_ptr(q.device),
    )
    build.check(err, "paged_decode", "paged_decode_attention launch")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


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
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    )


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            q_offset: int = 0) -> torch.Tensor:
    """Tiled causal GQA prefill; chunks above the diagonal (q_offset
    included) are never read.  Plain version on the CPU; on a CUDA tensor
    the kernel runs or this raises."""
    b, sq, h, d = q.shape
    _, sk, kvh, dk = k.shape
    if dk != d or v.shape != k.shape or k.shape[0] != b or h % kvh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v, causal=causal, window=window,
                                             q_offset=q_offset)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_prefill_attention runs on cuda (or cpu: plain), not {q.device}")
    if d not in (16, 32, 64, 128) or (h // kvh) * 32 > 1024:
        raise ValueError(f"flash kernel takes D in 16/32/64/128 and G <= 32, "
                         f"got D={d}, G={h // kvh}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"k/v dtype {k.dtype}/{v.dtype} != query dtype {q.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    err = _flash_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, h, kvh,
        d, q_offset, int(causal), window, d**-0.5, build.dtype_code(q.dtype),
        build.stream_ptr(q.device),
    )
    build.check(err, "flash_prefill", "flash_prefill_attention launch")
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0
