"""Plain PyTorch oracles for the packed layout (counterpart of repro/kernels/ref.py).

pack/unpack are exact relayouts; mmt4d and matmul_reference accumulate in
float32.  The int8 (w8a8) and group-int4 (w4a8) quantizers are transcribed
operation for operation from the JAX package, so the same inputs give the
same codes and scales bit for bit.  mmt4d_q8 sums its int8 products in
float64, where every sum below 2**53 is exact (PyTorch has no int32 matmul
on CUDA tensors), so it equals an int32 accumulation on either device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pack(x: torch.Tensor, tile: tuple[int, int]) -> torch.Tensor:
    """tensor.pack: (R, C) -> (R1, C1, T0, T1), zero-padded, tiles contiguous."""
    t0, t1 = tile
    r, c = x.shape
    r1 = math.ceil(r / t0)
    c1 = math.ceil(c / t1)
    xp = F.pad(x, (0, c1 * t1 - c, 0, r1 * t0 - r))
    return xp.reshape(r1, t0, c1, t1).permute(0, 2, 1, 3).contiguous()


def unpack(y: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """tensor.unpack: (R1, C1, T0, T1) -> (R, C), cropping pad."""
    r1, c1, t0, t1 = y.shape
    r, c = shape
    return y.permute(0, 2, 1, 3).reshape(r1 * t0, c1 * t1)[:r, :c]


def mmt4d(lhs4: torch.Tensor, rhs4: torch.Tensor) -> torch.Tensor:
    """linalg.mmt4d: lhs (M1,K1,M0,K0) x rhs (N1,K1,N0,K0) -> (M1,N1,M0,N0) f32.

    out[m1,n1,m0,n0] = sum_{k1,k0} lhs[m1,k1,m0,k0] * rhs[n1,k1,n0,k0]."""
    return torch.einsum("mkac,nkbc->mnab", lhs4.float(), rhs4.float())


def batch_mmt4d(lhs5: torch.Tensor, rhs5: torch.Tensor) -> torch.Tensor:
    """linalg.batch_mmt4d: lhs (B,M1,K1,M0,K0) x rhs (B,N1,K1,N0,K0) ->
    (B,M1,N1,M0,N0) f32, accumulated in f32 (repro's batch_mmt4d_ref)."""
    return torch.einsum("zmkac,znkbc->zmnab", lhs5.float(), rhs5.float())


def matmul_reference(lhs: torch.Tensor, rhs_t: torch.Tensor) -> torch.Tensor:
    """The un-encoded baseline: plain (M, K) x (N, K)^T contraction in f32."""
    return lhs.float() @ rhs_t.float().t()


# ---- int8 serving quantization (w8a8; kernels/mmt4d_q8.py) ---------------------


def quantize_rows(x2d: torch.Tensor, amax: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: returns (q (R, C) int8, scale (R,) f32).
    `amax` (R,), where given, replaces the rows' own absmax (a row whose
    other columns lie on other tensor-parallel ranks)."""
    xf = x2d.float()
    if amax is None:
        amax = xf.abs().amax(dim=1)
    s = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[:, None]), -127, 127)
    return q.to(torch.int8), s


_CLIP_RATIOS = (1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7)


def quantize_rows_mse(
    x2d: torch.Tensor, ratios: tuple[float, ...] = _CLIP_RATIOS
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 with the MSE-optimal clip among `ratios`
    (weights only; activations keep plain absmax).  A later ratio replaces
    the kept one only where its error is strictly smaller."""
    xf = x2d.float()
    amax = torch.clamp(xf.abs().amax(dim=1), min=1e-8)
    best_err = best_q = best_s = None
    for r in ratios:
        s = amax * (r / 127.0)
        q = torch.clamp(torch.round(xf / s[:, None]), -127, 127)
        err = torch.sum(torch.square(q * s[:, None] - xf), dim=1)
        if best_err is None:
            best_err, best_q, best_s = err, q, s
        else:
            upd = err < best_err
            best_q = torch.where(upd[:, None], q, best_q)
            best_s = torch.where(upd, s, best_s)
            best_err = torch.minimum(err, best_err)
    return best_q.to(torch.int8), best_s


def int_contract(lhs: torch.Tensor, rhs: torch.Tensor, spec: str) -> torch.Tensor:
    """einsum of int8 operands, exact, as f32 (= float(int32 sum))."""
    return torch.einsum(spec, lhs.double(), rhs.double()).float()


def mmt4d_q8(lhs4_q: torch.Tensor, rhs4_q: torch.Tensor, s_a: torch.Tensor,
             s_w: torch.Tensor) -> torch.Tensor:
    """w8a8 mmt4d: int8 (M1,K1,M0,K0) x int8 (N1,K1,N0,K0), exact integer
    sum, then (acc * s_a[m1,m0]) * s_w[n1,n0] in f32 -> (M1,N1,M0,N0)."""
    acc = int_contract(lhs4_q, rhs4_q, "mkac,nkbc->mnab")
    return acc * s_a[:, None, :, None] * s_w[None, :, None, :]


# ---- int4 group-quantized serving (w4a8; kernels/mmt4d_q4.py) -------------------

# K elements sharing one int4 scale (the serving default; 32 is the
# llama.cpp-Q4_0 block).  The kernels take 16 and 32.
Q4_GROUP = 16


def quantize_rows_q4_grouped(
    x2d: torch.Tensor,
    group: int = Q4_GROUP,
    ratios: tuple[float, ...] = _CLIP_RATIOS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(row, K-group) int4 with the MSE-optimal clip.

    Returns (q (R, C) int8 in [-7, 7], scales (R, ceil(C/group)) f32).  C is
    zero-padded to a group multiple internally; padded columns quantize to
    0 and never contribute."""
    r, c = x2d.shape
    gcount = math.ceil(c / group)
    xf = F.pad(x2d.float(), (0, gcount * group - c))
    xg = xf.reshape(r, gcount, group)
    amax = torch.clamp(xg.abs().amax(dim=2), min=1e-8)  # (R, G)
    best_err = best_q = best_s = None
    for ratio in ratios:
        s = amax * (ratio / 7.0)
        q = torch.clamp(torch.round(xg / s[..., None]), -7, 7)
        err = torch.sum(torch.square(q * s[..., None] - xg), dim=2)
        if best_err is None:
            best_err, best_q, best_s = err, q, s
        else:
            upd = err < best_err
            best_q = torch.where(upd[..., None], q, best_q)
            best_s = torch.where(upd, s, best_s)
            best_err = torch.minimum(err, best_err)
    return best_q.reshape(r, -1)[:, :c].to(torch.int8), best_s


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """int4-valued int8 (..., C) -> uint8 (..., C/2), two's-complement
    nibbles: byte j holds element 2j in its low nibble, 2j+1 in its high."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack_nibbles needs an even last dim, got {tuple(q.shape)}")
    qi = q.to(torch.int32) & 0xF
    return (qi[..., 0::2] | (qi[..., 1::2] << 4)).to(torch.uint8)


def unpack_nibbles(b: torch.Tensor) -> torch.Tensor:
    """uint8 (..., P) -> int32 in [-8, 7] (..., 2P), inverse of pack_nibbles."""
    bi = b.to(torch.int32)
    lo = ((bi & 0xF) ^ 8) - 8
    hi = ((bi >> 4) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*b.shape[:-1], 2 * b.shape[-1])


def dequant_rhs4_q4(rhs4_p: torch.Tensor, s_w4: torch.Tensor, group: int = Q4_GROUP,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Nibble-packed rhs (N1, K1, N0, K0/2) + scales (N1, K1, N0, K0/group)
    -> (N1, K1, N0, K0) in `dtype`, the dequantized packed weight (each
    element w_q * s is exact in f32)."""
    w = unpack_nibbles(rhs4_p).to(dtype)
    return w * s_w4.to(dtype).repeat_interleave(group, dim=-1)


def mmt4d_q4(lhs4_q: torch.Tensor, rhs4_p: torch.Tensor, s_a: torch.Tensor,
             s_w4: torch.Tensor, group: int = Q4_GROUP) -> torch.Tensor:
    """w4a8 mmt4d: int8 lhs (M1,K1,M0,K0) x the dequantized int4 weight, then
    * s_a[m1,m0].  The sum runs in float64, where it is exact (every term
    a_q * w_q * s has at most 19 significant bits; exact while a row's group
    scales span less than 2**21), and rounds to f32 once: the CUDA kernels'
    arithmetic, in any order of summation.  The JAX oracle sums in f32."""
    w = dequant_rhs4_q4(rhs4_p, s_w4, group, dtype=torch.float64)
    acc = torch.einsum("mkac,nkbc->mnab", lhs4_q.double(), w).float()
    return acc * s_a[:, None, :, None]
