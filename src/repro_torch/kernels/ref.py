"""Plain PyTorch oracles for the packed layout (counterpart of repro/kernels/ref.py).

pack/unpack are exact relayouts; mmt4d and matmul_reference accumulate in
float32.  The int8/int4 quantizers wait for the quantized-weight slice
(ROADMAP).
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


def matmul_reference(lhs: torch.Tensor, rhs_t: torch.Tensor) -> torch.Tensor:
    """The un-encoded baseline: plain (M, K) x (N, K)^T contraction in f32."""
    return lhs.float() @ rhs_t.float().t()
