"""Device-encoding vocabulary of the port (counterpart of repro/core/encoding.py).

Layouts are the paper's, unchanged:

    pack(lhs, (M0, K0)) : (M, K)            -> (M1, K1, M0, K0)
    pack(rhs, (N0, K0)) : (N, K)  [= W^T]   -> (N1, K1, N0, K0)
    mmt4d(lhs4, rhs4)   :                   -> (M1, N1, M0, N0), f32 accumulate
    unpack(out4, (M,N)) : (M1, N1, M0, N0)  -> (M, N)

Weights are packed once at (N0, K0) = (128, 128) whatever the card: that is
the layout the JAX package stores, so converted parameters map 1:1 onto the
port's tensors.  The CUDA kernels choose their own thread-block tiles inside
that layout (kernels/fused_gemv.py, kernels/fused_pack_mmt4d.py).
"""

from __future__ import annotations

import dataclasses
import enum
import math

import torch

# Pack tile of every stored weight (N0 = K0); see the module docstring.
PACK_TILE = 128
# Most decode rows the GEMV kernel takes (kernels/fused_gemv.py).  More rows
# are a GEMM-shaped problem.
GEMV_MAX_ROWS = 8


class Phase(enum.Enum):
    """Execution phase: the matmul shape regime differs per phase."""

    PREFILL = "prefill"   # GEMM: M = batch*seq rows
    DECODE = "decode"     # GEMV-class: M = batch rows (1 token each)
    TRAIN = "train"       # GEMM, fwd+bwd


@dataclasses.dataclass(frozen=True)
class TileSizes:
    m0: int
    n0: int
    k0: int

    def as_tuple(self) -> tuple[int, int, int]:
        return (self.m0, self.n0, self.k0)


def select_tile_sizes(phase: Phase, *, m_hint: int | None = None) -> TileSizes:
    """Pack tiles per phase.  N0 and K0 are the stored weight tile.  M0 is
    128 rows for the GEMM phases and min(rows, GEMV_MAX_ROWS) at decode.

    The H100 rule for the packed path (backend "pallas", and "xla", which
    packs the same way): decode with at most 8 rows is one row block (M1 =
    1) that the packed GEMV takes unpadded; more decode rows (a verify or
    mixed window, many slots) pack into M1 = ceil(rows / 8) blocks of 8 for
    the packed GEMM.  The GEMM flattens (m1, m0) rows into its own row
    tiles (csrc/mmt4d.cu: up to 64 rows a block in the skinny split-K body,
    padded to 8 for mma.sync; 64 or 128 in the wide wgmma body, whose TMA
    box lands 8 or 16 whole row blocks of 8), so a larger M0 would buy it
    nothing and only pad more rows; 8 keeps the pad under one row block.
    Pad rows are zero, so the result is exact whatever M0 is."""
    if phase in (Phase.PREFILL, Phase.TRAIN):
        return TileSizes(PACK_TILE, PACK_TILE, PACK_TILE)
    rows = m_hint if m_hint is not None else 1
    return TileSizes(max(1, min(GEMV_MAX_ROWS, rows)), PACK_TILE, PACK_TILE)


def _round_up(x: int, mult: int) -> int:
    return mult * math.ceil(x / mult) if mult > 0 else x


def padded_dim(dim: int, tile: int) -> int:
    return _round_up(dim, tile)


def packed_shape(rows: int, cols: int, t0: int, t1: int) -> tuple[int, int, int, int]:
    return (math.ceil(rows / t0), math.ceil(cols / t1), t0, t1)


def quant_weight_stream_bytes(n: int, k: int, *, quant: str = "none", weight_itemsize: int = 2,
                              group: int = 16) -> int:
    """Bytes one decode step streams for a W (n, k) projection, per weight
    format (the weight is read once per step):
      none : n*k*weight_itemsize                  (bf16: 2 bytes/weight)
      w8a8 : n*k + n*4                            (int8 + per-channel f32)
      w4a8 : n*k/2 + n*ceil(k/group)*2            (nibbles + bf16 group scales)"""
    if quant == "none":
        return n * k * weight_itemsize
    if quant == "w8a8":
        return n * k + n * 4
    if quant == "w4a8":
        return n * (k // 2) + n * math.ceil(k / group) * 2
    raise ValueError(f"unknown quant mode {quant!r}")


# ---------------------------------------------------------------------------
# Quantized KV-cache layouts (kv8 / kv4): the JAX package's KVLayout codec.
#
# K/V pages are stored int8 (kv8) or as packed int4 nibbles (kv4) with one
# float32 scale per (token, kv head) in parallel scale pages of the same
# page geometry, so one page id addresses a token block's data and its
# scales.  The paged and dense decode kernels (kernels/attn.py) dequantize
# in registers, float(q) * scale, before the online-softmax accumulate.

KV_QUANTS = ("bf16", "kv8", "kv4")
KV_SCALE_ITEMSIZE = 4  # float32 scale per (token, kv head)


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(..., hd//2) packed uint8 -> (..., hd) int32 in [-8, 7].  Even dims
    live in the low nibble, odd dims in the high nibble (two's complement)."""
    b = packed.to(torch.int32)
    lo = b & 0xF
    hi = (b >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(*b.shape[:-1], b.shape[-1] * 2)


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """(..., hd) int32 in [-8, 7] -> (..., hd//2) uint8 (inverse of _unpack_nibbles)."""
    lo = q[..., 0::2] & 0xF
    hi = q[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class KVLayout:
    """One KV-cache storage layout: dtype, scale shape, codec, byte accounting.

    Scales are per (token, kv head): decode writes single tokens into pages,
    so a per-page scalar would re-scale tokens already written."""

    name: str
    storage_dtype: torch.dtype | None  # None = keep the model activation dtype
    pack_ratio: int                    # head_dim elements per storage element
    qmax: int                          # symmetric integer clip bound (0 = unquantized)

    @property
    def quantized(self) -> bool:
        return self.qmax > 0

    def storage_head_dim(self, head_dim: int) -> int:
        if self.pack_ratio > 1 and head_dim % self.pack_ratio:
            raise ValueError(f"{self.name}: head_dim {head_dim} not divisible by pack "
                             f"ratio {self.pack_ratio}")
        return head_dim // self.pack_ratio

    def scale_shape(self, lead: tuple[int, ...], num_kv_heads: int) -> tuple[int, ...]:
        """Shape of the scale leaf beside data-leaf leading dims `lead`
        ((num_pages, block) or (batch, seq)); heads stay at axis -2."""
        return (*lead, num_kv_heads, 1)

    def bytes_per_token_per_head(self, head_dim: int) -> float:
        if not self.quantized:
            return float(head_dim * 2)  # bf16 storage, no scales
        return float(self.storage_head_dim(head_dim) * self.storage_dtype.itemsize
                     + KV_SCALE_ITEMSIZE)

    def quantize(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(..., hd) float -> (q (..., hd / pack_ratio) storage dtype, scale
        (..., 1) float32): symmetric abs-max per (token, head) row, in the
        JAX package's order (f32 abs-max, max(amax, 1e-8) / qmax, f32
        division, round half to even, clip), so the codes and scales are
        equal bit for bit."""
        assert self.quantized, f"{self.name} has no codec"
        xf = x.float()
        amax = xf.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp(amax, min=1e-8) / self.qmax
        q = torch.clamp(torch.round(xf / scale), -self.qmax, self.qmax).to(torch.int32)
        if self.pack_ratio > 1:
            return _pack_nibbles(q), scale
        return q.to(self.storage_dtype), scale

    def dequantize(self, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """Inverse of `quantize` -> float32: float(q) * scale."""
        assert self.quantized, f"{self.name} has no codec"
        vals = _unpack_nibbles(q) if self.pack_ratio > 1 else q.to(torch.int32)
        return vals.float() * scale


_KV_LAYOUTS = {
    "bf16": KVLayout(name="bf16", storage_dtype=None, pack_ratio=1, qmax=0),
    "kv8": KVLayout(name="kv8", storage_dtype=torch.int8, pack_ratio=1, qmax=127),
    "kv4": KVLayout(name="kv4", storage_dtype=torch.uint8, pack_ratio=2, qmax=7),
}


def kv_layout(name: str) -> KVLayout:
    try:
        return _KV_LAYOUTS[name]
    except KeyError:
        raise ValueError(f"unknown kv_quant {name!r}; expected one of {KV_QUANTS}") from None


def kv_layout_for_storage(dtype: torch.dtype) -> KVLayout:
    """The layout of a cache leaf's dtype: int8 pools are kv8, packed uint8
    pools kv4, float pools bf16 (caches describe themselves)."""
    if dtype == torch.int8:
        return _KV_LAYOUTS["kv8"]
    if dtype == torch.uint8:
        return _KV_LAYOUTS["kv4"]
    return _KV_LAYOUTS["bf16"]


def kv_bytes_per_token(num_layers: int, num_kv_heads: int, head_dim: int, *,
                       itemsize: int = 2, kv_quant: str = "bf16") -> int:
    """Device bytes one cached token costs across all layers (K and V).
    Quantized layouts price storage plus the float32 scale; `itemsize`
    prices bf16 only."""
    if kv_quant in (None, "bf16"):
        return 2 * num_layers * num_kv_heads * head_dim * itemsize
    per_head = kv_layout(kv_quant).bytes_per_token_per_head(head_dim)
    return int(2 * num_layers * num_kv_heads * per_head)
