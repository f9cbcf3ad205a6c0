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
    128 rows for the GEMM phases and the live decode rows (at most
    GEMV_MAX_ROWS) at decode, where no row is padded."""
    if phase in (Phase.PREFILL, Phase.TRAIN):
        return TileSizes(PACK_TILE, PACK_TILE, PACK_TILE)
    rows = m_hint if m_hint is not None else 1
    return TileSizes(max(1, min(GEMV_MAX_ROWS, rows)), PACK_TILE, PACK_TILE)


# KV-cache storage layouts.  Only bf16 (raw activation dtype) runs in the
# port so far; kv8/kv4 wait for the quantized-KV slice (ROADMAP).
KV_QUANTS = ("bf16", "kv8", "kv4")


def _round_up(x: int, mult: int) -> int:
    return mult * math.ceil(x / mult) if mult > 0 else x


def padded_dim(dim: int, tile: int) -> int:
    return _round_up(dim, tile)


def packed_shape(rows: int, cols: int, t0: int, t1: int) -> tuple[int, int, int, int]:
    return (math.ceil(rows / t0), math.ceil(cols / t1), t0, t1)
