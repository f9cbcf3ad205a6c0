"""Dispatch wrappers for every dense projection (counterpart of
repro/kernels/ops.py).

`encoded_matmul` performs the paper's rewrite (pack -> mmt4d -> unpack) on a
weight stored packed once at (N0, K0) = (128, 128), and routes the mmt4d
through the registry to one of:

    backend="reference" : plain (M, K) x (N, K)^T torch.matmul, no encoding
    backend="xla"       : plain pack + einsum-mmt4d + unpack (the oracle path)
    backend="fused"     : the CUDA kernels with pack/unpack inside them: the
                          GEMV for decode with at most GEMV_MAX_ROWS rows, the
                          GEMM otherwise
    backend="pallas"    : the packed mmt4d GEMM, not ported yet (ROADMAP)

The decode routing comes from the CUDA GEMV's own needs, not from the TPU's
VMEM plan: the kernel streams the weight from device memory and stages at
most a K-chunk of the <= 8 rows in shared memory, so any K fits, and rows
are never padded to a sublane or slab multiple.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import encoding
from repro_torch.core import targets as targets_lib
from repro_torch.kernels import fused_gemv as fused_gemv_lib
from repro_torch.kernels import fused_pack_mmt4d as fused_lib
from repro_torch.kernels import ref
from repro_torch.kernels import registry

Phase = encoding.Phase

BACKENDS = ("reference", "xla", "pallas", "fused", "auto")


def pack_rhs(w_t: torch.Tensor, *, tiles: encoding.TileSizes | None = None) -> torch.Tensor:
    """Pack a transposed weight (N, K) into (N1, K1, N0, K0).  One-time cost."""
    tiles = tiles or encoding.select_tile_sizes(Phase.PREFILL)
    return ref.pack(w_t, (tiles.n0, tiles.k0))


def encoded_matmul(
    x: torch.Tensor,
    rhs4: torch.Tensor,
    *,
    n: int,
    phase: Phase,
    backend: str = "xla",
    target: targets_lib.TargetSpec = targets_lib.H100,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """x (..., K) @ W^T where rhs4 is the packed (N1, K1, N0, K0) weight.
    Returns (..., n) in `out_dtype` (default x.dtype); accumulation is f32."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    out_dtype = out_dtype or x.dtype
    n1, k1, n0, k0 = rhs4.shape
    k = x.shape[-1]
    if k > k1 * k0:
        raise ValueError(f"x K {k} exceeds packed K {k1 * k0}")
    lead = x.shape[:-1]
    x2d = x.reshape(-1, k)
    m = x2d.shape[0]
    backend = registry.select(
        quant="none", phase=phase, m=m, target=target, requested=backend
    ).backend

    if backend == "reference":
        w_t = ref.unpack(rhs4, (n, k1 * k0))[:, :k]
        out = ref.matmul_reference(x2d, w_t)
        return out.to(out_dtype).reshape(*lead, n)
    if k != k1 * k0:  # K padding lives in the packed weight; mirror it on lhs.
        x2d = F.pad(x2d, (0, k1 * k0 - k))
    if backend == "fused":
        if phase is Phase.DECODE and m <= encoding.GEMV_MAX_ROWS:
            out2d = fused_gemv_lib.fused_gemv(x2d, rhs4)
        else:
            out2d = fused_lib.fused_pack_mmt4d(x2d, rhs4)
    elif backend == "xla":
        m0 = encoding.select_tile_sizes(phase, m_hint=m).m0
        out4 = ref.mmt4d(ref.pack(x2d, (m0, k0)), rhs4)
        out2d = ref.unpack(out4, (m, n1 * n0))
    else:
        raise NotImplementedError(
            "backend 'pallas' (the packed mmt4d GEMM that serves decode with more "
            "than 8 rows) waits for the next port slice (ROADMAP, TPU kernels to port)"
        )
    return out2d[:, :n].to(out_dtype).reshape(*lead, n)
