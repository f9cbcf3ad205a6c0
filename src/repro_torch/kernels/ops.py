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
    backend="pallas"    : the packed CUDA kernels -- the paper's two
                          microkernels, as in repro/kernels/ops.py: the
                          packed GEMV (csrc/mmt4d_gemv.cu) for decode with
                          one packed row block, the packed GEMM
                          (csrc/mmt4d.cu) otherwise, each through its
                          plain-row entry, which packs the rows in its TMA
                          loads and unpacks the output in its stores: one
                          launch a projection

The decode routing comes from the CUDA GEMV's own needs, not from the TPU's
VMEM plan: the kernel streams the weight from device memory and stages at
most a K-chunk of the <= 8 rows in shared memory, so any K fits, and rows
are never padded to a sublane or slab multiple.  M0 for the packed path is
encoding.select_tile_sizes's rule.

Quantized weights (`encoded_matmul_q8` for w8a8, `encoded_matmul_q4` for
w4a8) quantize the activation rows per row to int8 in plain PyTorch (after
padding K to the packed weight's), then route by the same rule: "fused" at
decode with at most GEMV_MAX_ROWS rows takes the int8 or int4 GEMV
(csrc/fused_gemv_q8.cu, csrc/mmt4d_q4.cu) on the plain rows; "pallas", and
"fused" otherwise, take the packed q8 or q4 GEMM (csrc/mmt4d_q8.cu,
csrc/mmt4d_q4.cu) through its plain-row entry; "xla" takes the plain
oracle (ref.mmt4d_q8 / ref.mmt4d_q4), the registry's fallback for these
quants.

The packed routes launch no pack or unpack: each packed GEMM's plain-row
entry (mmt4d_rows, mmt4d_gemv_rows, mmt4d_q8_rows, mmt4d_q4_rows) runs the
plan its packed entry would run at M1 = ceil(M / M0) and equals
unpack(packed kernel(pack(x)))[:M] bit for bit, M0 being
select_tile_sizes's.  JAX's ops path packs and unpacks with its plain ref
there; both are exact relayouts, so the tokens are the same.  The weight
packs at load (pack_rhs, pack_rhs_q8, pack_rhs_q4) go through
kernels/pack.py (the pack kernel on a CUDA tensor, ref.pack on the CPU).
The "xla" and "reference" routes keep ref.pack / ref.unpack.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import encoding
from repro_torch.core import targets as targets_lib
from repro_torch.kernels import batch_mmt4d as batch_mmt4d_lib
from repro_torch.kernels import fused_gemv as fused_gemv_lib
from repro_torch.kernels import fused_pack_mmt4d as fused_lib
from repro_torch.kernels import mmt4d as mmt4d_lib
from repro_torch.kernels import mmt4d_gemv as gemv_lib
from repro_torch.kernels import mmt4d_q4 as q4_lib
from repro_torch.kernels import mmt4d_q8 as q8_lib
from repro_torch.kernels import pack as pack_lib
from repro_torch.kernels import ref
from repro_torch.kernels import registry
from repro_torch.parallel import collectives

Phase = encoding.Phase

BACKENDS = ("reference", "xla", "pallas", "fused", "auto")


def pack_rhs(w_t: torch.Tensor, *, tiles: encoding.TileSizes | None = None) -> torch.Tensor:
    """Pack a transposed weight (N, K) into (N1, K1, N0, K0).  One-time cost."""
    tiles = tiles or encoding.select_tile_sizes(Phase.PREFILL)
    return pack_lib.pack(w_t, (tiles.n0, tiles.k0))


def encoded_matmul(
    x: torch.Tensor,
    rhs4: torch.Tensor,
    *,
    n: int,
    phase: Phase,
    backend: str = "xla",
    target: targets_lib.TargetSpec = targets_lib.H100,
    out_dtype: torch.dtype | None = None,
    row_group=None,
) -> torch.Tensor:
    """x (..., K) @ W^T where rhs4 is the packed (N1, K1, N0, K0) weight.
    Returns (..., n) in `out_dtype` (default x.dtype); accumulation is f32.
    `row_group`: x and W are this rank's K slice of a row-parallel
    projection; the f32 product is summed over the group before the cast."""
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
        out2d = ref.matmul_reference(x2d, ref.unpack(rhs4, (n, k1 * k0))[:, :k])
    else:
        out2d = _float_product(x2d, rhs4, phase, backend)
    if row_group is not None:
        out2d = collectives.all_reduce_sum(out2d[:, :n], row_group)
    return out2d[:, :n].to(out_dtype).reshape(*lead, n)


def _float_product(x2d: torch.Tensor, rhs4: torch.Tensor, phase: Phase,
                   backend: str) -> torch.Tensor:
    """x2d (M, K) @ the packed float weight on `backend`'s packed route:
    (M, N1 * N0) f32."""
    m, k = x2d.shape
    n1, k1, n0, k0 = rhs4.shape
    if k != k1 * k0:  # K padding lives in the packed weight; mirror it on lhs.
        x2d = F.pad(x2d, (0, k1 * k0 - k))
    if backend == "pallas":  # the packed kernels' plain-row entries: one launch
        m0 = encoding.select_tile_sizes(phase, m_hint=m).m0
        if phase is Phase.DECODE and m <= m0:  # one packed row block
            return gemv_lib.mmt4d_gemv_rows(x2d, rhs4)
        return mmt4d_lib.mmt4d_rows(x2d, rhs4, m0)
    if backend == "fused":
        if phase is Phase.DECODE and m <= encoding.GEMV_MAX_ROWS:
            return fused_gemv_lib.fused_gemv(x2d, rhs4)
        return fused_lib.fused_pack_mmt4d(x2d, rhs4)
    # "xla", the oracle: plain pack -> mmt4d -> unpack
    m0 = encoding.select_tile_sizes(phase, m_hint=m).m0
    out4 = ref.mmt4d(ref.pack(x2d, (m0, k0)), rhs4)
    return ref.unpack(out4, (m, n1 * n0))


# ---- quantized weights (w8a8, w4a8) ---------------------------------------------


def pack_rhs_q8(w_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a transposed weight (N, K) per output channel (MSE clip
    search) and pack it.  Returns (rhs4_q (N1, K1, N0, K0) int8, s_w (N1, N0)
    f32, zero past N).  One-time cost, on w_t's device."""
    q, s = ref.quantize_rows_mse(w_t)
    rhs4 = pack_rhs(q)
    n1, _, n0, _ = rhs4.shape
    s_pad = torch.zeros(n1 * n0, dtype=torch.float32, device=w_t.device)
    s_pad[: s.shape[0]] = s
    return rhs4, s_pad.reshape(n1, n0)


def pack_rhs_q4(w_t: torch.Tensor, *, group: int = ref.Q4_GROUP
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-quantize (per row and `group` K elements, MSE clip search) and
    pack a transposed weight (N, K).  Returns (rhs4_p (N1, K1, N0, K0/2)
    uint8 nibbles, s_w4 (N1, K1, N0, K0/group) bf16 scales); pad rows and
    columns carry zero nibbles and zero scales."""
    if encoding.PACK_TILE % group:
        raise ValueError(f"group {group} must divide the K0 tile {encoding.PACK_TILE}")
    q, s = ref.quantize_rows_q4_grouped(w_t, group=group)
    t = encoding.PACK_TILE
    rhs4 = pack_lib.pack(q, (t, t))
    s_w4 = pack_lib.pack(s.to(torch.bfloat16), (t, t // group))
    return ref.pack_nibbles(rhs4), s_w4


def _quantized_rows(x: torch.Tensor, k_packed: int,
                    row_group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., K) -> int8 rows (M, k_packed) and their scales (M,): K is
    zero-padded to the packed weight's before the per-row quantizer.  With
    `row_group` (a row-parallel projection's tensor-parallel group, whose
    ranks each hold a K slice of the rows) each row's absmax is the max over
    the group, so the codes are those of the whole row."""
    k = x.shape[-1]
    if k > k_packed:
        raise ValueError(f"x K {k} exceeds packed K {k_packed}")
    x2d = x.reshape(-1, k)
    if k != k_packed:
        x2d = F.pad(x2d, (0, k_packed - k))
    if row_group is None:
        return ref.quantize_rows(x2d)
    amax = collectives.all_reduce_max(x2d.float().abs().amax(dim=1), row_group)
    return ref.quantize_rows(x2d, amax=amax)


def _packed_rows(xq: torch.Tensor, s_a: torch.Tensor, phase: Phase,
                 k0: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The oracle's int8 rows packed at select_tile_sizes's M0 (ref.pack);
    pad rows get scale 0."""
    m0 = encoding.select_tile_sizes(phase, m_hint=xq.shape[0]).m0
    return ref.pack(xq, (m0, k0)), q8_lib.packed_scales(s_a, m0)


def encoded_matmul_q8(x: torch.Tensor, rhs4_q: torch.Tensor, s_w: torch.Tensor, *, n: int,
                      phase: Phase, backend: str = "xla",
                      target: targets_lib.TargetSpec = targets_lib.H100,
                      out_dtype: torch.dtype | None = None, row_group=None) -> torch.Tensor:
    """w8a8: x (..., K) @ W^T with W the packed int8 rhs4_q and its scales
    s_w (N1, N0).  Returns (..., n) in `out_dtype` (default x.dtype).

    `row_group`: x and W are this rank's K slice of a row-parallel
    projection.  The rows are quantized with the whole row's absmax
    (_quantized_rows), the kernel runs with unit scales, so its output is
    the exact integer sum of the rank's K slice, those sums are added over
    the group in f64, and the epilogue (acc * s_a) * s_w runs once on the
    total, as one card's kernel runs it: the result is one card's, bit for
    bit, while each rank's sum stays below 2^24 in magnitude (f32 holds it
    exactly)."""
    out_dtype = out_dtype or x.dtype
    n1, k1, n0, k0 = rhs4_q.shape
    lead = x.shape[:-1]
    xq, s_a = _quantized_rows(x, k1 * k0, row_group)
    m = xq.shape[0]
    backend = registry.select(quant="w8a8", phase=phase, m=m, target=target,
                              requested=backend).backend
    if row_group is None:
        out2d = _q8_product(xq, rhs4_q, s_a, s_w, phase, backend)
    else:
        acc = _q8_product(xq, rhs4_q, torch.ones_like(s_a), torch.ones_like(s_w), phase,
                          backend)[:, :n]
        acc = collectives.all_reduce_sum(acc.double(), row_group).float()
        out2d = acc * s_a[:, None] * s_w.reshape(1, n1 * n0)[:, :n]
    return out2d[:, :n].to(out_dtype).reshape(*lead, n)


def _q8_product(xq: torch.Tensor, rhs4_q: torch.Tensor, s_a: torch.Tensor, s_w: torch.Tensor,
                phase: Phase, backend: str) -> torch.Tensor:
    """The w8a8 product of int8 rows xq (M, K) on `backend`'s route:
    (acc * s_a) * s_w, (M, N1 * N0) f32."""
    m = xq.shape[0]
    n1, _, n0, k0 = rhs4_q.shape
    if backend == "fused" and phase is Phase.DECODE and m <= encoding.GEMV_MAX_ROWS:
        return fused_gemv_lib.fused_gemv_q8(xq, rhs4_q, s_a[:, None], s_w)
    if backend == "xla":
        lhs4, sa2 = _packed_rows(xq, s_a, phase, k0)
        return ref.unpack(ref.mmt4d_q8(lhs4, rhs4_q, sa2, s_w), (m, n1 * n0))
    # "pallas", and "fused" outside the GEMV's rows: the plain-row entry
    m0 = encoding.select_tile_sizes(phase, m_hint=m).m0
    return q8_lib.mmt4d_q8_rows(xq, rhs4_q, s_a, s_w, m0)


def encoded_matmul_q4(x: torch.Tensor, rhs4_p: torch.Tensor, s_w4: torch.Tensor, *, n: int,
                      phase: Phase, group: int = ref.Q4_GROUP, backend: str = "xla",
                      target: targets_lib.TargetSpec = targets_lib.H100,
                      out_dtype: torch.dtype | None = None, row_group=None) -> torch.Tensor:
    """w4a8: x (..., K) @ W^T with W the nibble-packed int4 rhs4_p and its
    group scales s_w4 (N1, K1, N0, K0/group).  Returns (..., n) in
    `out_dtype` (default x.dtype).  `row_group`: x and W are this rank's K
    slice (whole groups) of a row-parallel projection; the rows take the
    whole row's absmax (_quantized_rows) and the f32 products are summed
    over the group.  The kernel rounds its exact f64 group sums to f32 once,
    so a rank's sum is rounded before the group adds it: the result is one
    card's to within those roundings, not bit for bit."""
    out_dtype = out_dtype or x.dtype
    n1, k1, n0, k0p = rhs4_p.shape
    k0 = 2 * k0p
    lead = x.shape[:-1]
    xq, s_a = _quantized_rows(x, k1 * k0, row_group)
    m = xq.shape[0]
    backend = registry.select(quant="w4a8", phase=phase, m=m, target=target,
                              requested=backend).backend
    if backend == "fused" and phase is Phase.DECODE and m <= encoding.GEMV_MAX_ROWS:
        out2d = q4_lib.fused_gemv_q4(xq, rhs4_p, s_a[:, None], s_w4, group)
    elif backend == "xla":
        lhs4, sa2 = _packed_rows(xq, s_a, phase, k0)
        out2d = ref.unpack(ref.mmt4d_q4(lhs4, rhs4_p, sa2, s_w4, group), (m, n1 * n0))
    else:  # "pallas", and "fused" outside the GEMV's rows: the plain-row entry
        m0 = encoding.select_tile_sizes(phase, m_hint=m).m0
        out2d = q4_lib.mmt4d_q4_rows(xq, rhs4_p, s_a, s_w4, group, m0)
    if row_group is not None:
        out2d = collectives.all_reduce_sum(out2d[:, :n], row_group)
    return out2d[:, :n].to(out_dtype).reshape(*lead, n)


# The counterparts' names in the JAX package (repro/kernels/ops.py re-exports
# pack_pallas and unpack_pallas; batch_mmt4d_pallas is repro/kernels/batch_mmt4d.py's).
pack_pallas = pack_lib.pack
unpack_pallas = pack_lib.unpack
batch_mmt4d_pallas = batch_mmt4d_lib.batch_mmt4d
