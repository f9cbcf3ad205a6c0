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

A tensor-parallel rank's row-parallel projections (its K slice of wo,
w_down, an MoE layer's experts' w_down) run through row_parallel_matmuls:
the same routes, with the products (and the quantized rows' absmax) summed
over the group, one collective of each kind for all projections of a call.
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
) -> torch.Tensor:
    """x (..., K) @ W^T where rhs4 is the packed (N1, K1, N0, K0) weight.
    Returns (..., n) in `out_dtype` (default x.dtype); accumulation is f32."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    out2d = _float_out(x2d, rhs4, n, phase, backend, target)
    return out2d[:, :n].to(out_dtype).reshape(*lead, n)


def _float_out(x2d: torch.Tensor, rhs4: torch.Tensor, n: int, phase: Phase, backend: str,
               target: targets_lib.TargetSpec) -> torch.Tensor:
    """x2d (M, K) @ the packed float weight on the backend the registry
    resolves `backend` to: f32, (M, n) on the reference rung, else
    (M, N1 * N0)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    n1, k1, n0, k0 = rhs4.shape
    m, k = x2d.shape
    if k > k1 * k0:
        raise ValueError(f"x K {k} exceeds packed K {k1 * k0}")
    backend = registry.select(
        quant="none", phase=phase, m=m, target=target, requested=backend
    ).backend
    if backend == "reference":
        return ref.matmul_reference(x2d, ref.unpack(rhs4, (n, k1 * k0))[:, :k])
    return _float_product(x2d, rhs4, phase, backend)


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


def _padded_rows(x: torch.Tensor, k_packed: int) -> torch.Tensor:
    """x (..., K) as rows (M, k_packed), K zero-padded to the packed
    weight's."""
    k = x.shape[-1]
    if k > k_packed:
        raise ValueError(f"x K {k} exceeds packed K {k_packed}")
    x2d = x.reshape(-1, k)
    return F.pad(x2d, (0, k_packed - k)) if k != k_packed else x2d


def _packed_rows(xq: torch.Tensor, s_a: torch.Tensor, phase: Phase,
                 k0: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The oracle's int8 rows packed at select_tile_sizes's M0 (ref.pack);
    pad rows get scale 0."""
    m0 = encoding.select_tile_sizes(phase, m_hint=xq.shape[0]).m0
    return ref.pack(xq, (m0, k0)), q8_lib.packed_scales(s_a, m0)


def encoded_matmul_q8(x: torch.Tensor, rhs4_q: torch.Tensor, s_w: torch.Tensor, *, n: int,
                      phase: Phase, backend: str = "xla",
                      target: targets_lib.TargetSpec = targets_lib.H100,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """w8a8: x (..., K) @ W^T with W the packed int8 rhs4_q and its scales
    s_w (N1, N0).  The rows are quantized per row (ref.quantize_rows, after
    padding K to the packed weight's).  Returns (..., n) in `out_dtype`
    (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    n1, k1, n0, k0 = rhs4_q.shape
    xq, s_a = ref.quantize_rows(_padded_rows(x, k1 * k0))
    backend = registry.select(quant="w8a8", phase=phase, m=xq.shape[0], target=target,
                              requested=backend).backend
    out2d = _q8_product(xq, rhs4_q, s_a, s_w, phase, backend)
    return out2d[:, :n].to(out_dtype).reshape(*x.shape[:-1], n)


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
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """w4a8: x (..., K) @ W^T with W the nibble-packed int4 rhs4_p and its
    group scales s_w4 (N1, K1, N0, K0/group); the rows quantized as
    encoded_matmul_q8 quantizes them.  Returns (..., n) in `out_dtype`
    (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    n1, k1, n0, k0p = rhs4_p.shape
    xq, s_a = ref.quantize_rows(_padded_rows(x, k1 * 2 * k0p))
    backend = registry.select(quant="w4a8", phase=phase, m=xq.shape[0], target=target,
                              requested=backend).backend
    out2d = _q4_product(xq, rhs4_p, s_a, s_w4, group, phase, backend)
    return out2d[:, :n].to(out_dtype).reshape(*x.shape[:-1], n)


def _q4_product(xq: torch.Tensor, rhs4_p: torch.Tensor, s_a: torch.Tensor, s_w4: torch.Tensor,
                group: int, phase: Phase, backend: str) -> torch.Tensor:
    """The w4a8 product of int8 rows xq (M, K) on `backend`'s route:
    (M, N1 * N0) f32."""
    m = xq.shape[0]
    n1, _, n0, k0p = rhs4_p.shape
    if backend == "fused" and phase is Phase.DECODE and m <= encoding.GEMV_MAX_ROWS:
        return q4_lib.fused_gemv_q4(xq, rhs4_p, s_a[:, None], s_w4, group)
    if backend == "xla":
        lhs4, sa2 = _packed_rows(xq, s_a, phase, 2 * k0p)
        return ref.unpack(ref.mmt4d_q4(lhs4, rhs4_p, sa2, s_w4, group), (m, n1 * n0))
    # "pallas", and "fused" outside the GEMV's rows: the plain-row entry
    m0 = encoding.select_tile_sizes(phase, m_hint=m).m0
    return q4_lib.mmt4d_q4_rows(xq, rhs4_p, s_a, s_w4, group, m0)


# ---- row-parallel projections (tensor parallelism) ------------------------------


def row_parallel_matmuls(xs: list[torch.Tensor], weights: list[tuple], *, quant: str, n: int,
                         phase: Phase, row_group, backend: str = "xla",
                         target: targets_lib.TargetSpec = targets_lib.H100,
                         out_dtype: torch.dtype | None = None,
                         group: int = ref.Q4_GROUP) -> list[torch.Tensor]:
    """Row-parallel projections: each xs[i] (..., K_i) and its weight are
    this rank's K slice of a projection whose products are summed over
    `row_group`.  `weights[i]` is what encoded_matmul (quant "none":
    (rhs4,)), encoded_matmul_q8 ("w8a8": (rhs4_q, s_w)) or
    encoded_matmul_q4 ("w4a8": (rhs4_p, s_w4)) takes; each result, (..., n)
    in `out_dtype` (default xs[0].dtype), is what that function computes
    on the whole rows and weight, as follows.

      none  the f32 products summed over the group, then cast.
      w8a8  the rows quantized with the whole row's absmax; the kernel runs
            with unit scales, so its output is the exact integer sum of the
            rank's K slice; the sums are added over the group in f64 and the
            epilogue (acc * s_a) * s_w runs once on the total, as one card's
            kernel runs it: one card's result bit for bit while each rank's
            sum stays below 2^24 in magnitude (f32 holds it exactly).
      w4a8  the rows quantized with the whole row's absmax, the f32
            products summed.  The kernel rounds its exact f64 group sums to
            f32 once, so a rank's sum is rounded before the group adds
            them: one card's to within those roundings, not bit for bit.

    Every projection of the call shares each collective: one
    all_reduce_max of all their rows' absmax (w8a8, w4a8) and one
    all_reduce_sum of all their products, so a layer's experts
    (models/layers.moe_apply) reduce once, not once an expert."""
    out_dtype = out_dtype or xs[0].dtype
    x2ds = [x.reshape(-1, x.shape[-1]) for x in xs]
    if quant == "none":
        parts = [_float_out(x2d, w[0], n, phase, backend, target)[:, :n]
                 for x2d, w in zip(x2ds, weights)]
        outs = collectives.all_reduce_sum_each(parts, row_group)
    else:
        k_packed = [w[0].shape[1] * w[0].shape[3] * (2 if quant == "w4a8" else 1)
                    for w in weights]
        rows = [_padded_rows(x2d, kp) for x2d, kp in zip(x2ds, k_packed)]
        amax = collectives.all_reduce_max_each([r.float().abs().amax(dim=1) for r in rows],
                                               row_group)
        qs = [ref.quantize_rows(r, amax=a) for r, a in zip(rows, amax)]
        routes = [registry.select(quant=quant, phase=phase, m=xq.shape[0], target=target,
                                  requested=backend).backend for xq, _ in qs]
        if quant == "w8a8":
            acc = [_q8_product(xq, w[0], torch.ones_like(s_a), torch.ones_like(w[1]), phase,
                               route)[:, :n].double()
                   for (xq, s_a), w, route in zip(qs, weights, routes)]
            outs = [total.float() * s_a[:, None] * w[1].reshape(1, -1)[:, :n]
                    for total, (_, s_a), w in zip(collectives.all_reduce_sum_each(acc, row_group),
                                                  qs, weights)]
        else:
            parts = [_q4_product(xq, w[0], s_a, w[1], group, phase, route)[:, :n]
                     for (xq, s_a), w, route in zip(qs, weights, routes)]
            outs = collectives.all_reduce_sum_each(parts, row_group)
    return [out.to(out_dtype).reshape(*x.shape[:-1], n) for out, x in zip(outs, xs)]


# The counterparts' names in the JAX package (repro/kernels/ops.py re-exports
# pack_pallas and unpack_pallas; batch_mmt4d_pallas is repro/kernels/batch_mmt4d.py's).
pack_pallas = pack_lib.pack
unpack_pallas = pack_lib.unpack
batch_mmt4d_pallas = batch_mmt4d_lib.batch_mmt4d
