"""Decode GEMV: plain activation rows x packed weight, pack and unpack inside
the kernel (counterpart of repro/kernels/fused_gemv.py: fused_gemv_pallas).

    lhs  : (M, K1*K0)         plain rows, M <= GEMV_MAX_ROWS live decode slots
    rhs4 : (N1, K1, N0, K0)   packed weight, streamed once
    out  : (M, N1*N0) f32     plain

CUDA source: csrc/fused_gemv.cu (what bounds it and how it is laid out is
noted there).  `fused_gemv` launches the kernel for CUDA tensors and takes
the plain version `fused_gemv_plain` only for tensors on the CPU.  In bf16
it is the packed GEMV's skinny body (csrc/packed_skinny.cuh) entered with
plain rows, with the K split of `mmt4d.mmt4d_plan` at one row block of M
rows (`mmt4d.skinny_plain_loads` mirrors its TMA boxes).

`fused_gemv_q8` is the w8a8 decode GEMV (counterpart of
fused_gemv_q8_pallas): int8 rows x the packed int8 weight, int32 sum, then
(acc * s_a[m]) * s_w[n] in f32.  CUDA source: csrc/fused_gemv_q8.cu, on the
decode-GEMV body of csrc/gemv_warps.cuh: blocks of GEMV_BN columns over the
whole of K, whose warps split the K tiles (`gemv_q8_plan` picks how many),
one launch, no scratch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.encoding import GEMV_MAX_ROWS
from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.fused_pack_mmt4d import GEMM_WAVE, check_operands
from repro_torch.kernels.mmt4d import launch_args, mmt4d_plan


def fused_gemv_plain(lhs: torch.Tensor, rhs4: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: f32 products and sums."""
    n1, k1, n0, k0 = rhs4.shape
    return ref.matmul_reference(lhs, ref.unpack(rhs4, (n1 * n0, k1 * k0)))


@functools.cache
def _kernel():
    return build.entry(
        "fused_gemv", "fused_gemv",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3,
    )


def fused_gemv(lhs: torch.Tensor, rhs4: torch.Tensor) -> torch.Tensor:
    """lhs (M, K) x packed rhs4 -> (M, N1*N0) f32.  Plain version on the CPU;
    on a CUDA tensor the kernel runs or this raises."""
    check_operands(lhs, rhs4)
    if lhs.device.type == "cpu":
        return fused_gemv_plain(lhs, rhs4)
    if lhs.device.type != "cuda":
        raise RuntimeError(f"fused_gemv runs on cuda (or cpu: plain), not {lhs.device}")
    n1, k1, n0, k0 = rhs4.shape
    m = lhs.shape[0]
    if not 1 <= m <= GEMV_MAX_ROWS or (n0, k0) != (128, 128):
        raise ValueError(f"fused_gemv takes 1..{GEMV_MAX_ROWS} rows and 128x128 "
                         f"pack tiles, got M={m}, tile=({n0}, {k0})")
    lhs, rhs4 = build.aligned(lhs), build.aligned(rhs4)
    out = torch.empty((m, n1 * n0), dtype=torch.float32, device=lhs.device)
    splits, part, cnt = 1, None, None
    if lhs.dtype == torch.bfloat16:
        _, _, _, splits, part, cnt = launch_args(lhs.device, 1, m, n1, k1,
                                                 mmt4d_plan(1, m, n1, k1))
    err = _kernel()(lhs.data_ptr(), rhs4.data_ptr(), out.data_ptr(), m, n1, k1,
                    build.dtype_code(lhs.dtype), splits, part, cnt,
                    build.stream_ptr(lhs.device))
    build.check(err, "fused_gemv", "fused_gemv launch")
    fused_gemv.launches += 1
    return out


fused_gemv.launches = 0


# ---- w8a8 ------------------------------------------------------------------------


def check_q8_operands(lhs_q: torch.Tensor, rhs4_q: torch.Tensor, s_a: torch.Tensor,
                      s_w: torch.Tensor) -> None:
    """Contract of the w8a8 GEMV: int8 rows (M, K), int8 packed weight,
    s_a (M, 1) f32, s_w (N1, N0) f32, all on one device."""
    if lhs_q.dim() != 2 or rhs4_q.dim() != 4:
        raise ValueError(f"want lhs_q (M, K) and rhs4_q (N1, K1, N0, K0), got "
                         f"{tuple(lhs_q.shape)} and {tuple(rhs4_q.shape)}")
    n1, k1, n0, k0 = rhs4_q.shape
    m = lhs_q.shape[0]
    if lhs_q.shape[1] != k1 * k0:
        raise ValueError(f"lhs_q K {lhs_q.shape[1]} != packed K {k1 * k0}")
    if lhs_q.dtype != torch.int8 or rhs4_q.dtype != torch.int8:
        raise TypeError(f"w8a8 operands are int8, got {lhs_q.dtype} and {rhs4_q.dtype}")
    if tuple(s_a.shape) != (m, 1) or tuple(s_w.shape) != (n1, n0):
        raise ValueError(f"want s_a ({m}, 1) and s_w ({n1}, {n0}), got "
                         f"{tuple(s_a.shape)} and {tuple(s_w.shape)}")
    if s_a.dtype != torch.float32 or s_w.dtype != torch.float32:
        raise TypeError(f"scales are float32, got {s_a.dtype} and {s_w.dtype}")
    if len({t.device for t in (lhs_q, rhs4_q, s_a, s_w)}) != 1:
        raise ValueError("w8a8 operands lie on different devices")


def fused_gemv_q8_plain(lhs_q: torch.Tensor, rhs4_q: torch.Tensor, s_a: torch.Tensor,
                        s_w: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: the exact integer sum
    (ref.int_contract), then (acc * s_a) * s_w."""
    n1, k1, n0, k0 = rhs4_q.shape
    acc = ref.int_contract(lhs_q, ref.unpack(rhs4_q, (n1 * n0, k1 * k0)), "mk,nk->mn")
    return acc * s_a * s_w.reshape(1, n1 * n0)


# ---- the decode-GEMV body's plan (csrc/gemv_warps.cuh; mmt4d_q4.gemv_q4_plan too)

GEMV_BN = 16            # output columns a block owns: one m16 fragment of the weight
GEMV_WARPS = (8, 16)    # warps a block


def gemv_warps(n1: int) -> int:
    """Warps a block for N1 * 128 output columns: 16, or 8 where the grid
    has more than two blocks an SM (N = 8192: 512 blocks), so that every
    block is resident at once (the sweep in PERF.md, section 6)."""
    return 8 if n1 * 128 // GEMV_BN > 2 * GEMM_WAVE else 16


@functools.cache
def gemv_q8_plan(m: int, k1: int, n1: int) -> tuple[str, int, int]:
    """("warps", GEMV_BN, W) for int8 rows (M, K1*128) x rhs4 (N1, K1, 128,
    128): N1 * 128 / GEMV_BN blocks of W warps over the whole of K."""
    return "warps", GEMV_BN, gemv_warps(n1)


def check_gemv_plan(plan, name: str) -> tuple[str, int, int]:
    """`plan` if the kernels take it: ("warps", GEMV_BN, W in GEMV_WARPS)."""
    if len(plan) != 3 or plan[:2] != ("warps", GEMV_BN) or plan[2] not in GEMV_WARPS:
        raise ValueError(f"{name} takes ('warps', {GEMV_BN}, W in {GEMV_WARPS}), got {plan}")
    return plan


@functools.cache
def _kernel_q8():
    return build.entry(
        "fused_gemv_q8", "fused_gemv_q8",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )


def fused_gemv_q8(lhs_q: torch.Tensor, rhs4_q: torch.Tensor, s_a: torch.Tensor,
                  s_w: torch.Tensor, plan=None) -> torch.Tensor:
    """int8 rows (M, K) x packed int8 rhs4_q -> (M, N1*N0) f32 with the
    s_a (M, 1) x s_w (N1, N0) epilogue.  Plain version on the CPU; on a CUDA
    tensor the kernel runs or this raises.  `plan` overrides
    `gemv_q8_plan`."""
    check_q8_operands(lhs_q, rhs4_q, s_a, s_w)
    if lhs_q.device.type == "cpu":
        return fused_gemv_q8_plain(lhs_q, rhs4_q, s_a, s_w)
    if lhs_q.device.type != "cuda":
        raise RuntimeError(f"fused_gemv_q8 runs on cuda (or cpu: plain), not {lhs_q.device}")
    n1, k1, n0, k0 = rhs4_q.shape
    m = lhs_q.shape[0]
    if not 1 <= m <= GEMV_MAX_ROWS or (n0, k0) != (128, 128):
        raise ValueError(f"fused_gemv_q8 takes 1..{GEMV_MAX_ROWS} rows and 128x128 "
                         f"pack tiles, got M={m}, tile=({n0}, {k0})")
    lhs_q, rhs4_q = build.aligned(lhs_q), build.aligned(rhs4_q)
    s_a, s_w = s_a.contiguous(), s_w.contiguous()
    out = torch.empty((m, n1 * n0), dtype=torch.float32, device=lhs_q.device)
    plan = gemv_q8_plan(m, k1, n1) if plan is None else check_gemv_plan(plan, "fused_gemv_q8")
    err = _kernel_q8()(lhs_q.data_ptr(), rhs4_q.data_ptr(), s_a.data_ptr(), s_w.data_ptr(),
                       out.data_ptr(), m, n1, k1, plan[2], build.stream_ptr(lhs_q.device))
    build.check(err, "fused_gemv_q8", "fused_gemv_q8 launch")
    fused_gemv_q8.launches += 1
    return out


fused_gemv_q8.launches = 0
