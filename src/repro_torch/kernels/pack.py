"""tensor.pack / tensor.unpack (counterpart of repro/kernels/pack.py:
pack_pallas and unpack_pallas).

    pack(x, tile)     x (R, C) -> (R1, C1, T0, T1), zero-padded past R and C
    unpack(y, shape)  (R1, C1, T0, T1) -> (R, C), cropped, contiguous

Exact relayouts of 1-, 2- and 4-byte elements (int8/uint8, bf16, f32) at any
tile.  CUDA source: csrc/pack.cu (one source, two entries; what bounds them
and how they are laid out is noted there).  Unlike the TPU kernels, which
take only tile-aligned operands, the CUDA pack masks the ragged edge itself.
Each wrapper launches its kernel for a CUDA tensor and takes the plain
version (`pack_plain` = ref.pack, `unpack_plain` = ref.unpack) only for a
tensor on the CPU.

The serving path launches the pack kernel only for the weight packs at load
(kernels/ops.py: pack_rhs, pack_rhs_q8, pack_rhs_q4).  The packed routes'
activation pack and output unpack live in the packed GEMMs' plain-row
entries (their TMA loads and epilogue stores), so no activation goes
through either kernel; `ops.pack_pallas` / `ops.unpack_pallas` export them.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

pack_plain = ref.pack
unpack_plain = ref.unpack

_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 \
    + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]


@functools.cache
def _kernel(name: str):
    return build.entry("pack", name, _ARGS)


def _check_elem(t: torch.Tensor, what: str) -> int:
    size = t.element_size()
    if size not in (1, 2, 4):
        raise TypeError(f"{what} copies 1-, 2- or 4-byte elements, got {t.dtype}")
    return size


def pack(x: torch.Tensor, tile: tuple[int, int]) -> torch.Tensor:
    """x (R, C) -> (R1, C1, T0, T1) tiles, zero-padded.  Plain version on
    the CPU; on a CUDA tensor the kernel runs or this raises."""
    if x.device.type == "cpu":
        return pack_plain(x, tile)
    if x.device.type != "cuda":
        raise RuntimeError(f"pack runs on cuda (or cpu: plain), not {x.device}")
    if x.dim() != 2:
        raise ValueError(f"pack takes an (R, C) tensor, got {tuple(x.shape)}")
    t0, t1 = (int(t) for t in tile)
    if t0 < 1 or t1 < 1:
        raise ValueError(f"pack tile must be positive, got {tile}")
    size = _check_elem(x, "pack")
    r, c = x.shape
    r1, c1 = math.ceil(r / t0), math.ceil(c / t1)
    x = build.aligned(x)
    out = torch.empty((r1, c1, t0, t1), dtype=x.dtype, device=x.device)
    err = _kernel("pack_tiles")(x.data_ptr(), out.data_ptr(), r, c, t0, t1, r1, c1, size,
                                build.stream_ptr(x.device))
    build.check(err, "pack", "pack launch")
    pack.launches += 1
    return out


def unpack(y: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """(R1, C1, T0, T1) tiles -> (R, C), cropped.  Plain version on the CPU;
    on a CUDA tensor the kernel runs (writing a contiguous result) or this
    raises."""
    if y.device.type == "cpu":
        return unpack_plain(y, shape)
    if y.device.type != "cuda":
        raise RuntimeError(f"unpack runs on cuda (or cpu: plain), not {y.device}")
    if y.dim() != 4:
        raise ValueError(f"unpack takes an (R1, C1, T0, T1) tensor, got {tuple(y.shape)}")
    r1, c1, t0, t1 = y.shape
    r, c = (int(s) for s in shape)
    if not (1 <= r <= r1 * t0 and 1 <= c <= c1 * t1):
        raise ValueError(f"unpack of {tuple(y.shape)} cannot give shape {tuple(shape)}")
    size = _check_elem(y, "unpack")
    y = build.aligned(y)
    out = torch.empty((r, c), dtype=y.dtype, device=y.device)
    err = _kernel("unpack_tiles")(y.data_ptr(), out.data_ptr(), r, c, t0, t1, r1, c1, size,
                                  build.stream_ptr(y.device))
    build.check(err, "pack", "unpack launch")
    unpack.launches += 1
    return out


pack.launches = 0
unpack.launches = 0
