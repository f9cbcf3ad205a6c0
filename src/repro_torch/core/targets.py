"""Hardware target descriptions for the port.

`TargetSpec` names the card the registry keys its dispatch decisions on
(`kernels/registry.py`) and carries the numbers the roofline bounds in
`chip_smoke.py` are computed from.  Figures are NVIDIA's H100 SXM data sheet
and the Hopper architecture white paper: dense tensor-core rates without
sparsity, at the card's full 700 W power limit.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TargetSpec:
    name: str
    peak_flops_bf16: float       # tensor cores, dense
    peak_flops_f32: float        # CUDA cores, outside the tensor cores
    hbm_bytes_per_s: float
    smem_bytes_per_block: int    # dynamic shared memory one block may use
    sm_count: int


H100 = TargetSpec(
    name="h100",
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    hbm_bytes_per_s=3.35e12,
    smem_bytes_per_block=232_448,
    sm_count=132,
)
