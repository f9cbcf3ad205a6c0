"""PackedLinear parameters (counterpart of repro/core/packed.py).

Weights of every dense projection are stored in the mmt4d packed layout
(N1, K1, N0, K0), packed once at init or conversion.  `enabled=False` stores
the plain (N, K) weight and runs the un-encoded reference contraction.

Serving weight quantization (`weight_quant`): "int8" stores w_q (packed
int8) and w_scale (per output channel, f32) and runs w8a8; "int4" stores
w_q4 (nibble-packed int4) and w_scale4 (bf16, one per `quant_group` K
elements) and runs w4a8.  Both quantize on the device the weight is made
on, and route by `quant_backend` (kernels/ops.py).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import encoding
from repro_torch.core import targets as targets_lib
from repro_torch.kernels import ops
from repro_torch.kernels import ref

# The weight formats and the registry's quant name of each.
QUANT_KEYS = {"none": "none", "int8": "w8a8", "int4": "w4a8"}


@dataclasses.dataclass(frozen=True)
class EncodingConfig:
    enabled: bool = True
    backend: str = "xla"        # reference | xla | fused | pallas | auto
    # Attention op class (kernels/registry.select_attn): "xla" (plain),
    # "pallas" (the CUDA flash-prefill and paged-decode kernels) or "auto"
    # (registry policy).
    attn_backend: str = "xla"
    target: targets_lib.TargetSpec = targets_lib.H100
    weight_quant: str = "none"  # none | int8 (w8a8) | int4 (w4a8)
    quant_group: int = 16       # K elements per int4 scale (weight_quant="int4")

    def __post_init__(self):
        if self.weight_quant not in QUANT_KEYS:
            raise ValueError(f"weight_quant must be one of {tuple(QUANT_KEYS)}, "
                             f"got {self.weight_quant!r}")

    def resolved_backend(self) -> str:
        return self.backend if self.enabled else "reference"

    def quant_backend(self) -> str:
        """The backend the quantized projections request: the kernels'
        backends and "auto" pass through; "reference" and "xla" take the
        plain oracle ("xla")."""
        return self.backend if self.backend in ("pallas", "fused", "auto") else "xla"


DEFAULT_ENCODING = EncodingConfig()


def linear_init(
    gen: torch.Generator,
    in_dim: int,
    out_dim: int,
    *,
    enc: EncodingConfig = DEFAULT_ENCODING,
    use_bias: bool = False,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
    scale: float | None = None,
) -> dict:
    """Init y = x @ W^T + b with W ~ N(0, scale^2), stored packed (and
    quantized, per `enc.weight_quant`) when encoding is on.  `gen` is a
    torch.Generator on `device`."""
    scale = scale if scale is not None else in_dim**-0.5
    w_t = scale * torch.randn((out_dim, in_dim), generator=gen, device=device)
    w_t = w_t.to(dtype)
    if not enc.enabled:
        params = {"w_t": w_t}
    elif enc.weight_quant == "int4":
        w_q4, s_w4 = ops.pack_rhs_q4(w_t, group=enc.quant_group)
        params = {"w_q4": w_q4, "w_scale4": s_w4}
    elif enc.weight_quant == "int8":
        w_q, s_w = ops.pack_rhs_q8(w_t)
        params = {"w_q": w_q, "w_scale": s_w}
    else:
        params = {"w_packed": ops.pack_rhs(w_t)}
    if use_bias:
        params["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return params


def linear_apply(
    params: dict,
    x: torch.Tensor,
    *,
    n: int,
    phase: encoding.Phase,
    enc: EncodingConfig = DEFAULT_ENCODING,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    out_dtype = out_dtype or x.dtype
    if "w_q4" in params:
        y = ops.encoded_matmul_q4(
            x, params["w_q4"], params["w_scale4"], n=n, phase=phase, group=enc.quant_group,
            backend=enc.quant_backend(), target=enc.target, out_dtype=out_dtype,
        )
    elif "w_q" in params:
        y = ops.encoded_matmul_q8(
            x, params["w_q"], params["w_scale"], n=n, phase=phase,
            backend=enc.quant_backend(), target=enc.target, out_dtype=out_dtype,
        )
    elif "w_packed" in params:
        y = ops.encoded_matmul(
            x, params["w_packed"], n=n, phase=phase,
            backend=enc.resolved_backend(), target=enc.target, out_dtype=out_dtype,
        )
    else:
        lead = x.shape[:-1]
        y = ref.matmul_reference(x.reshape(-1, x.shape[-1]), params["w_t"])
        y = y.to(out_dtype).reshape(*lead, -1)
    if "b" in params:
        y = y + params["b"].to(out_dtype)
    return y


def linear_out_dim(params: dict) -> int:
    for key in ("w_packed", "w_q", "w_q4"):
        if key in params:
            n1, _, n0, _ = params[key].shape
            return n1 * n0  # padded; callers pass the true `n` to linear_apply
    return params["w_t"].shape[0]
