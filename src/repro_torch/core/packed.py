"""PackedLinear parameters (counterpart of repro/core/packed.py).

Weights of every dense projection are stored in the mmt4d packed layout
(N1, K1, N0, K0), packed once at init or conversion.  `enabled=False` stores
the plain (N, K) weight and runs the un-encoded reference contraction.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import encoding
from repro_torch.core import targets as targets_lib
from repro_torch.kernels import ops
from repro_torch.kernels import ref

_QUANT_TODO = (
    "quantized weights (w8a8/w4a8) wait for the quantized-serving slice "
    "(ROADMAP, modules to port: quantized serving)"
)


@dataclasses.dataclass(frozen=True)
class EncodingConfig:
    enabled: bool = True
    backend: str = "xla"        # reference | xla | fused | pallas | auto
    # Attention op class (kernels/registry.select_attn): "xla" (plain),
    # "pallas" (the CUDA flash-prefill and paged-decode kernels) or "auto"
    # (registry policy).
    attn_backend: str = "xla"
    target: targets_lib.TargetSpec = targets_lib.H100
    weight_quant: str = "none"  # only "none" runs in the port so far

    def resolved_backend(self) -> str:
        return self.backend if self.enabled else "reference"


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
    """Init y = x @ W^T + b with W ~ N(0, scale^2), stored packed when
    encoding is on.  `gen` is a torch.Generator on `device`."""
    if enc.weight_quant != "none":
        raise NotImplementedError(_QUANT_TODO)
    scale = scale if scale is not None else in_dim**-0.5
    w_t = scale * torch.randn((out_dim, in_dim), generator=gen, device=device)
    w_t = w_t.to(dtype)
    params = {"w_packed": ops.pack_rhs(w_t)} if enc.enabled else {"w_t": w_t}
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
    if "w_q" in params or "w_q4" in params:
        raise NotImplementedError(_QUANT_TODO)
    if "w_packed" in params:
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
