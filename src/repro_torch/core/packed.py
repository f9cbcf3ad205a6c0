"""PackedLinear parameters (counterpart of repro/core/packed.py).

Weights of every dense projection are stored in the mmt4d packed layout
(N1, K1, N0, K0), packed once at init or conversion.  `enabled=False` stores
the plain (N, K) weight and runs the un-encoded reference contraction.

Serving weight quantization (`weight_quant`): "int8" stores w_q (packed
int8) and w_scale (per output channel, f32) and runs w8a8; "int4" stores
w_q4 (nibble-packed int4) and w_scale4 (bf16, one per `quant_group` K
elements) and runs w4a8.  Both quantize on the device the weight is made
on, and route by `quant_backend` (kernels/ops.py).

`linear_plain` undoes the packing of any of these formats (codes and
scales as they are, no requantization) and `linear_from_plain` packs the
plain form again, so a tensor-parallel rank's slice of a projection
(parallel/sharding.py) is the slice of the very codes the full weight holds.
A row-parallel projection (`row_group`: each rank holds a K slice of the
weight and of the rows) returns the product summed over the group; its
w8a8/w4a8 activation rows take the absmax of the whole row.
`linear_apply_row_parallel` runs several such projections (an MoE layer's
experts' w_down) with one collective of each kind for them all.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import encoding
from repro_torch.core import targets as targets_lib
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.parallel import collectives

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
    row_group=None,
) -> torch.Tensor:
    """y = x @ W^T (+ b) in `out_dtype` (default x.dtype).  `row_group`, a
    tensor-parallel group over whose ranks K is split: the product is summed
    over the group before the cast (linear_apply_row_parallel) and the bias
    added once after it."""
    if row_group is not None:
        return linear_apply_row_parallel([params], [x], n=n, phase=phase, enc=enc,
                                         out_dtype=out_dtype, row_group=row_group)[0]
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
        y = ref.matmul_reference(x.reshape(-1, x.shape[-1]), params["w_t"])
        y = y.to(out_dtype).reshape(*x.shape[:-1], -1)
    if "b" in params:
        y = y + params["b"].to(out_dtype)
    return y


def linear_apply_row_parallel(
    params: list[dict],
    xs: list[torch.Tensor],
    *,
    n: int,
    phase: encoding.Phase,
    enc: EncodingConfig = DEFAULT_ENCODING,
    out_dtype: torch.dtype | None = None,
    row_group,
) -> list[torch.Tensor]:
    """[linear_apply(p, x, row_group=row_group) for p, x in zip(params, xs)]
    for projections of one weight format, each on this rank's K slice,
    with one collective of each kind for them all (ops.row_parallel_matmuls:
    the int8/int4 rows' absmax in one all_reduce_max, every product in one
    all_reduce_sum): an MoE layer's experts' w_down reduce together."""
    out_dtype = out_dtype or xs[0].dtype
    first = params[0]
    kw = dict(n=n, phase=phase, row_group=row_group, target=enc.target, out_dtype=out_dtype)
    if "w_q4" in first:
        ys = ops.row_parallel_matmuls(xs, [(p["w_q4"], p["w_scale4"]) for p in params],
                                      quant="w4a8", backend=enc.quant_backend(),
                                      group=enc.quant_group, **kw)
    elif "w_q" in first:
        ys = ops.row_parallel_matmuls(xs, [(p["w_q"], p["w_scale"]) for p in params],
                                      quant="w8a8", backend=enc.quant_backend(), **kw)
    elif "w_packed" in first:
        ys = ops.row_parallel_matmuls(xs, [(p["w_packed"],) for p in params], quant="none",
                                      backend=enc.resolved_backend(), **kw)
    else:
        parts = [ref.matmul_reference(x.reshape(-1, x.shape[-1]), p["w_t"])
                 for p, x in zip(params, xs)]
        ys = [y.to(out_dtype).reshape(*x.shape[:-1], -1)
              for y, x in zip(collectives.all_reduce_sum_each(parts, row_group), xs)]
    return [y + p["b"].to(out_dtype) if "b" in p else y for y, p in zip(ys, params)]


def linear_out_dim(params: dict) -> int:
    for key in ("w_packed", "w_q", "w_q4"):
        if key in params:
            n1, _, n0, _ = params[key].shape
            return n1 * n0  # padded; callers pass the true `n` to linear_apply
    return params["w_t"].shape[0]


def linear_plain(params: dict, n: int, k: int, *, group: int = ref.Q4_GROUP) -> dict:
    """A projection's weights (N = n, K = k) as plain row-major tensors, the
    packing undone and nothing requantized: {"w_t"} (unencoded), {"w"}
    (packed f32/bf16), {"q" (n, k) int8, "s" (n,) f32} (int8) or {"q4" (n,
    k) int8 codes, "s4" (n, ceil(k/group)) bf16} (int4), with "b" (n,)
    where the projection has a bias."""
    if "w_q4" in params:
        codes = ref.unpack_nibbles(params["w_q4"]).to(torch.int8)
        out = {"q4": ref.unpack(codes, (n, k)),
               "s4": ref.unpack(params["w_scale4"], (n, -(-k // group)))}
    elif "w_q" in params:
        out = {"q": ref.unpack(params["w_q"], (n, k)), "s": params["w_scale"].reshape(-1)[:n]}
    elif "w_packed" in params:
        out = {"w": ref.unpack(params["w_packed"], (n, k))}
    else:
        out = {"w_t": params["w_t"]}
    if "b" in params:
        out["b"] = params["b"]
    return out


def linear_from_plain(plain: dict, *, group: int = ref.Q4_GROUP) -> dict:
    """linear_plain's inverse: the stored form linear_init makes, packed at
    (N0, K0) = (128, 128) (the pack kernel on a CUDA tensor)."""
    t = encoding.PACK_TILE
    if "q4" in plain:
        out = {"w_q4": ref.pack_nibbles(ops.pack_lib.pack(plain["q4"].contiguous(), (t, t))),
               "w_scale4": ops.pack_lib.pack(plain["s4"].contiguous(), (t, t // group))}
    elif "q" in plain:
        rhs4 = ops.pack_rhs(plain["q"].contiguous())
        n1, _, n0, _ = rhs4.shape
        s = torch.zeros(n1 * n0, dtype=torch.float32, device=rhs4.device)
        s[: plain["s"].shape[0]] = plain["s"]
        out = {"w_q": rhs4, "w_scale": s.reshape(n1, n0)}
    elif "w" in plain:
        out = {"w_packed": ops.pack_rhs(plain["w"].contiguous())}
    else:
        out = {"w_t": plain["w_t"].contiguous()}
    if "b" in plain:
        out["b"] = plain["b"].contiguous()
    return out
