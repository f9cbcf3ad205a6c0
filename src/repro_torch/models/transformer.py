"""Full model (counterpart of repro/models/transformer.py) for the `dense`
family: embedding, a Python loop over layers, final norm, head.

Parameters are plain dicts of tensors: {"embed", "final_norm", "layers":
[block params per layer], and "head" when embeddings are untied}.  Caches
are {"layers": [per-layer cache dict]} and are updated in place.  The entry
points run on the card by default (`device="cuda"`) and raise when CUDA is
absent; tests pass device="cpu" explicitly.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import packed
from repro_torch.core.encoding import Phase
from repro_torch.models import blocks
from repro_torch.models import layers as L


def resolve_device(device: torch.device | str) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist (no quiet CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain versions on the CPU"
        )
    return device


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or tuple(cfg.block_pattern) != ("attn",):
        raise NotImplementedError(
            f"family {cfg.family!r} / pattern {cfg.block_pattern} waits for its "
            "family's slice (ROADMAP, modules to port: other model families)"
        )


def model_init(cfg: ModelConfig, enc: packed.EncodingConfig, *, seed: int = 0,
               device: torch.device | str = "cuda") -> dict:
    """Random weights from `seed` (torch.Generator on `device`)."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    dt = cfg.activation_dtype
    # Vocab rows padded to a multiple of 256, as in the JAX package; ids
    # never index the pad and logits are sliced back to vocab_size.
    v_pad = v + (-v) % 256
    params = {
        "embed": (d**-0.5 * torch.randn((v_pad, d), generator=gen, device=device)).to(dt),
        "final_norm": L.norm_init(cfg, device=device),
        "layers": [blocks.attn_block_init(gen, cfg, enc, device=device)
                   for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        params["head"] = packed.linear_init(gen, d, v, enc=enc, dtype=dt, device=device)
    return params


def cache_init(cfg: ModelConfig, batch: int, max_seq: int, *, cache_mode: str = "dense",
               block_size: int = 16, num_pages: int | None = None,
               device: torch.device | str = "cuda") -> dict:
    """Per-layer caches.  "dense": (batch, max_seq) K/V rows (the engine's
    temporary prefill cache).  "paged": one page pool per layer plus a block
    table shared by all layers (page 0 is scratch)."""
    _check_family(cfg)
    device = resolve_device(device)
    if cache_mode == "dense":
        return {"layers": [L.attn_cache_init(cfg, batch, max_seq, device=device)
                           for _ in range(cfg.num_layers)]}
    if cache_mode != "paged":
        raise ValueError(f"cache_mode must be 'dense' or 'paged', got {cache_mode!r}")
    if num_pages is None:
        num_pages = 1 + batch * (-(-max_seq // block_size))
    first = L.attn_paged_cache_init(cfg, batch, max_seq, block_size=block_size,
                                    num_pages=num_pages, device=device)
    rest = [L.attn_paged_cache_init(cfg, batch, max_seq, block_size=block_size,
                                    num_pages=num_pages, device=device,
                                    table=first["table"])
            for _ in range(cfg.num_layers - 1)]
    return {"layers": [first] + rest}


def forward(params: dict, tokens: torch.Tensor, *, cfg: ModelConfig,
            enc: packed.EncodingConfig, phase: Phase, caches: dict | None = None,
            pos: torch.Tensor | int = 0, last_logits_only: bool = False) -> torch.Tensor:
    """tokens (B, S) -> f32 logits (B, S or 1, vocab); caches update in place.

    `pos` is the position of tokens[:, 0]: an int shared by every row, or a
    (B,) tensor (decode: each row at its own depth)."""
    x = params["embed"][tokens].to(cfg.activation_dtype)
    layer_caches = caches["layers"] if caches is not None else [None] * len(params["layers"])
    for lp, lc in zip(params["layers"], layer_caches):
        x = blocks.attn_block_apply(lp, x, cfg=cfg, enc=enc, phase=phase, cache=lc, pos=pos)
    if last_logits_only:
        x = x[:, -1:, :]
    x = L.norm_apply(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        # A plain product outside any kernel, as the JAX package leaves it to
        # XLA.  It runs in the activation dtype (bf16 logits are rounded
        # before the f32 cast, where JAX keeps f32 out of the einsum).
        logits = torch.matmul(x, params["embed"].t()).float()[..., : cfg.vocab_size]
    else:
        logits = packed.linear_apply(params["head"], x, n=cfg.vocab_size, phase=phase,
                                     enc=enc, out_dtype=torch.float32)
    return logits
