"""Full model (counterpart of repro/models/transformer.py) for every family
of the JAX package: embedding, a Python loop over layers, final norm, head.

Layer i is a block of type block_pattern[i % len(pattern)]: the JAX
package's full pattern groups followed by its partial tail group (e.g.
RecurrentGemma's 38 = 12 x (rec, rec, attn) + (rec, rec)), in the same
order.  Parameters are plain dicts of tensors: {"embed", "final_norm",
"layers": [block params per layer], and "head" when embeddings are untied};
an enc-dec model adds "enc_layers" (its encoder blocks), "enc_final_norm"
and "dec_pos_embed" (max_pos_embed, d_model), a VLM the patch "projector"
{"ln" over frontend_dim, "fc1", "fc2"}.  The frontends are stubs, as in
JAX: the caller hands forward precomputed frame or patch embeddings.
Caches are {"layers": [per-layer cache dict]} and are updated in place: an
attention layer's K/V rows, a recurrent layer's state, an enc-dec layer's
self K/V rows and its cross K/V.  Under Phase.TRAIN (loss_fn) each layer
is rematerialised in the backward pass (torch.utils.checkpoint), as the JAX
package wraps each scan group in jax.checkpoint.  The entry points run on the card by
default (`device="cuda"`) and raise when CUDA is absent; tests pass
device="cpu" explicitly.

Tensor-parallel serving (`tp=`, a parallel/sharding.Shard) runs one rank's
part: `cfg` is the shard's (its heads and FFN columns), the caches hold
its kv heads, and the vocabulary is split by rows: the embedding looks up
the ids in the rank's rows, zeroes the others and sums over the group (one
nonzero row and zeros: exact), and the head computes the rank's logit
columns and gathers them, so every rank holds the same full logits.
model_init(shard=) makes a rank's part directly, drawing every weight as
the full init does and keeping only its slice.
"""

from __future__ import annotations

import functools
from collections.abc import Callable

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import encoding
from repro_torch.core import packed
from repro_torch.core.encoding import Phase
from repro_torch.models import blocks
from repro_torch.models import layers as L
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding


def resolve_device(device: torch.device | str) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist (no quiet CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain versions on the CPU"
        )
    return device


FAMILIES = ("dense", "moe", "rwkv", "hybrid", "encdec", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES or not all(t in blocks.BLOCKS for t in cfg.block_pattern):
        raise ValueError(f"unknown family {cfg.family!r} or block type in "
                         f"{cfg.block_pattern}; families: {FAMILIES}, blocks: "
                         f"{tuple(blocks.BLOCKS)}")


def layer_types(cfg: ModelConfig) -> list[str]:
    """The block type of every layer, in order: the pattern's full groups,
    then its partial tail group."""
    pat = cfg.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def attention_only(cfg: ModelConfig) -> bool:
    return all(t == "attn" for t in cfg.block_pattern)


def model_init(cfg: ModelConfig, enc: packed.EncodingConfig, *, seed: int = 0,
               device: torch.device | str = "cuda",
               shard: sharding.Shard | None = None) -> dict:
    """Random weights from `seed` (torch.Generator on `device`).  With
    `shard`, one tensor-parallel rank's part of the same weights, drawn in
    the same order: each layer is drawn whole and sliced at once, an MoE
    layer each expert projection as it is drawn, so a rank never holds more
    than one full dense layer or one full expert projection."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    dt = cfg.activation_dtype
    group = enc.quant_group

    def part(kind, x):
        if shard is None:
            return x
        if kind == "embed":
            return sharding.shard_embed(x, shard)
        if kind == "head":
            return sharding.shard_head(x, cfg, shard, group)
        return sharding.shard_layer(x, cfg, shard, group, experts=False)

    def layer(t):
        kw = {}
        if shard is not None and t == "attn" and cfg.num_experts:
            kw["take_expert"] = functools.partial(sharding.shard_ffn_linear, full=cfg,
                                                  shard=shard, group=group)
        return part("layer", blocks.BLOCKS[t][0](gen, cfg, enc, device=device, **kw))

    # Vocab rows padded to a multiple of 256, as in the JAX package; ids
    # never index the pad and logits are sliced back to vocab_size.
    v_pad = sharding.vocab_padded(cfg)
    params = {
        "embed": part("embed", (d**-0.5 * torch.randn((v_pad, d), generator=gen,
                                                      device=device)).to(dt)),
        "final_norm": L.norm_init(cfg, device=device),
        "layers": [layer(t) for t in layer_types(cfg)],
    }
    if not cfg.tie_embeddings:
        params["head"] = part("head", packed.linear_init(gen, d, v, enc=enc, dtype=dt,
                                                         device=device))
    if shard is not None:
        params["tp_shard"] = (shard.tp, shard.rank)
    if cfg.family == "encdec":
        params["enc_layers"] = [blocks.BLOCKS["enc_attn"][0](gen, cfg, enc, device=device)
                                for _ in range(cfg.encoder_layers)]
        params["enc_final_norm"] = L.norm_init(cfg, device=device)
        params["dec_pos_embed"] = (
            0.02 * torch.randn((cfg.max_pos_embed, d), generator=gen, device=device)).to(dt)
    if cfg.family == "vlm":
        fd = cfg.frontend_dim or d
        kw = dict(enc=enc, dtype=dt, device=device)
        params["projector"] = {"ln": L.norm_init(cfg, device=device, dim=fd),
                               "fc1": packed.linear_init(gen, fd, d, **kw),
                               "fc2": packed.linear_init(gen, d, d, **kw)}
    return params


def cache_init(cfg: ModelConfig, batch: int, max_seq: int, *, cache_mode: str = "dense",
               block_size: int = 16, num_pages: int | None = None, kv_quant: str = "bf16",
               device: torch.device | str = "cuda") -> dict:
    """Per-layer caches.  "dense": an attention layer's (batch, max_seq) K/V
    rows in the activation dtype (the dense serving cache, and the paged
    engine's temporary prefill cache), a ring of min(max_seq, window) rows
    under a sliding window; a recurrent layer's state (zero); an enc-dec
    layer's self K/V rows and its (batch, frontend_tokens) cross K/V.
    "paged": one page pool per layer plus a block table shared by all layers
    (page 0 is scratch), for attention-only patterns; `kv_quant` kv8/kv4 pools carry
    float32 scale pages (layers.attn_paged_cache_init).  Quantized layouts
    live in the paged pool only, as in the JAX package."""
    _check_family(cfg)
    device = resolve_device(device)
    if cache_mode == "dense":
        if kv_quant != "bf16":
            raise ValueError(f"quantized KV layouts need the paged cache, got {kv_quant!r}")
        return {"layers": [blocks.BLOCKS[t][2](cfg, batch, max_seq, device=device)
                           for t in layer_types(cfg)]}
    if cache_mode != "paged":
        raise ValueError(f"cache_mode must be 'dense' or 'paged', got {cache_mode!r}")
    if not attention_only(cfg):
        raise ValueError("the paged KV cache needs an attention-only pattern; recurrent "
                         "and enc-dec families keep dense caches, got "
                         f"{cfg.block_pattern}")
    if num_pages is None:
        num_pages = 1 + batch * (-(-max_seq // block_size))
    kw = dict(block_size=block_size, num_pages=num_pages, device=device, kv_quant=kv_quant)
    first = L.attn_paged_cache_init(cfg, batch, max_seq, **kw)
    rest = [L.attn_paged_cache_init(cfg, batch, max_seq, table=first["table"], **kw)
            for _ in range(cfg.num_layers - 1)]
    return {"layers": [first] + rest}


def layer_weight_shapes(cfg: ModelConfig, block: str) -> list[tuple[int, int]]:
    """(N, K) of every projection weight a layer of type `block` holds, in
    init order (an MoE layer's router, of shape (E, D), comes first of its
    FFN's; each expert's three weights follow; an enc-dec decoder layer's
    self attention's four, then its cross attention's four, then the
    MLP's)."""
    d, f = cfg.d_model, cfg.d_ff
    ffn = [(f, d), (f, d), (d, f)] if cfg.mlp_kind == "swiglu" else [(f, d), (d, f)]
    if block == "rwkv":
        return [(d, d)] * 5 + [(f, d), (d, f), (d, d)]
    if block == "rec":
        rw = cfg.rnn_width or d
        return [(rw, d), (rw, d), (rw, rw), (rw, rw), (d, rw)] + ffn
    hd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = [(hd, d), (kvd, d), (kvd, d), (d, hd)]
    if block == "encdec_attn":
        return shapes + shapes + ffn
    if cfg.num_experts:
        return shapes + [(cfg.num_experts, d)] + ffn * cfg.num_experts
    return shapes + ffn


def zero_state(cfg: ModelConfig, caches: dict) -> dict:
    """Zero every recurrent layer's state in `caches` in place (attention
    K/V rows are left as they are: their position masks hide them) and
    return `caches`."""
    for t, layer in zip(layer_types(cfg), caches["layers"]):
        if t in ("rec", "rwkv"):
            for leaf in layer.values():
                leaf.zero_()
    return caches


def cache_bytes(caches: dict) -> int:
    """Bytes of every leaf of `caches`: K/V rows, pools, recurrent state and
    cross K/V."""
    return sum(leaf.numel() * leaf.element_size()
               for layer in caches["layers"] for leaf in layer.values())


def decode_weight_stream_bytes(cfg: ModelConfig, enc: packed.EncodingConfig) -> dict[str, int]:
    """Weight bytes one decode step reads from device memory: every layer's
    projections in `enc`'s weight format (encoding.quant_weight_stream_bytes)
    and the head (the tied embedding in the activation dtype).  An MoE
    layer streams its router (f32 in the unquantized formats) and all E
    experts: every expert runs on its capacity rows at every step.  An RWKV
    layer streams its 5 time-mix and 3 channel-mix projections and its f32
    decay LoRA; an RG-LRU layer its 5 projections and its MLP.  An enc-dec
    decoder layer streams all its projections but the cross wk and wv (the
    cross K/V are cached at prefill); the encoder and a VLM's projector run
    at prefill only and stream nothing at decode (nor do the few rows of
    dec_pos_embed a step gathers count here)."""
    _check_family(cfg)
    quant = packed.QUANT_KEYS[enc.weight_quant] if enc.enabled else "none"
    itemsize = torch.empty((), dtype=cfg.activation_dtype).element_size()
    d = cfg.d_model

    def stream(n, k, size=itemsize):
        return encoding.quant_weight_stream_bytes(n, k, quant=quant, weight_itemsize=size,
                                                  group=enc.quant_group)

    def per_layer(block):
        shapes = layer_weight_shapes(cfg, block)
        if block == "attn" and cfg.num_experts:
            router = shapes.pop(4)
            return stream(*router, size=4) + sum(stream(n, k) for n, k in shapes)
        if block == "encdec_attn":
            del shapes[5:7]  # the cross wk, wv
        total = sum(stream(n, k) for n, k in shapes)
        if block == "rwkv":
            total += 2 * d * max(16, d // 32) * 4  # w_lora_a, w_lora_b
        return total

    v = cfg.vocab_size
    head = (v + (-v) % 256) * d * itemsize if cfg.tie_embeddings else stream(v, d)
    return {"projections": sum(per_layer(t) for t in layer_types(cfg)), "head": head}


def sinusoids(t: int, d: int, device) -> torch.Tensor:
    """The encoder's f32 positions (t, d): angle pos / 10000^(2i/d) for i <
    d/2, the sines then the cosines."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _run_encoder(params: dict, frames: torch.Tensor, cfg: ModelConfig,
                 enc: packed.EncodingConfig, phase: Phase) -> torch.Tensor:
    """The Whisper encoder over precomputed frame embeddings (B, Te,
    d_model), the conv frontend being a stub: the sinusoids rounded to the
    activation dtype and added, the encoder blocks, the final norm."""
    x = frames.to(cfg.activation_dtype)
    x = x + sinusoids(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    for lp in params["enc_layers"]:
        x = blocks.BLOCKS["enc_attn"][1](lp, x, cfg=cfg, enc=enc, phase=phase, cache=None, pos=0)
    return L.norm_apply(params["enc_final_norm"], x, cfg)


def _project_patches(params: dict, patches: torch.Tensor, cfg: ModelConfig,
                     enc: packed.EncodingConfig, phase: Phase) -> torch.Tensor:
    """The VLM projector over precomputed patch embeddings (B, P,
    frontend_dim): norm, fc1, tanh GELU in f32, fc2 -> (B, P, d_model)."""
    pj, d, dt = params["projector"], cfg.d_model, cfg.activation_dtype
    y = L.norm_apply(pj["ln"], patches.to(dt), cfg)
    y = packed.linear_apply(pj["fc1"], y, n=d, phase=phase, enc=enc)
    y = F.gelu(y.float(), approximate="tanh").to(dt)
    return packed.linear_apply(pj["fc2"], y, n=d, phase=phase, enc=enc)


def forward(params: dict, tokens: torch.Tensor, *, cfg: ModelConfig,
            enc: packed.EncodingConfig, phase: Phase, caches: dict | None = None,
            pos: torch.Tensor | int = 0, last_logits_only: bool = False,
            logits_idx: torch.Tensor | None = None, frames: torch.Tensor | None = None,
            patches: torch.Tensor | None = None, aux: list | None = None,
            tp: sharding.Shard | None = None) -> torch.Tensor:
    """tokens (B, S) -> f32 logits (B, S or 1 or K, vocab); caches update in place.

    `pos` is the position of tokens[:, 0]: an int shared by every row, or a
    (B,) tensor (decode: each row at its own depth; S > 1 is a masked-causal
    window, the verify window of speculative decode or the token-budget mixed
    step's chunk).  `logits_idx` (B, K) int keeps only those per-row window
    positions: the hidden states are gathered before the final norm and the
    head, so a chunk row pays for K logit rows, never S.  It overrides
    last_logits_only.

    An enc-dec model takes `frames` (B, Te, d_model) at every phase but
    DECODE: the encoder runs over them and every decoder layer attends its
    output (and caches its cross K/V); its decoder adds dec_pos_embed at
    positions pos .. pos + S - 1 (per row for a (B,) pos).  A VLM takes
    `patches` (B, P, frontend_dim) at every phase but DECODE: the projected
    patches are prepended to the token embeddings, so the text starts at
    position P, logits cover the P + S positions, and decode goes on at
    P + S.

    `aux`, where a list, receives every layer's training aux losses in
    layer order (an MoE layer's load-balance loss; JAX's forward returns
    their sum).  Under Phase.TRAIN with autograd on, each layer runs under
    torch.utils.checkpoint: only its input is kept, and the backward pass
    recomputes it.

    `tp`: one tensor-parallel rank's forward (module docstring); `cfg` and
    `params` are then the shard's, and the logits every rank returns are
    the same full logits."""
    vocab_group = tp.group if tp is not None and tp.vocab_split else None
    if vocab_group is None:
        x = params["embed"][tokens].to(cfg.activation_dtype)
    else:
        x = _embed_rows(params["embed"], tokens, tp).to(cfg.activation_dtype)
    b, s = tokens.shape
    extra = None
    if cfg.family == "encdec":
        if phase is not Phase.DECODE:
            if frames is None:
                raise ValueError("an enc-dec model needs `frames` at every phase but DECODE")
            extra = _run_encoder(params, frames, cfg, enc, phase)
        steps = torch.arange(s, device=x.device)
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            posn = pos.to(x.device).long()[:, None] + steps[None, :]
        else:
            posn = (int(pos) + steps)[None, :].expand(b, s)
        x = x + params["dec_pos_embed"][posn]
    elif cfg.family == "vlm" and phase is not Phase.DECODE:
        if patches is None:
            raise ValueError("a VLM needs `patches` at every phase but DECODE")
        x = torch.cat([_project_patches(params, patches, cfg, enc, phase), x], dim=1)
    layer_caches = caches["layers"] if caches is not None else [None] * len(params["layers"])
    remat = phase is Phase.TRAIN and torch.is_grad_enabled()
    for t, lp, lc in zip(layer_types(cfg), params["layers"], layer_caches):
        apply = functools.partial(blocks.BLOCKS[t][1], lp, cfg=cfg, enc=enc, phase=phase,
                                  cache=lc, pos=pos, extra=extra,
                                  **({} if tp is None else {"tp": tp}))
        if remat:
            x, *layer_aux = torch.utils.checkpoint.checkpoint(_with_aux, apply, x,
                                                              use_reentrant=False)
            if aux is not None:
                aux.extend(layer_aux)
        else:
            x = apply(x, aux=aux)
    if logits_idx is not None:
        idx = logits_idx.to(device=x.device, dtype=torch.int64)
        x = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    elif last_logits_only:
        x = x[:, -1:, :]
    x = L.norm_apply(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        # A plain product outside any kernel, as the JAX package leaves it to
        # XLA.  It runs in the activation dtype (bf16 logits are rounded
        # before the f32 cast, where JAX keeps f32 out of the einsum).
        logits = torch.matmul(x, params["embed"].t()).float()
    else:
        n = cfg.vocab_size if vocab_group is None else tp.vocab_rows
        logits = packed.linear_apply(params["head"], x, n=n, phase=phase,
                                     enc=enc, out_dtype=torch.float32)
    if vocab_group is not None:
        logits = collectives.all_gather_last(logits, vocab_group)
    return logits[..., : cfg.vocab_size]


def _embed_rows(embed: torch.Tensor, tokens: torch.Tensor, tp: sharding.Shard) -> torch.Tensor:
    """The vocabulary-parallel lookup: this rank's rows for the ids it holds,
    zeros for the rest, summed over the group in f32 (exact: one nonzero
    row per id)."""
    local = tokens.long() - tp.vocab_lo
    mine = (local >= 0) & (local < tp.vocab_rows)
    rows = embed[torch.clamp(local, 0, tp.vocab_rows - 1)].float()
    rows = torch.where(mine[..., None], rows, torch.zeros((), device=rows.device))
    return collectives.all_reduce_sum(rows, tp.group)


def _with_aux(apply, x: torch.Tensor) -> tuple:
    """apply(x) and the aux losses it hands out, as one tuple of tensors
    (a checkpointed function's outputs)."""
    found: list = []
    return (apply(x, aux=found), *found)


def loss_fn(params: dict, batch: dict, *, cfg: ModelConfig,
            enc: packed.EncodingConfig) -> tuple[torch.Tensor, dict]:
    """The training objective (JAX transformer.loss_fn): next-token cross
    entropy lse - ll averaged over every position, plus 0.01 x the summed
    load-balance aux (0 without MoE layers).  batch: "tokens" and "labels"
    (B, S) int64, with "frames" for an enc-dec model and "patches" for a
    VLM, whose image-prefix positions carry no labels and are cut before the
    loss.  Returns (loss, {"nll", "aux"}), f32 scalars."""
    auxes: list = []
    logits = forward(params, batch["tokens"], cfg=cfg, enc=enc, phase=Phase.TRAIN,
                     frames=batch.get("frames"), patches=batch.get("patches"), aux=auxes)
    labels = batch["labels"]
    if cfg.family == "vlm":
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - ll).mean()
    aux = sum(auxes) if auxes else torch.zeros((), dtype=torch.float32, device=logits.device)
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


def greedy_generate(params: dict, prompts: list, *, cfg: ModelConfig,
                    enc: packed.EncodingConfig, max_new: int, max_seq: int,
                    frames: torch.Tensor | None = None, patches: torch.Tensor | None = None,
                    device: torch.device | str = "cuda",
                    on_step: Callable[[], None] | None = None) -> list[list[int]]:
    """Greedy tokens of a batch of prompts through `forward` on dense
    caches, the path the JAX package runs every family on outside its
    engine (its engine takes tokens only): one right-padded prefill of all
    prompts (with `frames` or `patches` for enc-dec and VLM models), the
    first token from each row's last prompt position (logits_idx), then
    max_new - 1 cached decode steps of one token a row, row b at its own
    position (P + len_b for a VLM's P patches).  A pad's K/V sit past its
    row's last token, masked until that row's decode overwrites them.

    Returns the tokens per prompt.  `on_step`, where given, is called
    before the prefill and after each forward once its tokens are launched
    (nothing here waits for the device: a caller that times the steps
    synchronizes there)."""
    device = resolve_device(device)
    lens = [len(p) for p in prompts]
    toks = np.zeros((len(prompts), max(lens)), np.int64)
    for row, p in enumerate(prompts):
        toks[row, :len(p)] = p
    off = patches.shape[1] if cfg.family == "vlm" else 0
    pos = off + torch.tensor(lens, device=device)
    caches = cache_init(cfg, len(prompts), max_seq, device=device)
    step = on_step or (lambda: None)
    out = []
    with torch.no_grad():
        step()
        logits = forward(params, torch.from_numpy(toks).to(device), cfg=cfg, enc=enc,
                         phase=Phase.PREFILL, caches=caches, logits_idx=(pos - 1)[:, None],
                         frames=frames, patches=patches)
        out.append(torch.argmax(logits[:, 0], dim=-1))
        step()
        for _ in range(max_new - 1):
            logits = forward(params, out[-1][:, None], cfg=cfg, enc=enc, phase=Phase.DECODE,
                             caches=caches, pos=pos)
            out.append(torch.argmax(logits[:, 0], dim=-1))
            pos = pos + 1
            step()
    return torch.stack(out, dim=1).tolist()
