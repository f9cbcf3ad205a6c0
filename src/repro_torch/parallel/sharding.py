"""Tensor-parallel sharding rules (counterpart of repro/parallel/sharding.py).

The classification is JAX's, word for word (`_COLUMN_NAMES`, `_ROW_NAMES`,
`_REPLICATED_NAMES`, the leaf rules of `param_spec` and of
`serving_cache_shardings`; `param_role` and `cache_role` name the role the
JAX spec gives the "model" axis, with fsdp off as the JAX engine shards):

  column      output rows split: wq, wk, wv, w_gate, w_up, an untied head
              (and the recurrent families' input projections), with the
              column bias `b` and the int8 per-channel `w_scale`
  row         input columns split: wo, w_down (cm_wv, w_out); the output is
              summed over the group, a row bias added once after the sum
  vocab       the embedding's rows
  replicated  norms, the router, row-parallel int8 scales, every other leaf
  heads       K/V pages and their kv8/kv4 scale pages, on the kv-head axis

One rule is the port's own: JAX names no int4 leaf, so it replicates
`w_q4`/`w_scale4`; the port splits them like any other weight (a column
split by output rows; a row split on whole quantization groups).

What differs from JAX is the unit of the split.  JAX splits packed
(128 x 128) tiles and `sanitize` drops an axis whose tile count the degree
does not divide, leaving GSPMD to re-gather inside a head.  The port's
collectives are explicit, so it splits whole heads and whole rows, and each
rank packs its own slice at (N0, K0) = (128, 128) (`shard_params`: the very
codes and scales of the full weight, nothing requantized).  The port's
sanitize (`plan`) replicates what the degree tp cannot split whole; these
are the whole-head replications (`Shard.replicated` names the ones a plan
makes):

  kv_heads   tp does not divide the kv heads but they divide tp (a reduced
             config's single kv head, or Qwen2-1.5B's 2 at tp = 4): every
             rank holds the one kv head its query heads read, so each kv
             head lives on tp / kv ranks; the query heads still split
  attention  tp divides neither the query heads nor, as above, the kv
             heads, or a w4a8 wo slice would cut a quantization group:
             every rank holds and computes the whole attention, no reduce
  mlp        tp does not divide d_ff (an MoE's: each expert's), or a w4a8
             w_down slice would cut a group: every rank computes the whole
             MLP or every whole expert, no reduce
  vocab      tp does not divide the padded vocabulary: the embedding and
             head replicate

An MoE layer splits as JAX's rule splits it: the expert axis never, each
expert's w_gate/w_up column-parallel and its w_down row-parallel over the
plan's FFN columns (`d_ff` being the experts'), the router replicated;
every rank routes its (replicated) rows alike (models/layers.moe_apply).

Tensor parallelism serves the attention-only token families (Llama,
Qwen2/2.5, Yi) and the MoE family (Mixtral, Grok); the recurrent blocks
raise NotImplementedError at tp > 1 (`check_servable`) until a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import packed

# Path-name classification for packed (or plain transposed) weights.
_COLUMN_NAMES = {
    "wq", "wk", "wv", "w_gate", "w_up", "cm_wk", "w_in", "w_gate_branch",
    "wr", "wg", "w_a", "w_x", "fc1", "fc2", "head",
}
_ROW_NAMES = {"wo", "w_down", "cm_wv", "w_out"}
_REPLICATED_NAMES = {"router"}

# Leaves the port splits where JAX replicates (JAX's rules name no int4 leaf).
PORT_ONLY_SPLITS = ("w_q4", "w_scale4")


def path_names(path) -> list[str]:
    """A tree path's names: dict keys as they are, sequence indices "[i]"."""
    return [f"[{p}]" if isinstance(p, int) else str(p) for p in path]


def _owner(names: list[str]) -> str:
    """The leaf's projection: the last name before it that is not an index
    (the port keeps a layer's experts in a list where JAX stacks them)."""
    for name in reversed(names[:-1]):
        if not name.startswith("["):
            return name
    return ""


def param_role(names: list[str], ndim: int) -> str:
    """"column" | "row" | "vocab" | "replicated" for one parameter leaf, by
    the rules of JAX param_spec (fsdp off), plus the int4 leaves."""
    leafname = names[-1] if names else ""
    owner = _owner(names)
    is_col = owner in _COLUMN_NAMES
    if leafname == "w_scale" and ndim >= 2:  # int8 per-channel scales (..., N1, N0)
        return "column" if is_col else "replicated"
    if leafname in ("w_packed", "w_q", "w_q4", "w_scale4") or (leafname == "w_t" and ndim >= 2):
        if owner in _REPLICATED_NAMES:
            return "replicated"
        return "column" if is_col else "row"
    if leafname == "embed":
        return "vocab"
    if leafname == "b" and is_col and ndim == 1:
        return "column"
    return "replicated"


def cache_role(names: list[str], ndim: int) -> str:
    """"heads" | "replicated" for one cache leaf, by the rule of JAX
    serving_cache_shardings: K/V data and scale pages (and dense rows) split
    on the kv-head axis (-2), block tables and everything else replicated."""
    leafname = names[-1] if names else ""
    if leafname in ("k", "v", "cross_k", "cross_v", "k_scale", "v_scale") and ndim >= 4:
        return "heads"
    return "replicated"


def check_servable(cfg: ModelConfig, tp: int) -> None:
    """Tensor parallelism serves the attention blocks, dense or MoE; the
    recurrent blocks wait for a later slice (JAX serves them under GSPMD)."""
    if tp <= 1:
        return
    other = sorted(set(cfg.block_pattern) - {"attn"})
    if other:
        raise NotImplementedError(
            f"tensor-parallel serving (mesh tp={tp}) of {cfg.name} ({cfg.family}, blocks "
            f"{sorted(set(cfg.block_pattern))}) is not ported yet: tp > 1 serves the attention "
            f"blocks, dense and MoE, not {other}; the recurrent blocks at tp > 1 (each rank its "
            "own RWKV heads or RG-LRU channels) are ROADMAP Queue 1's item \"the recurrent "
            "blocks at tp > 1\"")


@dataclasses.dataclass(frozen=True)
class Shard:
    """One rank's part of a model at tensor-parallel degree `tp`: the heads,
    FFN columns and vocabulary rows it holds, `cfg` with its local head and
    FFN counts, and `group`, the tensor-parallel group its collectives run
    on (None in a plan made outside one)."""

    tp: int
    rank: int
    cfg: ModelConfig            # num_heads, num_kv_heads, d_ff: this rank's
    q_lo: int                   # first query head
    kv_lo: int                  # first kv head
    ff_lo: int                  # first FFN column
    vocab_lo: int               # first embedding row
    vocab_rows: int
    attn_split: bool
    mlp_split: bool
    vocab_split: bool
    replicated: tuple[str, ...]  # the whole-head replications this plan makes
    group: object = None


def vocab_padded(cfg: ModelConfig) -> int:
    """Embedding rows: the vocabulary padded to a multiple of 256, as
    transformer.model_init makes them."""
    return cfg.vocab_size + (-cfg.vocab_size) % 256


def plan(cfg: ModelConfig, enc: packed.EncodingConfig, tp: int, rank: int,
         group=None) -> Shard:
    """Rank `rank`'s shard of `cfg` at degree `tp` (see the module docstring
    for what is split and what replicates)."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside a tensor-parallel group of {tp}")
    check_servable(cfg, tp)
    h, kv, hd, f = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    int4 = enc.enabled and enc.weight_quant == "int4"
    g = enc.quant_group
    replicated = []
    kv_split = kv % tp == 0
    kv_shared = not kv_split and tp % kv == 0
    attn_split = (tp > 1 and h % tp == 0 and (kv_split or kv_shared)
                  and not (int4 and (h // tp * hd) % g))
    if attn_split:
        hl = h // tp
        kvl = kv // tp if kv_split else 1
        q_lo = rank * hl
        kv_lo = rank * kvl if kv_split else q_lo // (h // kv)
        if kv_shared:
            replicated.append("kv_heads")
    else:
        hl, kvl, q_lo, kv_lo = h, kv, 0, 0
        if tp > 1:
            replicated.append("attention")
    mlp_split = tp > 1 and f % tp == 0 and not (int4 and (f // tp) % g)
    fl = f // tp if mlp_split else f
    if tp > 1 and not mlp_split:
        replicated.append("mlp")
    vp = vocab_padded(cfg)
    vocab_split = tp > 1 and vp % tp == 0
    vr = vp // tp if vocab_split else vp
    if tp > 1 and not vocab_split:
        replicated.append("vocab")
    local = dataclasses.replace(cfg, num_heads=hl, num_kv_heads=kvl, d_ff=fl)
    return Shard(tp=tp, rank=rank, cfg=local, q_lo=q_lo, kv_lo=kv_lo,
                 ff_lo=rank * fl if mlp_split else 0,
                 vocab_lo=rank * vr if vocab_split else 0, vocab_rows=vr,
                 attn_split=attn_split, mlp_split=mlp_split, vocab_split=vocab_split,
                 replicated=tuple(replicated), group=group)


# ---- slicing a parameter tree -----------------------------------------------------------


def _slice_plain(plain: dict, axis: str, lo: int, hi: int, group: int) -> dict:
    """Rows [lo, hi) (axis "rows": output channels, with their scales and
    bias) or columns [lo, hi) (axis "cols": input features, with the int4
    groups they span) of a projection's plain form."""
    out = {}
    for name, t in plain.items():
        if axis == "rows":
            out[name] = t[lo:hi]
        elif name in ("s", "b"):
            out[name] = t  # per output channel: a row split leaves it whole
        elif name == "s4":
            if lo % group or hi % group:
                raise ValueError(f"int4 columns {lo}:{hi} cut a group of {group}")
            out[name] = t[:, lo // group: hi // group]
        else:
            out[name] = t[:, lo:hi]
    return out


def shard_linear(p: dict, n: int, k: int, axis: str, lo: int, hi: int, *,
                 group: int, rows_to: int | None = None) -> dict:
    """The slice [lo, hi) of projection `p` (N = n, K = k) on `axis`
    ("rows" or "cols"), packed again.  `rows_to` first zero-pads the rows
    to that many (the head's vocabulary padding)."""
    plain = packed.linear_plain(p, n, k, group=group)
    if rows_to is not None and rows_to > n:
        plain = {name: torch.cat([t, t.new_zeros((rows_to - n, *t.shape[1:]))])
                 for name, t in plain.items()}
    return packed.linear_from_plain(_slice_plain(plain, axis, lo, hi, group), group=group)


def shard_ffn_linear(name: str, p: dict, full: ModelConfig, shard: Shard, group: int) -> dict:
    """One FFN projection on this rank, a dense MLP's or an expert's, cut to
    the rank's FFN units: their output rows of w_gate/w_up
    (column-parallel), their input columns of w_down (row-parallel); the
    whole projection where the plan does not split the MLP."""
    if not shard.mlp_split:
        return p
    lo, hi = shard.ff_lo, shard.ff_lo + shard.cfg.d_ff
    if name == "w_down":
        return shard_linear(p, full.d_model, full.d_ff, "cols", lo, hi, group=group)
    return shard_linear(p, full.d_ff, full.d_model, "rows", lo, hi, group=group)


def shard_layer(lp: dict, full: ModelConfig, shard: Shard, group: int, *,
                experts: bool = True) -> dict:
    """An attention block's parameters (ln1, attn, ln2, mlp or moe) on this
    rank: query heads and their kv heads column-split, wo row-split by its
    input heads, the MLP's or every expert's projections by FFN columns
    (shard_ffn_linear), the router, the norms and whatever the plan
    replicates whole.  `experts=False` leaves the experts as they are
    (transformer.model_init(shard=) slices each as it draws it)."""
    d, hd = full.d_model, full.head_dim
    loc = shard.cfg
    out = dict(lp)
    if shard.attn_split:
        a = lp["attn"]
        q = (shard.q_lo * hd, (shard.q_lo + loc.num_heads) * hd)
        kv = (shard.kv_lo * hd, (shard.kv_lo + loc.num_kv_heads) * hd)
        kvd = full.num_kv_heads * hd
        out["attn"] = {
            "wq": shard_linear(a["wq"], full.num_heads * hd, d, "rows", *q, group=group),
            "wk": shard_linear(a["wk"], kvd, d, "rows", *kv, group=group),
            "wv": shard_linear(a["wv"], kvd, d, "rows", *kv, group=group),
            "wo": shard_linear(a["wo"], d, full.num_heads * hd, "cols", *q, group=group),
        }
    if "mlp" in lp:
        out["mlp"] = {name: shard_ffn_linear(name, p, full, shard, group)
                      for name, p in lp["mlp"].items()}
    if "moe" in lp and experts:
        out["moe"] = {name: p if name == "router" else
                      [shard_ffn_linear(name, e, full, shard, group) for e in p]
                      for name, p in lp["moe"].items()}
    return out


def shard_embed(embed: torch.Tensor, shard: Shard) -> torch.Tensor:
    """This rank's embedding rows (a copy, so the full table can be freed)."""
    if not shard.vocab_split:
        return embed
    return embed[shard.vocab_lo: shard.vocab_lo + shard.vocab_rows].clone()


def shard_head(head: dict, full: ModelConfig, shard: Shard, group: int) -> dict:
    """An untied head's vocabulary rows on this rank, padded like the
    embedding so every rank's logit slice has vocab_rows columns."""
    if not shard.vocab_split:
        return head
    lo = shard.vocab_lo
    return shard_linear(head, full.vocab_size, full.d_model, "rows", lo, lo + shard.vocab_rows,
                        group=group, rows_to=vocab_padded(full))


def shard_params(params: dict, full: ModelConfig, enc: packed.EncodingConfig,
                 shard: Shard) -> dict:
    """This rank's parameters, from the full `params` (transformer.model_init
    or convert.params_from_jax): every leaf either sliced by `shard` and
    packed again, or the full tensor itself where it is replicated.  The
    result is marked "tp_shard": (tp, rank), which the engine reads to take
    it as it is (transformer.model_init(shard=) marks its result so too)."""
    check_servable(full, shard.tp)
    out = dict(params)
    out["embed"] = shard_embed(params["embed"], shard)
    out["layers"] = [shard_layer(lp, full, shard, enc.quant_group) for lp in params["layers"]]
    if "head" in params:
        out["head"] = shard_head(params["head"], full, shard, enc.quant_group)
    out["tp_shard"] = (shard.tp, shard.rank)
    return out
