"""The collectives of tensor-parallel serving (port-only; the JAX package
leaves them to GSPMD).

Three carry the forward's data, on a rank's tensor-parallel group:

  all_reduce_sum   the row-parallel projections' f32 partials (wo, w_down;
                   an MoE layer's experts' w_down in one call,
                   all_reduce_sum_each) and the vocabulary-parallel
                   embedding's masked rows
  all_gather_last  the vocabulary-parallel head's logit slices, joined on
                   the last axis in rank order
  all_reduce_max   the per-row absmax of a row-parallel w8a8/w4a8
                   activation, so every rank quantizes its K slice with the
                   scale of the whole row (an MoE layer's experts in one
                   call, all_reduce_max_each)

Each is the identity when the group is None or of size 1, so a one-card
engine runs launch for launch as before.  Two more carry host decisions on
the mesh's host group (gloo): broadcast_object (rank 0's clock reading) and
all_gather_object (allocator stats, audit results).

No helper catches a collective's error: a rank that fails, or a deadlock
past the group's timeout, raises.  Every call is counted in `counts` by
name (chip_smoke.py tallies them per step as it tallies kernel launches).
gloo reduces CUDA tensors by staging them through the host; where the
group's backend is gloo and the tensor lies on the card, the helper makes
that copy itself (device -> host, the collective, host -> device), counts
it under "host_copies" and logs the first one.  The compute around it stays
on the card.
"""

from __future__ import annotations

import collections
import logging

import torch
import torch.distributed as dist

counts: collections.Counter[str] = collections.Counter()

_log = logging.getLogger(__name__)
_logged_host_copy = False


def size(group) -> int:
    """The number of ranks of `group` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def _staged(x: torch.Tensor, group) -> bool:
    """Whether `x` goes through the host for this group (gloo and CUDA)."""
    global _logged_host_copy
    if not x.is_cuda or dist.get_backend(group) != "gloo":
        return False
    counts["host_copies"] += 1
    if not _logged_host_copy:
        _logged_host_copy = True
        _log.warning("gloo group with CUDA tensors: collectives copy through the host")
    return True


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of `x` over the group's ranks (a new tensor)."""
    return x if size(group) == 1 else reduce_in_group(x, group, "sum")


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `x` over the group's ranks (a new tensor)."""
    return x if size(group) == 1 else reduce_in_group(x, group, "max")


def all_reduce_sum_each(xs: list[torch.Tensor], group) -> list[torch.Tensor]:
    """all_reduce_sum of every tensor of `xs` (one dtype, equal trailing
    shapes) in one collective: joined on the first axis, reduced, split."""
    return _each(xs, group, all_reduce_sum)


def all_reduce_max_each(xs: list[torch.Tensor], group) -> list[torch.Tensor]:
    """all_reduce_max of every tensor of `xs` in one collective."""
    return _each(xs, group, all_reduce_max)


def _each(xs: list[torch.Tensor], group, reduce) -> list[torch.Tensor]:
    if size(group) == 1:
        return list(xs)
    return list(reduce(torch.cat(xs), group).split([x.shape[0] for x in xs]))


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `x`, joined on the last axis in rank order."""
    return x if size(group) == 1 else gather_in_group(x, group)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reduce_in_group(x: torch.Tensor, group, op: str) -> torch.Tensor:
    """The all-reduce behind all_reduce_sum and all_reduce_max, run even on
    a group of one (a smoke run uses it so to launch NCCL on one card)."""
    counts[f"all_reduce_{op}"] += 1
    staged = _staged(x, group)
    y = x.detach().to("cpu", copy=True) if staged else x.detach().clone()
    dist.all_reduce(y, op=_OPS[op], group=group)
    return y.to(x.device) if staged else y


def gather_in_group(x: torch.Tensor, group) -> torch.Tensor:
    """The all-gather behind all_gather_last, run even on a group of one."""
    counts["all_gather_last"] += 1
    staged = _staged(x, group)
    src = (x.detach().to("cpu") if staged else x.detach()).contiguous()
    parts = [torch.empty_like(src) for _ in range(size(group))]
    dist.all_gather(parts, src, group=group)
    y = torch.cat(parts, dim=-1)
    return y.to(x.device) if staged else y


def broadcast_object(obj, group, *, src_rank: int = 0):
    """Rank `src_rank`'s `obj` on every rank of `group` (host objects)."""
    if size(group) == 1:
        return obj
    counts["broadcast_object"] += 1
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src_rank), group=group)
    return box[0]


def all_gather_object(obj, group) -> list:
    """Every rank's `obj`, in rank order (host objects)."""
    n = size(group)
    if n == 1:
        return [obj]
    counts["all_gather_object"] += 1
    out = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out
