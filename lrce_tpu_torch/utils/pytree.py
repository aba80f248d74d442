"""Parameter helpers, counterpart of ``lrce_tpu/utils/pytree.py``: the L2
regularizer sum_p ||p||_2 (un-squared norms, not weight decay), over whole
parameters or over their rank pieces (FSDP's DTensors, and the pieces a
layout names, ``parallel/sharding.Sharded.split``), where each piece's sum
of squares is summed over the process groups that split it before the root
is taken, as lrce_tpu's GSPMD does."""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Iterable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

# lrce_tpu stacks repeated layers on a leading axis, so one of its leaves
# holds a parameter of every BERT layer, fusion layer or Swin block of a
# stage; these patterns name the layer index that the stacking removes
_STACKED = (re.compile(r"(encoder\.layer)\.\d+\."),
            re.compile(r"(transformer\.layers)\.\d+\."),
            re.compile(r"(blocks)\.\d+\."))


def stacked_param_groups(model: nn.Module) -> List[List[torch.Tensor]]:
    """The model's parameters grouped as lrce_tpu's param leaves: the same
    parameter of every stacked layer in one group, every other parameter
    alone."""
    groups: "OrderedDict[str, List[torch.Tensor]]" = OrderedDict()
    for name, p in model.named_parameters():
        for pat in _STACKED:
            name = pat.sub(r"\1.*.", name)
        groups.setdefault(name, []).append(p)
    return list(groups.values())


def _safe_sqrt(sq: torch.Tensor) -> torch.Tensor:
    """sqrt in f32 with a zero gradient at 0 (a plain sqrt has a NaN
    gradient there)."""
    norm = torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq)))
    return torch.where(sq > 0, norm, torch.zeros_like(sq))


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks of the process ``group`` (all-reduce),
    whose gradient passes through: each rank's piece keeps the gradient of
    its own part (None: x itself)."""
    return x if group is None else _SumOver.apply(x, group)


def _split_over(t: torch.Tensor, split: Mapping[int, tuple]) -> tuple:
    """The process groups whose ranks each hold a piece of ``t``: an FSDP
    DTensor's sharded mesh dimensions, else ``split``'s entry for it."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return tuple(t.device_mesh.get_group(i)
                     for i, pl in enumerate(t.placements) if pl.is_shard())
    return split.get(id(t), ())


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def l2_reg(groups: Iterable[Sequence[torch.Tensor]],
           split: Optional[Mapping[int, tuple]] = None) -> torch.Tensor:
    """Sum over groups of the un-squared L2 norm of each group, as
    ``lrce_tpu.utils.pytree.l2_reg`` sums over its leaves
    (``stacked_param_groups`` gives the same leaves for a model). split:
    the process groups over which a parameter's rank pieces lie, by the
    parameter's id (``parallel/sharding.Sharded.split``; FSDP's DTensors
    name their own). The squares of split groups are summed over their
    process groups, one all-reduce per process group (``sum_over``: the
    gradient of each piece stays its own)."""
    split = split or {}
    sqs, by_over = [], {}
    for i, g in enumerate(groups):
        sqs.append(sum(torch.sum(torch.square(_local(t).float())) for t in g))
        over = _split_over(g[0], split)
        if over:
            by_over.setdefault(tuple(map(id, over)), (over, []))[1].append(i)
    for over, idx in by_over.values():
        total = torch.stack([sqs[i] for i in idx])
        for group in over:
            total = sum_over(total, group)
        for j, i in enumerate(idx):
            sqs[i] = total[j]
    return sum(_safe_sqrt(sq) for sq in sqs)
