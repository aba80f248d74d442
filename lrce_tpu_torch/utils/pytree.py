"""Parameter helpers, counterpart of ``lrce_tpu/utils/pytree.py``: the L2
regularizer sum_p ||p||_2 (un-squared norms, not weight decay), over whole
parameters or over their shards (FSDP's DTensors, tensor parallelism's
local pieces), where each shard's sum of squares is summed over the group
that splits it before the root is taken, as lrce_tpu's GSPMD does."""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Iterable, List, Sequence

import torch
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


def _split_over(t: torch.Tensor) -> tuple:
    """The process groups whose ranks each hold a piece of ``t``: an FSDP
    DTensor's sharded mesh dimensions, a tensor-parallel piece's group."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return tuple(t.device_mesh.get_group(i)
                     for i, pl in enumerate(t.placements) if pl.is_shard())
    group = getattr(t, "tp_group", None)
    return () if group is None else (group,)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def l2_reg(groups: Iterable[Sequence[torch.Tensor]]) -> torch.Tensor:
    """Sum over groups of the un-squared L2 norm of each group, as
    ``lrce_tpu.utils.pytree.l2_reg`` sums over its leaves
    (``stacked_param_groups`` gives the same leaves for a model). The
    squares of split groups are summed over their process groups, one
    all-reduce per process group (``tensor_parallel.reduce_from_tp``: the
    gradient of each piece stays its own)."""
    from lrce_tpu_torch.parallel.tensor_parallel import reduce_from_tp

    sqs, split = [], {}
    for i, g in enumerate(groups):
        sqs.append(sum(torch.sum(torch.square(_local(t).float())) for t in g))
        over = _split_over(g[0])
        if over:
            split.setdefault(tuple(map(id, over)), (over, []))[1].append(i)
    for over, idx in split.values():
        total = torch.stack([sqs[i] for i in idx])
        for group in over:
            total = reduce_from_tp(total, group)
        for j, i in enumerate(idx):
            sqs[i] = total[j]
    return sum(_safe_sqrt(sq) for sq in sqs)
