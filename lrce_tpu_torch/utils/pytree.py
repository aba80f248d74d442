"""Parameter helpers, counterpart of ``lrce_tpu/utils/pytree.py``: the L2
regularizer sum_p ||p||_2 (un-squared norms, not weight decay)."""

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


def _safe_norm(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm of the concatenated tensors, in f32, with a zero gradient at
    0 (a plain sqrt has a NaN gradient there)."""
    sq = sum(torch.sum(torch.square(t.float())) for t in ts)
    norm = torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq)))
    return torch.where(sq > 0, norm, torch.zeros_like(sq))


def l2_reg(groups: Iterable[Sequence[torch.Tensor]]) -> torch.Tensor:
    """Sum over groups of the un-squared L2 norm of each group, as
    ``lrce_tpu.utils.pytree.l2_reg`` sums over its leaves
    (``stacked_param_groups`` gives the same leaves for a model)."""
    return sum(_safe_norm(g) for g in groups)
