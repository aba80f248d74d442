"""Megatron tensor parallelism for BERT and the fusion decoder, by hand.

Each rank of a tensor-parallel group keeps its own heads' rows of q, k and
v (and its rows of fc1), and the matching columns of the row-parallel
products after them (the attention output, fc2). Two autograd functions
carry the collectives:

  - ``copy_to_tp``: identity forward, all-reduce backward, on the input of
    a column-parallel product (each rank's heads add their part of the
    input's gradient);
  - ``reduce_from_tp``: all-reduce forward, identity backward, on the f32
    partial product of a row-parallel product, before its bias is added and
    the sum rounded once, as the one-card ``dense`` rounds.

``torch.distributed.tensor.parallel.parallelize_module`` is not used: its
column / row styles take ``nn.Linear`` and ``nn.Embedding`` only, and the
port's layers are ``ops/nn.Linear`` and a packed (3D, D) ``in_proj_weight``.
The packed in-projection is split per head: rank r keeps the r-th slice of
each of q, k and v, not the r-th contiguous third of the packed rows (which
would give rank 0 all of q and part of k).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """x, whose gradient is summed over ``group`` (None: x itself)."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over ``group``, whose gradient passes through (None: x
    itself)."""
    return x if group is None else _ReduceFromTP.apply(x, group)


# ---------------------------------------------------------------------------
# Which parameters split, and how
# ---------------------------------------------------------------------------

# suffixes of the reference names (tests/oracle_utils'
# build_reference_named_state_dict) inside a BERT or fusion layer
COLUMN = ("self_attn.in_proj_weight", "self_attn.in_proj_bias",
          "multihead_attn.in_proj_weight", "multihead_attn.in_proj_bias",
          "linear1.weight", "linear1.bias",
          "attention.self.query.weight", "attention.self.query.bias",
          "attention.self.key.weight", "attention.self.key.bias",
          "attention.self.value.weight", "attention.self.value.bias",
          "intermediate.dense.weight", "intermediate.dense.bias")
ROW = ("self_attn.out_proj.weight", "multihead_attn.out_proj.weight",
       "linear2.weight", "attention.output.dense.weight",
       "output.dense.weight")
PACKED = ("in_proj_weight", "in_proj_bias")


def tp_dim(name: str) -> Optional[int]:
    """The dimension a parameter splits along over the model axis: 0 for a
    column-parallel weight or bias (its output rows), 1 for a row-parallel
    weight (its input columns), None for a replicated one."""
    if "video_extractor" in name:
        return None
    if name.endswith(COLUMN):
        return 0
    if name.endswith(ROW):
        return 1
    return None


def _pieces(name: str, t: torch.Tensor, n: int):
    """``t`` cut into n rank pieces along its model dimension; a packed
    in-projection is cut per head, each rank taking its slice of q, k and
    v."""
    dim = tp_dim(name)
    if name.endswith(PACKED):
        thirds = t.chunk(3, dim=0)
        per = [p.chunk(n, dim=0) for p in thirds]
        return [torch.cat([per[0][r], per[1][r], per[2][r]]) for r in range(n)]
    return list(t.chunk(n, dim=dim))


def tp_slice(name: str, full: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s piece of a full tensor (a parameter or an optimizer
    moment that mirrors one)."""
    return _pieces(name, full, n)[rank].contiguous()


def tp_join(name: str, pieces) -> torch.Tensor:
    """The full tensor from every rank's piece, in rank order."""
    if name.endswith(PACKED):
        thirds = [p.chunk(3, dim=0) for p in pieces]
        return torch.cat([torch.cat([t[k] for t in thirds])
                          for k in range(3)])
    return torch.cat(list(pieces), dim=tp_dim(name))


def tp_gather(name: str, local: torch.Tensor, group) -> torch.Tensor:
    """The full tensor of a split parameter, on every rank of ``group``."""
    n = dist.get_world_size(group)
    pieces = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(pieces, local.contiguous(), group=group)
    return tp_join(name, pieces)


# ---------------------------------------------------------------------------
# Turning a model tensor-parallel
# ---------------------------------------------------------------------------

def shard_tensor_parallel(model: nn.Module, rank: int, n: int, group) -> None:
    """Split the BERT layers and the fusion decoder layers of ``model`` (an
    ``LRCEModel``) over the tensor-parallel ``group`` of ``n`` ranks, in
    place: rank ``rank`` keeps heads [rank H / n, (rank + 1) H / n) of every
    attention and the same share of every feed-forward hidden. The modules
    that start a column-parallel product get ``tp_group`` (they copy their
    input into it), the row-parallel ``Linear``s ``reduce_group``, and each
    split parameter carries its group as ``tp_group`` (``utils/pytree.l2_reg``
    sums its square over it). Raises when the heads or the hidden do not
    divide by n."""
    from lrce_tpu_torch.models import bert as B
    from lrce_tpu_torch.models import fusion as F
    from lrce_tpu_torch.ops import nn as NN

    for name, module in list(model.named_modules()):
        if isinstance(module, (NN.MultiheadAttention, B.BertSelfAttention)):
            if module.num_heads % n:
                raise ValueError(f"{name}: {module.num_heads} heads do not "
                                 f"split over {n} tensor-parallel ranks")
            module.num_heads //= n
            module.tp_group = group
        if isinstance(module, (B.BertLayer, F.DecoderLayer)):
            ff = (module.intermediate.dense if isinstance(module, B.BertLayer)
                  else module.linear1).weight.shape[0]
            if ff % n:
                raise ValueError(f"{name}: a hidden of {ff} does not split "
                                 f"over {n} tensor-parallel ranks")
            module.tp_group = group
        if isinstance(module, NN.Linear) and tp_dim(f"{name}.weight") == 1:
            module.reduce_group = group
        for pname, p in list(module.named_parameters(recurse=False)):
            full = f"{name}.{pname}"
            if tp_dim(full) is None:
                continue
            local = nn.Parameter(tp_slice(full, p.detach(), rank, n),
                                 requires_grad=p.requires_grad)
            local.tp_group = group
            setattr(module, pname, local)
