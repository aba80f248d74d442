"""Megatron tensor parallelism for BERT and the fusion decoder, by hand.

Each rank of a tensor-parallel group keeps its own heads' rows of q, k and
v (and its rows of fc1), and the matching columns of the row-parallel
products after them (the attention output, fc2). Two autograd functions
carry the collectives:

  - ``copy_to_tp``: identity forward, all-reduce backward, on the input of
    a column-parallel product (each rank's heads add their part of the
    input's gradient);
  - ``utils/pytree.sum_over``: all-reduce forward, identity backward, on
    the f32 partial product of a row-parallel product, before its bias is
    added and the sum rounded once, as the one-card ``dense`` rounds.

``shard_tensor_parallel`` puts them on an unchanged model from outside: a
forward pre-hook copies the input of each module that starts a
column-parallel product, and ``RowParallelLinear`` takes the place of each
row-parallel ``Linear``. The layers below ``parallel/`` know nothing of it.

``torch.distributed.tensor.parallel.parallelize_module`` is not used: its
column / row styles take ``nn.Linear`` and ``nn.Embedding`` only, and the
port's layers are ``ops/nn.Linear`` and a packed (3D, D) ``in_proj_weight``.
The packed in-projection is split per head: rank r keeps the r-th slice of
each of q, k and v, not the r-th contiguous third of the packed rows (which
would give rank 0 all of q and part of k).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from lrce_tpu_torch.ops import nn as NN
from lrce_tpu_torch.utils.pytree import sum_over


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


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """x, whose gradient is summed over ``group`` (None: x itself)."""
    return x if group is None else _CopyToTP.apply(x, group)


class RowParallelLinear(NN.Linear):
    """A row-parallel ``Linear``: ``weight`` holds this rank's input
    columns; the f32 partial product is summed over ``group`` before the
    (replicated) bias is added and the sum rounded once, as ``NN.dense``
    rounds on one card. Takes the parameters of ``linear`` as they are, so
    the state-dict names stay."""

    def __init__(self, linear: NN.Linear, group):
        nn.Module.__init__(self)
        self.weight, self.bias = linear.weight, linear.bias
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = sum_over(NN.matmul_f32(x, self.weight), self.group)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


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

def _copy_inputs(group, count: int):
    """A forward pre-hook that hands the module ``copy_to_tp`` of its first
    ``count`` positional inputs, one copy per distinct input (a query, key
    and value that are one tensor share one backward all-reduce)."""
    def hook(module, args):
        copies = {}
        for t in args[:count]:
            if id(t) not in copies:
                copies[id(t)] = copy_to_tp(t, group)
        return tuple(copies[id(t)] for t in args[:count]) + args[count:]
    return hook


def _column_entries(model: nn.Module):
    """(name, module, inputs) of each module whose input starts a
    column-parallel product, with the count of its leading positional
    inputs that the product reads: query, key and value of every fusion
    attention, the hidden states of every BERT attention, and the input of
    the first feed-forward product of every BERT and fusion layer."""
    from lrce_tpu_torch.models import bert as B
    from lrce_tpu_torch.models import fusion as F

    for name, module in model.named_modules():
        if isinstance(module, NN.MultiheadAttention):
            yield name, module, 3
        elif isinstance(module, B.BertSelfAttention):
            yield name, module, 1
        elif isinstance(module, B.BertLayer):
            yield f"{name}.intermediate.dense", module.intermediate.dense, 1
        elif isinstance(module, F.DecoderLayer):
            yield f"{name}.linear1", module.linear1, 1


def shard_tensor_parallel(model: nn.Module, rank: int, n: int,
                          group) -> Dict[int, tuple]:
    """Split the BERT layers and the fusion decoder layers of ``model`` (an
    ``LRCEModel``) over the tensor-parallel ``group`` of ``n`` ranks, in
    place: rank ``rank`` keeps heads [rank H / n, (rank + 1) H / n) of every
    attention and the same share of every feed-forward hidden. Each module
    that starts a column-parallel product copies its input into the group
    (a forward pre-hook), and each row-parallel ``Linear`` becomes a
    ``RowParallelLinear``. Returns the process groups of each split
    parameter, by its id (``utils/pytree.l2_reg`` sums its square over
    them). Raises when the heads or the hidden do not divide by n."""
    entries = list(_column_entries(model))
    for name, module, _ in entries:
        if isinstance(module, NN.Linear):
            if module.weight.shape[0] % n:
                raise ValueError(f"{name}: a hidden of "
                                 f"{module.weight.shape[0]} does not split "
                                 f"over {n} tensor-parallel ranks")
        elif module.num_heads % n:
            raise ValueError(f"{name}: {module.num_heads} heads do not "
                             f"split over {n} tensor-parallel ranks")
    split = {}
    rows = []
    for name, module in list(model.named_modules()):
        if isinstance(module, NN.Linear) and tp_dim(f"{name}.weight") == 1:
            rows.append(name)
        for pname, p in list(module.named_parameters(recurse=False)):
            full = f"{name}.{pname}"
            if tp_dim(full) is None:
                continue
            local = nn.Parameter(tp_slice(full, p.detach(), rank, n),
                                 requires_grad=p.requires_grad)
            split[id(local)] = (group,)
            setattr(module, pname, local)
    for name in rows:
        parent, _, child = name.rpartition(".")
        owner = model.get_submodule(parent)
        setattr(owner, child, RowParallelLinear(getattr(owner, child), group))
    for _, module, inputs in entries:
        if not isinstance(module, NN.Linear):
            module.num_heads //= n
        module.register_forward_pre_hook(_copy_inputs(group, inputs))
    return split
