"""Parameter sharding rules and their application to an ``LRCEModel``.

Counterpart of ``lrce_tpu/parallel/sharding.py``, keyed on the port's
state-dict names (the reference's):

  - tensor parallelism over the "model" mesh axis
    (``tensor_parallel.tp_dim``): column-parallel are the fusion layers'
    ``self_attn`` / ``multihead_attn`` ``in_proj`` and ``linear1``, BERT's
    ``query`` / ``key`` / ``value`` and ``intermediate`` (weights and
    biases); row-parallel are ``out_proj``, ``linear2``, BERT's
    ``attention.output.dense`` and ``output.dense`` (weights; their biases
    are replicated). A leaf whose dimension does not divide by the axis
    stays whole, as in lrce_tpu;
  - FSDP (ZeRO-3) over the "fsdp" axis: every other text / fusion
    parameter, sharded along its last divisible dimension in lrce_tpu's
    layout ((in, out) for a dense weight, so the port's (out, in) weight
    shards its first dimension where that divides). lrce_tpu stacks the
    layers of BERT and the fusion on a leading axis and shards that axis
    when no other divides; the port's layers are separate tensors, so such
    a leaf stays whole here;
  - the Swin tower is replicated under both: every rank runs it, with every
    CUDA kernel, on its own clips, and its gradients are averaged over the
    batch ranks (data x fsdp).

``shard_model`` applies the rules: ``tensor_parallel.shard_tensor_parallel``
for the model axis; ``torch.distributed.fsdp.fully_shard`` per BERT layer,
per fusion decoder layer, then BERT and the fusion head as roots, over the
FSDP sub-mesh (data x fsdp, replicated over data); or
``DistributedDataParallel`` over the batch group (a one-rank group
included) when there is no fsdp axis. ``full_state_dict`` / ``load_full_state_dict`` and their optimizer
counterparts move whole tensors in and out of a sharded model (a
checkpoint holds the one-card state).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from lrce_tpu_torch.parallel.tensor_parallel import (
    shard_tensor_parallel, tp_dim, tp_gather, tp_slice)

EMBEDDINGS = ("word_embeddings.weight", "position_embeddings.weight",
              "token_type_embeddings.weight")
# the parameters the forward never reads: BERT's pooler, kept so that the
# state dict is a whole BertModel checkpoint
UNUSED = ("text_extractor.bert.pooler.dense.weight",
          "text_extractor.bert.pooler.dense.bias")


class Spec(NamedTuple):
    model: Optional[int]    # the dimension split over the model axis
    fsdp: Optional[int]     # the dimension sharded over the fsdp axis


def _jax_order(name: str, ndim: int):
    """The port's dimensions in lrce_tpu's order of the same leaf: a dense
    weight (or the packed in-projection) is (in, out) there."""
    if (ndim == 2 and name.endswith(".weight")
            and not name.endswith(EMBEDDINGS)) or name.endswith(
                "in_proj_weight"):
        return (1, 0)
    return tuple(range(ndim))


def param_spec(name: str, shape, fsdp: int = 1, model: int = 1) -> Spec:
    """Where one parameter of the port's model is split: lrce_tpu's
    ``e2e_param_shardings`` for the leaf of the same name."""
    if "video_extractor" in name:
        return Spec(None, None)
    m = tp_dim(name) if model > 1 else None
    if m is not None and shape[m] % model != 0:
        m = None
    f = None
    if fsdp > 1 and m is None:
        for d in reversed(_jax_order(name, len(shape))):
            if shape[d] >= fsdp and shape[d] % fsdp == 0:
                f = d
                break
    return Spec(m, f)


def param_specs(model: nn.Module, fsdp: int = 1, n_model: int = 1
                ) -> Dict[str, Spec]:
    """Every parameter's ``Spec``, by name, for a whole (unsharded) model."""
    return {name: param_spec(name, tuple(p.shape), fsdp, n_model)
            for name, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# Applying the rules
# ---------------------------------------------------------------------------

class Sharded(NamedTuple):
    """A model made ready for its layout: ``net`` is what the forward calls
    (the DDP wrapper, or the model itself), ``manual`` the parameters
    whose gradients ``sync_manual_grads`` averages over the batch ranks
    (those neither DDP nor FSDP reduces), and ``split`` the process groups
    over which each tensor-parallel piece lies, by the parameter's id
    (``utils/pytree.l2_reg``'s ``split``)."""
    net: nn.Module
    manual: list
    split: dict


def shard_model(model: nn.Module, layout, train: bool = True) -> Sharded:
    """Make ``model`` (an unsharded ``LRCEModel``, the same weights on every
    rank) ready for ``layout`` (``parallel/mesh.Layout``), in place. An
    evaluation (``train`` False) needs no DDP: nothing is reduced."""
    specs = param_specs(model, layout.n_fsdp, layout.n_model)
    split = {}
    if layout.n_model > 1:
        split = shard_tensor_parallel(model, layout.model_rank,
                                      layout.n_model, layout.tp_group)
    if layout.n_fsdp == 1:
        if layout.batch_group is None or not train:
            return Sharded(model, [], split)
        from torch.nn.parallel import DistributedDataParallel as DDP

        # the pooler gets no gradient from the loss (the forward does not
        # read it) and at most the l2 term's, which every rank computes
        # alike: DDP leaves it out, so no step waits for its gradient
        DDP._set_params_and_buffers_to_ignore_for_model(model, list(UNUSED))
        device = next(model.parameters()).device
        net = DDP(model, process_group=layout.batch_group,
                  device_ids=[device] if device.type == "cuda" else None)
        return Sharded(net, [], split)

    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    fsdp_dims = {}
    ignored = set()
    for name, p in model.named_parameters():
        if name.startswith(("text_extractor", "fusion_model")):
            if specs[name].fsdp is None:
                ignored.add(p)
            else:
                fsdp_dims[p] = specs[name].fsdp

    def placement(p):
        return Shard(fsdp_dims[p])

    units = (list(model.text_extractor.bert.encoder.layer)
             + list(model.fusion_model.fusion_transformer.transformer.layers)
             + [model.text_extractor.bert, model.fusion_model])
    for unit in units:
        own = {p for p in unit.parameters() if p in ignored}
        # the roots reshard after their forward too: an eval step leaves
        # every parameter stored as its shard
        fully_shard(unit, mesh=layout.fsdp_mesh, shard_placement_fn=placement,
                    reshard_after_forward=True, ignored_params=own or None)
    manual = [p for name, p in model.named_parameters()
              if name.startswith("video_extractor") or p in ignored]
    return Sharded(model, manual, split)


def sync_manual_grads(params, group, n: int) -> None:
    """Average the gradients of ``params`` over the batch ``group`` of ``n``
    ranks, one all-reduce per dtype (a missing gradient counts as zeros on
    this rank)."""
    if group is None or not params:
        return
    by_dtype = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= n
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


# ---------------------------------------------------------------------------
# Whole tensors in and out (checkpoints)
# ---------------------------------------------------------------------------

def _gather_shards(t) -> torch.Tensor:
    """A DTensor's whole value, gathered with the c10d all-gather over each
    sharded mesh dimension (pieces as ``torch.chunk`` cuts them, padded to
    one size for the exchange). DTensor's own ``full_tensor`` goes through
    the functional collectives, whose wait crashed over gloo with CUDA
    tensors (torch 2.11)."""
    out = t.to_local()
    for i, pl in reversed(list(enumerate(t.placements))):
        if not pl.is_shard():
            continue
        group = t.device_mesh.get_group(i)
        n = dist.get_world_size(group)
        length = t.shape[pl.dim]
        step = -(-length // n)
        sizes = [max(0, min(step, length - r * step)) for r in range(n)]
        pad = list(out.shape)
        pad[pl.dim] = step
        buf = out.new_zeros(pad)
        buf.narrow(pl.dim, 0, out.shape[pl.dim]).copy_(out)
        pieces = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(pieces, buf, group=group)
        out = torch.cat([p.narrow(pl.dim, 0, k)
                         for p, k in zip(pieces, sizes)], dim=pl.dim)
    return out


def _full(name: str, t: torch.Tensor, layout) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = _gather_shards(t)
    if layout is not None and layout.n_model > 1 and tp_dim(name) is not None \
            and getattr(t, "ndim", 0) > 0:
        t = tp_gather(name, t, layout.tp_group)
    return t


def _local(name: str, full: torch.Tensor, like: torch.Tensor, layout
           ) -> torch.Tensor:
    """This rank's part of ``full`` for a tensor shaped and placed as
    ``like`` (a parameter or its optimizer moment)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if layout is not None and layout.n_model > 1 and tp_dim(name) is not None:
        full = tp_slice(name, full, layout.model_rank, layout.n_model)
    full = full.to(like.device, like.dtype)
    if isinstance(like, DTensor):
        return distribute_tensor(full, like.device_mesh, like.placements,
                                 src_data_rank=None)
    return full


def full_state_dict(model: nn.Module, layout) -> Dict[str, torch.Tensor]:
    """The model's whole state dict on every rank (every rank must call it:
    it gathers the shards)."""
    return {name: _full(name, t, layout)
            for name, t in model.state_dict().items()}


def full_grads(model: nn.Module, layout) -> Dict[str, torch.Tensor]:
    """Every parameter's whole gradient (zeros where there is none) on
    every rank (every rank must call it)."""
    return {name: _full(name, p.grad if p.grad is not None
                        else torch.zeros_like(p), layout)
            for name, p in model.named_parameters()}


def load_full_state_dict(model: nn.Module, full: Dict[str, torch.Tensor],
                         layout) -> None:
    """Load a whole (one-card) state dict into a sharded model: each rank
    takes its part."""
    own = model.state_dict()
    missing = set(own) - set(full)
    unexpected = set(full) - set(own)
    if missing or unexpected:
        raise RuntimeError(f"state dict mismatch: missing {sorted(missing)}, "
                           f"unexpected {sorted(unexpected)}")
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(_local(name, full[name], t, layout))


def param_names(model: nn.Module, optimizer) -> list:
    """The name of each parameter in the optimizer's order."""
    by_id = {id(p): name for name, p in model.named_parameters()}
    return [by_id[id(p)] for g in optimizer.param_groups for p in g["params"]]


def full_optimizer_state(model: nn.Module, optimizer, layout) -> dict:
    """The optimizer's state dict with whole moments (every rank must call
    it), as the one-card optimizer holds them."""
    names = param_names(model, optimizer)
    sd = optimizer.state_dict()
    state = {i: {k: (_full(names[i], v, layout)
                     if torch.is_tensor(v) and v.ndim > 0 else v)
                 for k, v in s.items()}
             for i, s in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def load_full_optimizer_state(model: nn.Module, optimizer, full: dict,
                              layout) -> None:
    """Load a whole optimizer state dict into the optimizer of a sharded
    model: each rank takes its part of every moment."""
    names = param_names(model, optimizer)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for i, s in full["state"].items():
        i = int(i)
        state[i] = {k: (_local(names[i], v, params[i], layout)
                        if torch.is_tensor(v) and v.ndim > 0 else v)
                    for k, v in s.items()}
    optimizer.load_state_dict({"state": state,
                               "param_groups": full["param_groups"]})
