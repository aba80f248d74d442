"""The reference's training steps: the loss, its gradient and AdamW over
three parameter groups, in float32, for the batches a run fed the program.

The loss is the cross entropy of the open-ended logits, averaged over the
global batch (every rank's batch, of equal sizes), plus reg times the sum of
the un-squared L2 norms of the parameter leaves, where one leaf holds a
parameter of every repeated layer (BERT layers, fusion layers, the blocks of
a Swin stage). The forward and backward run a block of questions at a time
and add the gradients, so that the reference fits on the card beside
nothing else. Each rank's dropout and drop-path draws come from its own
generator, seeded as the program seeds its ranks, at that rank's batch.
"""

from __future__ import annotations

import contextlib
import re
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import lrce as R

# a leaf of the stacked layout: the layer index of these names is dropped
_STACKED = (re.compile(r"(encoder\.layer)\.\d+\."),
            re.compile(r"(transformer\.layers)\.\d+\."),
            re.compile(r"(blocks)\.\d+\."))
GROUPS = ("fusion_model", "text_extractor", "video_extractor")


def fold_seed(seed: int, rank: int) -> int:
    """The dropout generator's seed of a batch rank."""
    return (seed + rank * 0x9E3779B97F4A7C15) % 2**63


def leaves(names: Sequence[str]) -> List[List[str]]:
    groups: "OrderedDict[str, List[str]]" = OrderedDict()
    for name in names:
        key = name
        for pat in _STACKED:
            key = pat.sub(r"\1.*.", key)
        groups.setdefault(key, []).append(name)
    return list(groups.values())


class Steps(NamedTuple):
    losses: List[float]                 # each step's loss
    logits: List[torch.Tensor]          # each step's logits, (B, C) a rank
    grad_norms: Dict[str, float]        # step 1's gradient, by parameter
    change_norms: Dict[str, float]      # |p after the last step - p0|


@contextlib.contextmanager
def full_float32():
    """Float32 products without TF32 (the card's default for convolutions
    would round their operands to TF32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _to_device(batch, device):
    return tuple(torch.as_tensor(b).to(device) for b in batch)


@full_float32()
def train_steps(nm: R.Numerics, cfg: dict, P0: Dict[str, torch.Tensor],
                steps: Sequence[Sequence[tuple]], dropout_seed: int,
                block: int) -> Steps:
    """steps[i][r]: rank r's host batch (clips, ids, mask, types, labels) at
    step i. P0 is left as it is."""
    train = cfg["train"]
    lrs = dict(zip(GROUPS, train["lr"]))
    beta1, beta2 = train["betas"]
    eps, wd, reg = train["eps"], train["weight_decay"], train["reg_strength"]
    device = next(iter(P0.values())).device
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    m = {k: torch.zeros_like(v) for k, v in P0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P0.items()}
    groups = leaves(list(P))
    ranks = len(steps[0])
    gens = [torch.Generator(device=device).manual_seed(
        fold_seed(dropout_seed, r)) for r in range(ranks)]
    meta = {k: torch.empty_like(v, device="meta") for k, v in P0.items()}
    out = Steps([], [], {}, {})
    for t, rank_batches in enumerate(steps, start=1):
        for p in P.values():
            p.grad = None
        total = sum(len(b[4]) for b in rank_batches)
        ce_sum, logits_t = 0.0, []
        for r, batch in enumerate(rank_batches):
            clips, ids, mask, types, labels = _to_device(batch, device)
            drops = R.Drops()
            R.forward(nm, meta, cfg, clips.to("meta"), ids.to("meta"),
                      mask.to("meta"), types.to("meta"), drops)
            drops.fill(gens[r], device)
            rows = []
            for q0 in range(0, len(labels), block):
                q1 = min(q0 + block, len(labels))
                drops.select(q0, q1)
                lg = R.forward(nm, P, cfg, clips[q0:q1], ids[q0:q1],
                               mask[q0:q1], types[q0:q1], drops)
                ce = F.cross_entropy(lg, labels[q0:q1], reduction="sum")
                (ce / total).backward()
                ce_sum += float(ce.detach())
                rows.append(lg.detach())
            logits_t.append(torch.cat(rows))
        norms = torch.stack([torch.sqrt(sum(torch.sum(P[n] ** 2) for n in g))
                             for g in groups])
        (reg * norms.sum()).backward()
        out.losses.append(ce_sum / total + reg * float(norms.detach().sum()))
        out.logits.append(logits_t)
        with torch.no_grad():
            if t == 1:
                out.grad_norms.update({k: float(p.grad.norm())
                                       for k, p in P.items()})
            bc1, bc2 = 1 - beta1 ** t, 1 - beta2 ** t
            for k, p in P.items():
                lr = lrs[k.split(".", 1)[0]]
                g = p.grad
                p.mul_(1 - lr * wd)
                m[k].mul_(beta1).add_(g, alpha=1 - beta1)
                v2[k].mul_(beta2).addcmul_(g, g, value=1 - beta2)
                denom = (v2[k].sqrt() / bc2 ** 0.5).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / bc1)
    with torch.no_grad():
        out.change_norms.update({k: float((P[k] - P0[k]).norm())
                                 for k in P})
    return out


@torch.no_grad()
@full_float32()
def logits(nm: R.Numerics, cfg: dict, P: Dict[str, torch.Tensor],
           batches: Sequence[tuple], block: int) -> torch.Tensor:
    """Eval-mode logits of every question of ``batches``, ``block``
    questions at a time."""
    device = next(iter(P.values())).device
    rows = []
    for batch in batches:
        clips, ids, mask, types, _ = _to_device(batch, device)
        for q0 in range(0, len(ids), block):
            sl = slice(q0, q0 + block)
            rows.append(R.forward(nm, P, cfg, clips[sl], ids[sl], mask[sl],
                                  types[sl]))
    return torch.cat(rows)
