"""Three-group AdamW, counterpart of ``lrce_tpu/train/optimizer.py``.

``torch.optim.AdamW`` with betas (0.9, 0.999), eps 1e-8 and decoupled
weight decay 0.01, over three parameter groups in this index order:
fusion_model, text_extractor, video_extractor, each with its own learning
rate. Its step, p <- p (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps), is
``apply_updates``'s p <- p - lr (adam(g) + wd p). The step is elementwise,
so across ranks the same groups hold FSDP's sharded (DTensor) parameters
and tensor parallelism's local pieces beside whole ones, and each element
takes the one-card update (``tests/test_torch_parallel.py``); the
optimizer is made after ``parallel/sharding.shard_model``, over the
parameters it left.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

GROUPS = ("fusion_model", "text_extractor", "video_extractor")
WEIGHT_DECAY = 0.01
BETAS = (0.9, 0.999)
EPS = 1e-8


def param_groups(model: nn.Module, lrs: Sequence[float]):
    """The three groups of ``model``'s top-level submodules, in GROUPS
    order."""
    return [{"params": list(getattr(model, name).parameters()), "lr": lr,
             "name": name} for name, lr in zip(GROUPS, lrs)]


def make_optimizer(model: nn.Module, lrs: Sequence[float]
                   ) -> torch.optim.AdamW:
    return torch.optim.AdamW(param_groups(model, lrs), betas=BETAS, eps=EPS,
                             weight_decay=WEIGHT_DECAY)


def set_lrs(optimizer: torch.optim.Optimizer, lrs: Sequence[float]) -> None:
    """Per-step learning rates, one per group (the scheduler's output)."""
    for group, lr in zip(optimizer.param_groups, lrs):
        group["lr"] = float(lr)
