"""Task losses, counterpart of ``lrce_tpu/train/losses.py``.

  - cross_entropy: CrossEntropyLoss(ignore_index=-100) semantics, the mean
    over non-ignored samples (NaN when every label is ignored);
  - hinge_loss: mean_i sum_{j != gt_i} max(out_ij - out_i,gt + margin, 0);
  - mse: per-sample squared errors (B,); callers mean it for the loss and
    sum it for the metric.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lrce_tpu_torch.constants import IGNORE_INDEX


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, C) x (B,) -> scalar, computed in f32."""
    return F.cross_entropy(logits.float(), labels.long(),
                           ignore_index=IGNORE_INDEX)


def hinge_loss(out: torch.Tensor, gt: torch.Tensor,
               margin: float = 1.0) -> torch.Tensor:
    """(B, M) scores x (B,) correct index -> scalar."""
    gt = gt.long()
    correct = out.gather(1, gt[:, None])
    viol = torch.clamp(out - correct + margin, min=0.0)
    not_gt = torch.arange(out.shape[1], device=out.device)[None] != gt[:, None]
    return (viol * not_gt).sum(1).mean()


def mse(out: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-sample squared error (B,) in f32."""
    return torch.square(out.float() - gt.float())
