"""Entry points of the port, counterparts of ``__graft_entry__.py``:

  entry()                 the flagship forward (Swin-B + BERT-base + LRCE
                          fusion, open-ended head) on the card, bf16, and
                          its example arguments: 2 questions x 3 clips of
                          zeros, token ids and mask of ones, type ids of
                          zeros; ``fn(*example_args)`` gives (2, 1000)
                          logits;
  dryrun_multichip(n)     one train step and one eval step of the whole
                          model over n ranks (``parallel/dryrun.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from lrce_tpu_torch.models.e2e import E2EConfig, e2e_forward
from lrce_tpu_torch.parallel.dryrun import dryrun_multichip
from lrce_tpu_torch.tools import common
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["entry", "dryrun_multichip"]

BATCH = 2


def entry(device=DEFAULT_DEVICE, model_cfg: Optional[E2EConfig] = None):
    """(fn, example_args): ``fn(model, clips, ids, mask, types)`` is
    ``e2e_forward``; ``example_args[0]`` is the model (f32 parameters from
    seed 0, bf16 compute on the card)."""
    device = resolve_device(device)
    model = common.flagship(device, model_cfg).eval()
    cfg = model.cfg
    s = cfg.text_seq_len
    example_args = (
        model,
        torch.zeros((BATCH, sum(cfg.temporal_scale), cfg.frame_sample_size,
                     224, 224, 3), dtype=torch.float32, device=device),
        torch.ones((BATCH, s), dtype=torch.int64, device=device),
        torch.ones((BATCH, s), dtype=torch.int64, device=device),
        torch.zeros((BATCH, s), dtype=torch.int64, device=device),
    )
    return e2e_forward, example_args
