"""Pretrained-weight loading, counterpart of ``lrce_tpu/pretrained.py``.

The Kinetics-600 Video-Swin-B checkpoint and bert-base-uncased are read
from local files under ./pretrained_models when present, and otherwise the
towers keep their random init with a warning: training, eval and checkpoint
ingest work either way.
"""

from __future__ import annotations

import os
from typing import Optional

from lrce_tpu_torch.models.e2e import LRCEModel
from lrce_tpu_torch.utils import convert as cv
from lrce_tpu_torch.utils.logging import get_logger

SWIN_CKPT_PATHS = [
    "./pretrained_models/swin_base_patch244_window877_kinetics600_22k.pth",
]
BERT_CKPT_PATHS = [
    "./pretrained_models/bert-base-uncased.pt",
    "./pretrained_models/bert-base-uncased.bin",
    "./pretrained_models/pytorch_model.bin",
]


def _first_existing(paths) -> Optional[str]:
    for p in paths:
        if os.path.exists(p):
            return p
    return None


def _overlay(module, sd: dict, what: str) -> None:
    """Load ``sd`` into ``module``; every parameter of the module must be in
    it (extra entries, such as a classification head, are ignored)."""
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{what}: the file lacks {len(missing)} tensors, "
                       f"first {missing[:3]}")
    module.load_state_dict({k: sd[k] for k in own})


def load_pretrained(model: LRCEModel, swin_path: Optional[str] = None,
                    bert_path: Optional[str] = None) -> LRCEModel:
    """Overlay pretrained Swin / BERT torch weights onto ``model`` (in
    place, on the model's own device) and return it."""
    logger = get_logger(__name__)
    swin_path = swin_path or _first_existing(SWIN_CKPT_PATHS)
    bert_path = bert_path or _first_existing(BERT_CKPT_PATHS)

    if swin_path:
        sd = cv.load_torch_state_dict(swin_path)
        if any(k.startswith("backbone.") for k in sd):
            sd = cv.strip_prefix(sd, "backbone.")
        swin = model.video_extractor.swin
        if sd["patch_embed.proj.weight"].ndim == 4:
            sd = cv.inflate_swin2d(sd, swin.cfg.window_size,
                                   swin.cfg.patch_size[0])
        _overlay(swin, sd, swin_path)
        logger.info(f"Loaded Swin weights from {swin_path}")
    else:
        logger.warning(
            "Swin Kinetics-600 checkpoint not found under ./pretrained_models "
            "- video encoder stays randomly initialized")

    if bert_path:
        sd = cv.load_torch_state_dict(bert_path)
        if "embeddings.word_embeddings.weight" not in sd:
            sd = cv.strip_prefix(sd, "bert.")
        _overlay(model.text_extractor.bert, sd, bert_path)
        logger.info(f"Loaded BERT weights from {bert_path}")
    else:
        logger.warning(
            "bert-base-uncased weights not found under ./pretrained_models "
            "- text encoder stays randomly initialized")
    return model
