"""Train CLI, the port's counterpart of the root ``train.py``: the same
flags (``lrce_tpu_torch.config.parse_arg_train``), the same dataset
directory layout and the same flow, on one card.

    python -m lrce_tpu_torch.cli.train --dataset tgif-frameqa \\
        --dataset-dir DIR [--batch-size 8 --epoch 1 --log-dir ./runs ...]

Dataset directory (``build_datasets``, the reference's layout):
  - TGIF: ``annotations/{Train,Test,Total}_<type>_question.csv``
    (tab-separated) and ``gifs/<gif_name>.gif``; "val" reads ``Test``;
  - MSVD-QA / MSRVTT-QA: ``idx-video-mapping.pkl``,
    ``{train,val,test}_qa.json`` and ``video/<name>.avi``.
The tokenizer's ``vocab.txt`` is the file named by LRCE_TPU_BERT_VOCAB or
one under ``./pretrained_models``; pretrained Swin / BERT weights are read
from ``./pretrained_models`` when present (``pretrained.py``).

The model is built on the card (bf16 compute, f32 parameters) unless the
caller asks for the CPU (f32 compute), and there is an error where there
is no card. ``--fsdp`` and ``--tensor-parallel`` above 1 raise: their
runtime is not ported yet.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
from typing import Optional

import torch

from lrce_tpu_torch.config import parse_arg_train
from lrce_tpu_torch.data.datasets import E2EMicrosoftDataset, E2ETGIFDataset
from lrce_tpu_torch.data.loader import DataLoader
from lrce_tpu_torch.models.e2e import E2EConfig, LRCEModel, config_from_args
from lrce_tpu_torch.pretrained import load_pretrained
from lrce_tpu_torch.train.agent import agent_factory
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from lrce_tpu_torch.utils.logging import get_logger, setup_logging

TASK_TYPES = ("oe", "mc", "count")


def build_datasets(train_args, splits=("train", "val")):
    """One dataset per split, from the dataset directory's layout."""
    common = dict(
        max_text_token_len=train_args.text_seq_len,
        sanity_check=getattr(train_args, "sanity_check", False),
        frames_per_clip=train_args.frame_sample_size,
        temporal_scale=train_args.temporal_scale,
        cache_items=getattr(train_args, "cache_items", 0),
        uint8_clips=getattr(train_args, "uint8_transfer", True),
    )
    datasets = []
    if "tgif" in train_args.dataset:
        tgif_type = train_args.dataset.split("-")[-1]
        split_files = {"train": "Train", "val": "Test", "test": "Test"}
        ann = os.path.join(train_args.dataset_dir, "annotations")
        for split in splits:
            datasets.append(E2ETGIFDataset(
                split_annotation=os.path.join(
                    ann, f"{split_files[split]}_{tgif_type}_question.csv"),
                full_annotation=os.path.join(
                    ann, f"Total_{tgif_type}_question.csv"),
                videos_path=os.path.join(train_args.dataset_dir, "gifs"),
                task_type=train_args.task_type, **common))
    else:
        # the reference's own mapping file (question video id -> file name)
        with open(os.path.join(train_args.dataset_dir,
                               "idx-video-mapping.pkl"), "rb") as f:
            video_dict = pickle.load(f)
        root = train_args.dataset_dir
        for split in splits:
            datasets.append(E2EMicrosoftDataset(
                train_annotation=os.path.join(root, "train_qa.json"),
                val_annotation=os.path.join(root, "val_qa.json"),
                test_annotation=os.path.join(root, "test_qa.json"),
                videos_path=os.path.join(root, "video"),
                video_dict=video_dict, split=split, **common))
    return datasets


def build_model(args, device: torch.device,
                model_cfg: Optional[E2EConfig] = None) -> LRCEModel:
    """The model for ``args`` (or ``model_cfg``) on ``device``: f32
    parameters, bf16 compute on the card and f32 on the CPU."""
    compute = torch.bfloat16 if device.type == "cuda" else torch.float32
    return LRCEModel(model_cfg or config_from_args(args), device=device,
                     dtype=torch.float32, compute_dtype=compute)


def check_task_type(args, logger) -> None:
    if args.task_type not in TASK_TYPES:
        logger.error("Unsupported task type")
        sys.exit(-1)


def main(train_args: argparse.Namespace, *, device=DEFAULT_DEVICE,
         model_cfg: Optional[E2EConfig] = None):
    """Train (or, with ``--sanity-check``, overfit the first items) and
    return the trainer. ``model_cfg`` replaces the dataset's model
    configuration (a small model for tests)."""
    device = resolve_device(device)
    for flag in ("fsdp", "tensor_parallel"):
        if getattr(train_args, flag, 1) > 1:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} {getattr(train_args, flag)}: "
                "the port trains on one card; sharding is not ported yet")
    setup_logging()
    logger = get_logger(__name__)

    logger.info("Preparing dataset")
    train_dataset, val_dataset = build_datasets(train_args)

    logger.info("Instantiating model and trainer agent")
    check_task_type(train_args, logger)
    model = load_pretrained(build_model(train_args, device, model_cfg))
    agent_cls = agent_factory(train_args.task_type)
    trainer = agent_cls(
        model, train_args,
        log_enabled=not train_args.debug_mode and not train_args.sanity_check)

    if train_args.model_path:
        trainer.load_checkpoint(train_args.model_path)

    logger.info("Instantiating dataloader")
    train_dataloader = DataLoader(train_dataset, train_args.batch_size,
                                  num_replicas=1, shuffle=True,
                                  num_workers=train_args.num_workers)
    val_dataloader = DataLoader(val_dataset, train_args.batch_size,
                                num_replicas=1, shuffle=True,
                                num_workers=train_args.num_workers)

    if train_args.sanity_check:
        logger.info("Performing sanity check, you should see a very small "
                    "error or very good metric evaluation on the end result")
        trainer.do_sanity_check(train_dataloader)
    else:
        trainer.do_training(train_dataloader, val_dataloader,
                            train_args.eval_per_epoch)
    return trainer


if __name__ == "__main__":
    main(parse_arg_train())
