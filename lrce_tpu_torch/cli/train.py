"""Train CLI, the port's counterpart of the root ``train.py``: the same
flags (``lrce_tpu_torch.config.parse_arg_train``), the same dataset
directory layout and the same flow, over every visible card.

    python -m lrce_tpu_torch.cli.train --dataset tgif-frameqa \\
        --dataset-dir DIR [--batch-size 8 --epoch 1 --log-dir ./runs ...]
    torchrun --nproc-per-node N -m lrce_tpu_torch.cli.train ...

One process per card, as the reference's DDP trainer runs and as
lrce_tpu's mesh spans every local chip: started with ``python -m`` the CLI
spawns a rank per visible card (``parallel/mesh.spawn``; one card: no
process group at all), started by ``torchrun`` it is one rank of the
environment's group. The global batch is ``--batch-size`` x the number of
batch ranks (data x fsdp); ``--fsdp`` and ``--tensor-parallel`` shard the
text and fusion parameters (``parallel/sharding.py``) and must divide the
number of ranks. An exception in any rank ends the run with an error.

Dataset directory (``build_datasets``, the reference's layout):
  - TGIF: ``annotations/{Train,Test,Total}_<type>_question.csv``
    (tab-separated) and ``gifs/<gif_name>.gif``; "val" reads ``Test``;
  - MSVD-QA / MSRVTT-QA: ``idx-video-mapping.pkl``,
    ``{train,val,test}_qa.json`` and ``video/<name>.avi``.
The tokenizer's ``vocab.txt`` is the file named by LRCE_TPU_BERT_VOCAB or
one under ``./pretrained_models``; pretrained Swin / BERT weights are read
from ``./pretrained_models`` when present (``pretrained.py``).

The model is built on the card (bf16 compute, f32 parameters) unless the
caller asks for the CPU (f32 compute, gloo between ranks, ``world_size``
ranks), and there is an error where there is no card.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
from types import SimpleNamespace
from typing import Callable, Optional, Sequence

import torch

from lrce_tpu_torch.config import parse_arg_train
from lrce_tpu_torch.data.datasets import E2EMicrosoftDataset, E2ETGIFDataset
from lrce_tpu_torch.data.loader import DataLoader
from lrce_tpu_torch.models.e2e import E2EConfig, LRCEModel, config_from_args
from lrce_tpu_torch.parallel import mesh as PM
from lrce_tpu_torch.pretrained import load_pretrained
from lrce_tpu_torch.train.agent import agent_factory
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from lrce_tpu_torch.utils.logging import get_logger, setup_logging

TASK_TYPES = ("oe", "mc", "count")


def build_datasets(train_args, splits=("train", "val")):
    """One dataset per split, from the dataset directory's layout; frames at
    the model config's ``frame_size`` (224, or 384 for Swin-L)."""
    size = getattr(train_args, "frame_size", 224)
    common = dict(
        frame_size=(size, size),
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


def summary(agent) -> SimpleNamespace:
    """What a spawned run returns of its rank 0's agent (an agent does not
    cross processes): the last losses and metrics, the step counter, the
    best epoch, the learning rates and the run's directories."""
    keys = ("last_loss", "last_metric_val", "last_train_loss",
            "last_train_metric", "counter", "best_epoch", "best_metric_val",
            "lrs")
    out = {k: getattr(agent, k) for k in keys}
    out["log_dir"] = getattr(agent.args, "log_dir", None)
    out["ckpt_dir"] = getattr(agent.args, "ckpt_dir", None)
    return SimpleNamespace(**out)


def prepare_ranks(device: torch.device) -> None:
    """Build the CUDA kernels and the native library once, before the ranks
    start: ranks starting together would each run the compilers."""
    from lrce_tpu_torch import native

    native.built(native.CORE)
    if device.type == "cuda":
        from lrce_tpu_torch.ops import cuda_lib

        cuda_lib.build()


def launch(rank_fn: Callable, args: argparse.Namespace, device,
           world_size: Optional[int], extra: Sequence = ()):
    """Run ``rank_fn(device, args, *extra)`` as the command lines do: as
    one rank of torchrun's group when its environment is set; else on one
    process without a process group when one card (or the CPU) is all
    there is and ``world_size`` is not given; else on ``world_size`` ranks
    (default: every visible card), in this process when that is one and
    spawned when more. Returns what rank 0 returns (a summary when
    spawned)."""
    device = resolve_device(device)
    torchrun = PM.torchrun_env()
    if not torchrun:
        if world_size is None:
            world_size = (torch.cuda.device_count() if device.type == "cuda"
                          else 1)
            if world_size == 1:
                return rank_fn(device, args, *extra, distributed=False)
        if world_size > 1:
            prepare_ranks(device)
            threads = (max(1, torch.get_num_threads() // world_size)
                       if device.type == "cpu" else 0)
            return PM.spawn(_spawned, world_size, (rank_fn, args, extra),
                            device=device.type, threads=threads)
    with tempfile.TemporaryDirectory(prefix="lrce_rank_") as tmp:
        one = {} if torchrun else dict(
            rank=0, world_size=1,
            init_method="file://" + os.path.join(tmp, "rendezvous"))
        dev = PM.init_distributed(device, **one)
        try:
            return rank_fn(dev, args, *extra)
        finally:
            PM.dist.destroy_process_group()


def _spawned(device, rank_fn, args, extra):
    return summary(rank_fn(device, args, *extra))


def train_rank(device: torch.device, train_args: argparse.Namespace,
               splits=("train", "val"), model_cfg: Optional[E2EConfig] = None,
               distributed: bool = True):
    """One rank's training (the whole run on one card when not
    ``distributed``) and its agent."""
    setup_logging()
    logger = get_logger(__name__, PM.global_rank())
    axes = (getattr(train_args, "fsdp", 1),
            getattr(train_args, "tensor_parallel", 1))
    if distributed:
        layout = PM.make_layout(*axes, device.type)
    else:
        PM.train_mesh_shape(1, *axes)   # the flags' error on one card
        layout = None
    n_batch, rank = (layout.n_batch, layout.batch_rank) if layout else (1,
                                                                        None)
    if layout is not None:
        logger.info(f"{layout.world} rank(s), mesh "
                    f"{dict(zip(PM.AXES, layout.mesh.shape))}, {n_batch} "
                    f"batch shard(s): a global batch of "
                    f"{train_args.batch_size * n_batch}")

    logger.info("Preparing dataset")
    train_dataset, val_dataset = build_datasets(train_args, splits)

    logger.info("Instantiating model and trainer agent")
    check_task_type(train_args, logger)
    model = load_pretrained(build_model(train_args, device, model_cfg))
    agent_cls = agent_factory(train_args.task_type)
    trainer = agent_cls(
        model, train_args,
        log_enabled=not train_args.debug_mode and not train_args.sanity_check,
        layout=layout)

    if train_args.model_path:
        trainer.load_checkpoint(train_args.model_path)

    logger.info("Instantiating dataloader")
    train_dataloader = DataLoader(train_dataset, train_args.batch_size,
                                  num_replicas=n_batch, shuffle=True,
                                  num_workers=train_args.num_workers,
                                  rank=rank)
    val_dataloader = DataLoader(val_dataset, train_args.batch_size,
                                num_replicas=n_batch, shuffle=True,
                                num_workers=train_args.num_workers, rank=rank)

    if train_args.sanity_check:
        logger.info("Performing sanity check, you should see a very small "
                    "error or very good metric evaluation on the end result")
        trainer.do_sanity_check(train_dataloader)
    else:
        trainer.do_training(train_dataloader, val_dataloader,
                            train_args.eval_per_epoch)
    return trainer


def main(train_args: argparse.Namespace, *, device=DEFAULT_DEVICE,
         model_cfg: Optional[E2EConfig] = None,
         world_size: Optional[int] = None, splits=("train", "val")):
    """Train (or, with ``--sanity-check``, overfit the first items) and
    return the trainer, or rank 0's ``summary`` of it when the ranks were
    spawned. ``model_cfg`` replaces the dataset's model configuration (a
    small model for tests); ``world_size`` the number of ranks (default:
    every visible card)."""
    return launch(train_rank, train_args, device, world_size,
                  (splits, model_cfg))


if __name__ == "__main__":
    main(parse_arg_train())
