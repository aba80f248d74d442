"""CLI / config system, the port's copy of ``lrce_tpu/config.py``: the same
flags, defaults and post-processing, so the same argv gives the same
namespace.

argparse flags for training hyper-parameters are merged with a per-dataset
JSON model config (``lrce_tpu_torch/configs``), with the conditional key
pruning and the 1 -> 3 learning-rate broadcast. ``parse_arg_train`` /
``parse_arg_eval`` accept an optional argv for testability. The help texts
of ``--fsdp`` and ``--tensor-parallel`` are lrce_tpu's; their runtime is
``parallel/``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence

DATASET_CHOICES = [
    "msvd-qa-oe",
    "msrvtt-qa-oe",
    "tgif-frameqa",
    "tgif-count",
    "tgif-action",
    "tgif-transition",
]

_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")


def load_model_config(dataset: str, config_dir: Optional[str] = None) -> dict:
    """Load the per-dataset JSON model config (reference configs/*.json)."""
    config_dir = config_dir or _CONFIG_DIR
    with open(os.path.join(config_dir, f"{dataset}.json"), "r") as f:
        return json.load(f)


def _build_train_parser() -> argparse.ArgumentParser:
    # Flags, defaults, and choices mirror reference args.py:5-105.
    p = argparse.ArgumentParser(description="Train Model")
    p.add_argument("--dataset", help="Dataset to use", choices=DATASET_CHOICES,
                   type=str, required=True)
    p.add_argument("--dataset-dir", help="Directory path to dataset for train and validation",
                   required=True)
    p.add_argument("--log-dir", help="Log directory", default="./runs")
    p.add_argument("--ckpt-interval", help="How many epoch between checkpoints",
                   default=1, type=int)
    p.add_argument("--model-path", help="Load pretrained model")
    p.add_argument("--batch-size", help="Batch size for training", default=20, type=int)
    p.add_argument("--eval-per-epoch", help="Total validation per epoch", default=1, type=int)
    p.add_argument("--epoch", help="Total epoch", default=20, type=int)
    p.add_argument("--drop-out-rate", help="Drop out rate for training", default=0.5, type=float)
    p.add_argument("--lr", help="Learning rate for training", nargs="+",
                   default=[5e-6], type=float)
    p.add_argument("--min-lr", help="Minimum learning rate after decaying",
                   default=1e-8, type=float)
    p.add_argument("--temporal-scale", help="Scales for multisegment sampling",
                   nargs="+", default=[3], type=int)
    p.add_argument("--patience",
                   help="Number of stagnant epoch before decay (only for reduce on plateau scheduler)",
                   default=0.5, type=int)
    p.add_argument("--lr-decay-factor",
                   help="Learning rate decay factor (after full-cycle for cosine scheduler)",
                   default=0.5, type=float)
    p.add_argument("--lr-warm-up", help="Percentage of epoch to do linear warmup [0,1)",
                   default=0.1, type=float)
    p.add_argument("--lr-restart-epoch",
                   help="Number of epoch before restarting the learning rate (only for cosine annealing scheduler)",
                   default=2, type=int)
    p.add_argument("--lr-restart-mul",
                   help="Multiplier for lr-restart-epoch after restart (only for cosine annealing scheduler)",
                   default=1, type=int)
    p.add_argument("--use-cosine-scheduler",
                   help="Whether to use cosine annealing scheduler or reduce on plateau scheduler",
                   action="store_true")
    p.add_argument("--reg-strength", help="Weight for L2 regularization",
                   default=0.001, type=float)
    p.add_argument("--num-workers", help="Number of workers for dataloader",
                   default=2, type=int)
    p.add_argument("--cache-items",
                   help="LRU-cache up to N decoded clip tensors per dataset "
                        "(~4.5 MB each at 224x224x6 clips); repeat questions "
                        "on the same video then skip decode entirely "
                        "(an addition to the reference, which re-decodes every "
                        "sample every epoch)",
                   default=0, type=int)
    p.add_argument("--save-full-state",
                   help="Checkpoint the optimizer + scheduler state alongside "
                        "the model and restore them on --model-path resume "
                        "(an addition to the reference, which defined this path "
                        "but never saved more than the model, "
                        "agent_base.py:208-217)",
                   action="store_true")
    p.add_argument("--uint8-transfer",
                   help="Ship clips to the device as raw uint8 and normalize "
                        "on-device (4x less host->device bandwidth, "
                        "byte-exact numerics; an addition to the reference). "
                        "--no-uint8-transfer restores host-side float32",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--ckpt-steps",
                   help="Also checkpoint a rolling weights/latest.pt every N "
                        "optimizer steps (0 = off). For long epochs on "
                        "preemptible capacity: combined with the async "
                        "writer the loop pays ~one device copy per save, "
                        "and --model-path <...>/latest.pt resumes mid-epoch "
                        "state (an addition to the reference)",
                   default=0, type=int)
    p.add_argument("--async-checkpoint",
                   help="Write checkpoints from a background thread: the "
                        "train loop only pays a device-side param copy, and "
                        "the device->host fetch + serialization + disk write "
                        "overlap subsequent steps (an addition to the reference; the "
                        "reference's torch.save blocks the loop). "
                        "--no-async-checkpoint restores blocking saves",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--fsdp",
                   help="Shard parameters + optimizer state ZeRO-style over "
                        "an fsdp mesh axis of this size; the batch shards "
                        "over data x fsdp (an addition to the reference; the reference "
                        "replicates the model per GPU). Must divide the "
                        "device count",
                   default=1, type=int)
    p.add_argument("--tensor-parallel",
                   help="Megatron-style tensor parallelism over a model mesh "
                        "axis of this size for the text/fusion matrices "
                        "(an addition to the reference). Must divide the device count",
                   default=1, type=int)
    p.add_argument("--use-hinge-loss",
                   help="Use hinge loss instead of cross entropy (for mc task)",
                   action="store_true")
    p.add_argument("--margin", help="Margin for hingle loss (only for mc task)",
                   default=1, type=float)
    p.add_argument("--debug-mode", help="If on, it will not write logs and checkpoints",
                   action="store_true")
    p.add_argument("--sanity-check",
                   help="Sanity check by overfitting model with very small dataset",
                   action="store_true")
    p.add_argument("--comment", help="Additional comment if needed", default="", type=str)
    return p


def parse_arg_train(argv: Optional[Sequence[str]] = None,
                    config_dir: Optional[str] = None) -> argparse.Namespace:
    """Parse training args and merge the dataset JSON config.

    Reproduces the reference's post-processing exactly (args.py:94-115):
    conditional key deletion by scheduler/loss choice, JSON config merge,
    lr broadcast to 3 param groups, temporal-scale fallback.
    """
    return postprocess_train(_build_train_parser().parse_args(argv),
                             config_dir)


def postprocess_train(result: argparse.Namespace,
                      config_dir: Optional[str] = None) -> argparse.Namespace:
    """``parse_arg_train``'s post-processing of a parsed namespace."""
    if result.use_cosine_scheduler:
        del vars(result)["patience"]
    else:
        del vars(result)["lr_restart_epoch"]
        del vars(result)["lr_restart_mul"]
        del vars(result)["lr_warm_up"]

    if not result.use_hinge_loss:
        del vars(result)["margin"]

    if result.comment == "":
        del vars(result)["comment"]

    vars(result).update(load_model_config(result.dataset, config_dir))

    if len(result.lr) == 1:
        result.lr = result.lr * 3

    if len(result.temporal_scale) < 1:
        result.temporal_scale = [3]
    return result


def parse_arg_eval(argv: Optional[Sequence[str]] = None,
                   config_dir: Optional[str] = None) -> argparse.Namespace:
    """Parse evaluation args (reference args.py:118-155)."""
    p = argparse.ArgumentParser(description="Train Model")
    p.add_argument("--dataset", help="Dataset to use", choices=DATASET_CHOICES,
                   type=str, required=True)
    p.add_argument("--dataset-dir", help="Directory path to dataset for train and validation",
                   required=True)
    p.add_argument("--model-path", help="Load pretrained model", required=True)
    p.add_argument("--batch-size", help="Batch size for training", default=20, type=int)
    p.add_argument("--temporal-scale", help="Scales for multisegment sampling",
                   nargs="+", default=[3], type=int)
    p.add_argument("--num-workers", help="Number of workers for dataloader",
                   default=2, type=int)
    p.add_argument("--cache-items",
                   help="LRU-cache up to N decoded clip tensors per dataset "
                        "(~4.5 MB each at 224x224x6 clips)",
                   default=0, type=int)
    p.add_argument("--uint8-transfer",
                   help="Ship clips to the device as raw uint8 and normalize "
                        "on-device (byte-exact; --no-uint8-transfer restores "
                        "host-side float32)",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--use-hinge-loss",
                   help="Use hinge loss instead of cross entropy (for mc task)",
                   action="store_true")
    p.add_argument("--margin", help="Margin for hingle loss (only for mc task)",
                   default=1, type=float)
    p.add_argument("--reg-strength", help="Weight for L2 regularization",
                   default=0, type=float)

    result = p.parse_args(argv)
    vars(result).update(load_model_config(result.dataset, config_dir))

    if len(result.temporal_scale) < 1:
        result.temporal_scale = [3]
    return result


def num_clips(temporal_scale: List[int]) -> int:
    """Total 5-frame clips produced by multi-scale sampling = sum(scales)."""
    return sum(temporal_scale)
