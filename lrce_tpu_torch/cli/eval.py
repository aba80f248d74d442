"""Eval CLI, the port's counterpart of the root ``eval.py``: loads a
checkpoint (the port's, ``lrce_tpu``'s native pickle, or a reference
torch ``.pt``) and evaluates the test split over every visible card, one
rank per card, with the DistributedSampler's padding, as the reference's
multi-GPU evaluation counts.

    python -m lrce_tpu_torch.cli.eval --dataset tgif-frameqa \\
        --dataset-dir DIR --model-path RUN/weights/best.pt
    torchrun --nproc-per-node N -m lrce_tpu_torch.cli.eval ...

The dataset directory, the model and the ranks are as in ``cli/train.py``.
"""

from __future__ import annotations

import argparse
from typing import Optional

from lrce_tpu_torch.cli.train import (build_datasets, build_model,
                                      check_task_type, launch)
from lrce_tpu_torch.config import parse_arg_eval
from lrce_tpu_torch.data.loader import DataLoader
from lrce_tpu_torch.models.e2e import E2EConfig
from lrce_tpu_torch.parallel import mesh as PM
from lrce_tpu_torch.train.agent import agent_factory
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE
from lrce_tpu_torch.utils.logging import get_logger, setup_logging


def eval_rank(device, eval_args: argparse.Namespace,
              model_cfg: Optional[E2EConfig] = None,
              distributed: bool = True):
    """One rank's evaluation (the whole of it on one card when not
    ``distributed``) and its evaluator."""
    setup_logging()
    logger = get_logger(__name__, PM.global_rank())
    layout = PM.make_layout(1, 1, device.type) if distributed else None
    n_batch, rank = (layout.n_batch, layout.batch_rank) if layout else (1,
                                                                        None)

    logger.info("Preparing dataset")
    (test_dataset,) = build_datasets(eval_args, splits=("test",))

    logger.info("Instantiating model and evaluator agent")
    check_task_type(eval_args, logger)
    # the model's dropout is that of the config's default, as the reference
    # builds it (eval.py:66-74): inert, evaluation runs without dropout
    model = build_model(eval_args, device, model_cfg)
    agent_cls = agent_factory(eval_args.task_type)
    evaluator = agent_cls(model, eval_args, log_enabled=False, is_eval=True,
                          layout=layout)
    evaluator.load_checkpoint(eval_args.model_path)

    logger.info("Instantiating dataloader")
    test_dataloader = DataLoader(test_dataset, eval_args.batch_size,
                                 num_replicas=n_batch, shuffle=True,
                                 num_workers=eval_args.num_workers, rank=rank)

    evaluator.do_evaluation(test_dataloader)
    return evaluator


def main(eval_args: argparse.Namespace, *, device=DEFAULT_DEVICE,
         model_cfg: Optional[E2EConfig] = None,
         world_size: Optional[int] = None):
    """Evaluate ``--model-path`` on the test split and return the evaluator
    (its ``last_loss`` and ``last_metric_val``), or rank 0's summary of it
    when the ranks were spawned."""
    return launch(eval_rank, eval_args, device, world_size, (model_cfg,))


if __name__ == "__main__":
    main(parse_arg_eval())
