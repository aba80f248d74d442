"""Eval CLI, the port's counterpart of the root ``eval.py``: loads a
checkpoint (the port's, ``lrce_tpu``'s native pickle, or a reference
torch ``.pt``) and evaluates the test split on one card.

    python -m lrce_tpu_torch.cli.eval --dataset tgif-frameqa \\
        --dataset-dir DIR --model-path RUN/weights/best.pt

The dataset directory and the model are as in ``cli/train.py``.
"""

from __future__ import annotations

import argparse
from typing import Optional

from lrce_tpu_torch.cli.train import build_datasets, build_model, check_task_type
from lrce_tpu_torch.config import parse_arg_eval
from lrce_tpu_torch.data.loader import DataLoader
from lrce_tpu_torch.models.e2e import E2EConfig
from lrce_tpu_torch.train.agent import agent_factory
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from lrce_tpu_torch.utils.logging import get_logger, setup_logging


def main(eval_args: argparse.Namespace, *, device=DEFAULT_DEVICE,
         model_cfg: Optional[E2EConfig] = None):
    """Evaluate ``--model-path`` on the test split and return the evaluator
    (its ``last_loss`` and ``last_metric_val``)."""
    device = resolve_device(device)
    setup_logging()
    logger = get_logger(__name__)

    logger.info("Preparing dataset")
    (test_dataset,) = build_datasets(eval_args, splits=("test",))

    logger.info("Instantiating model and evaluator agent")
    check_task_type(eval_args, logger)
    # the model's dropout is that of the config's default, as the reference
    # builds it (eval.py:66-74): inert, evaluation runs without dropout
    model = build_model(eval_args, device, model_cfg)
    agent_cls = agent_factory(eval_args.task_type)
    evaluator = agent_cls(model, eval_args, log_enabled=False, is_eval=True)
    evaluator.load_checkpoint(eval_args.model_path)

    logger.info("Instantiating dataloader")
    test_dataloader = DataLoader(test_dataset, eval_args.batch_size,
                                 num_replicas=1, shuffle=True,
                                 num_workers=eval_args.num_workers)

    evaluator.do_evaluation(test_dataloader)
    return evaluator


if __name__ == "__main__":
    main(parse_arg_eval())
