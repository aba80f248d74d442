"""Train CLI with the legacy parser, the port's counterpart of the root
``train_ddp.py``: ``cli/train.py``'s run over every visible card, with
the defaults of the root ``parser.py`` (temporal scale [1, 2, 3]) and the
validation on the test split.

    python -m lrce_tpu_torch.cli.train_ddp --dataset tgif-frameqa \\
        --dataset-dir DIR
    torchrun --nproc-per-node N -m lrce_tpu_torch.cli.train_ddp ...
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from lrce_tpu_torch import config as C
from lrce_tpu_torch.cli import train as T
from lrce_tpu_torch.models.e2e import E2EConfig
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE

LEGACY_TEMPORAL_SCALE = [1, 2, 3]
SPLITS = ("train", "test")      # validation on the test split


def parse_arg_train(argv: Optional[Sequence[str]] = None,
                    config_dir: Optional[str] = None) -> argparse.Namespace:
    """``config.parse_arg_train`` with the legacy parser's one other
    default, the temporal scale [1, 2, 3]."""
    p = C._build_train_parser()
    p.set_defaults(temporal_scale=list(LEGACY_TEMPORAL_SCALE))
    return C.postprocess_train(p.parse_args(argv), config_dir)


def main(train_args: argparse.Namespace, *, device=DEFAULT_DEVICE,
         model_cfg: Optional[E2EConfig] = None,
         world_size: Optional[int] = None):
    """``cli.train.main`` validating on the test split."""
    return T.main(train_args, device=device, model_cfg=model_cfg,
                  world_size=world_size, splits=SPLITS)


if __name__ == "__main__":
    main(parse_arg_train())
