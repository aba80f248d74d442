"""One-command accuracy check of a trained checkpoint on the card.

Counterpart of ``tools/parity_eval.py``:

    python -m lrce_tpu_torch.tools.parity_eval --dataset msvd-qa-oe \\
        --dataset-dir /data/MSVD-QA --model-path /ckpts/msvd_best.pt \\
        --expected-accuracy 45.6

Reads a checkpoint in either format: the port's own torch file (which is
the reference's ``.pt`` layout: torch tensors under the reference's module
names) or ``lrce_tpu``'s native pickle, converted by ``utils/convert.py``.
Runs the eval CLI's path (``cli.eval.main``: the DistributedSampler's
padding included, so the number compares with the reference's multi-GPU
eval) and prints one JSON line with the measured accuracy (the count task:
MSE) and the loss. With ``--expected-accuracy`` it adds ``parity`` and
exits 1 when the measured value is further than ``--tolerance`` from it;
it exits 2 when the checkpoint or the dataset directory is missing.
Arguments it does not know go to the eval CLI's parser. Raises where there
is no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from lrce_tpu_torch.cli import eval as cli_eval
from lrce_tpu_torch.config import parse_arg_eval
from lrce_tpu_torch.models.e2e import E2EConfig
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def main(argv=None, *, device=DEFAULT_DEVICE,
         model_cfg: Optional[E2EConfig] = None) -> int:
    p = argparse.ArgumentParser(
        description="Evaluate a checkpoint and compare it with the paper's "
                    "accuracy (a one-command parity gate)")
    p.add_argument("--dataset", required=True)
    p.add_argument("--dataset-dir", required=True)
    p.add_argument("--model-path", required=True,
                   help="the port's checkpoint (the reference's torch .pt "
                        "layout) or lrce_tpu's native pickle")
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--num-workers", type=int, default=2)
    p.add_argument("--cache-items", type=int, default=0)
    p.add_argument("--expected-accuracy", type=float, default=None,
                   help="paper-table accuracy in percent (count task: the "
                        "expected MSE)")
    p.add_argument("--tolerance", type=float, default=0.5,
                   help="acceptable |measured - expected| in percentage "
                        "points (count: MSE units)")
    args_in, extra = p.parse_known_args(argv)
    device = resolve_device(device)

    for path in (args_in.model_path, args_in.dataset_dir):
        if not os.path.exists(path):
            print(json.dumps({"error": f"missing artifact: {path}"}))
            return 2

    eval_args = parse_arg_eval(
        ["--dataset", args_in.dataset,
         "--dataset-dir", args_in.dataset_dir,
         "--model-path", args_in.model_path,
         "--batch-size", str(args_in.batch_size),
         "--num-workers", str(args_in.num_workers),
         "--cache-items", str(args_in.cache_items)] + extra)
    agent = cli_eval.main(eval_args, device=device, model_cfg=model_cfg)
    is_count = eval_args.task_type == "count"
    measured = float(agent.last_metric_val) * (1.0 if is_count else 100.0)
    out = {
        "dataset": args_in.dataset,
        "metric": "MSE" if is_count else "accuracy_pct",
        "measured": round(measured, 3),
        "loss": round(float(agent.last_loss), 5),
        "checkpoint": args_in.model_path,
    }
    if args_in.expected_accuracy is not None:
        out["expected"] = args_in.expected_accuracy
        out["tolerance"] = args_in.tolerance
        out["parity"] = bool(
            abs(measured - args_in.expected_accuracy) <= args_in.tolerance)
    print(json.dumps(out), flush=True)
    if args_in.expected_accuracy is not None and not out["parity"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
