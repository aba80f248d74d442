"""Sanity-check training curve at full width on the card.

Counterpart of ``tools/sanity_curve.py``: the reference's ``--sanity-check``
recipe (truncate the train split to 500 samples and overfit: "you should
see a very small loss value at the end") at the flagship's widths (Swin-B
+ BERT-base + LRCE fusion, 224 x 224, temporal scale 3) through the port's
train CLI (``cli.train.main``) on the synthetic TGIF-frameqa set of
``synth.build_dataset``. Each question carries a unique marker word and an
answer that is a function of its video, so the set can be memorised.

Prints one JSON record per epoch (the agent's "Sanity loss" log line:
loss, accuracy, seconds since the start), then one JSON line with the
curve; returns that dict with the trainer under "trainer". Raises where
there is no card.

    python -m lrce_tpu_torch.tools.sanity_curve [--samples 500] [--epochs 8]
        [--batch-size 16] [--lr 3e-4] [--keep-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
import tempfile
import time
from typing import Optional

from lrce_tpu_torch import constants
from lrce_tpu_torch.cli import train as cli_train
from lrce_tpu_torch.config import parse_arg_train
from lrce_tpu_torch.models.e2e import E2EConfig
from lrce_tpu_torch.tools import common, synth
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

NUM_WORKERS = 4     # the loader's threads (the JAX tool's)


class _Capture(logging.Handler):
    """The agent's "Sanity loss <loss> <metric> <pct>%" records, as dicts,
    each printed as a JSON line when it comes."""

    def __init__(self, t0: float):
        super().__init__(logging.INFO)
        self.t0 = t0
        self.records = []

    def emit(self, rec):
        msg = rec.getMessage()
        if not msg.startswith("Sanity loss"):
            return
        parts = msg.split()
        if parts[2] == "n/a":
            return
        self.records.append({"epoch": len(self.records) + 1,
                             "loss": float(parts[2]),
                             "acc_pct": float(parts[4].rstrip("%")),
                             "t": round(time.perf_counter() - self.t0, 1)})
        print(json.dumps(self.records[-1]), flush=True)


def main(argv=None, *, device=DEFAULT_DEVICE,
         model_cfg: Optional[E2EConfig] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--samples", type=int, default=500)
    p.add_argument("--videos", type=int, default=50)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4,
                   help="encoder (text/video group) learning rate")
    p.add_argument("--fusion-lr", type=float, default=1e-3,
                   help="fusion+head group learning rate (memorisation "
                        "lives mostly here for a from-scratch overfit)")
    p.add_argument("--freeze-encoders", action="store_true",
                   help="zero the text/video group learning rates so only "
                        "the LRCE fusion + head train. This switches the run "
                        "to the constant-rate (plateau) scheduler: under the "
                        "cosine scheduler every group takes lr[0] (the "
                        "reference's scheduler quirk, kept in "
                        "train/schedule.py), so zeroed encoder rates would "
                        "train anyway")
    p.add_argument("--lr-decay-factor", type=float, default=1.0,
                   help="per-cycle max-LR decay for the cosine scheduler "
                        "(the train default 0.5 every 2 epochs all but "
                        "stops an overfit by epoch ~14). Default here: no "
                        "decay")
    p.add_argument("--lr-restart-epoch", type=int, default=8,
                   help="cosine cycle length in epochs (train default 2)")
    p.add_argument("--keep-dir", default=None,
                   help="build the dataset here and keep it (default: tmp)")
    args = p.parse_args(argv)
    if args.freeze_encoders:
        args.lr = 0.0
    if args.samples < constants.SANITY_CHECK_SIZE:
        # sanity mode's __len__ is the constant SANITY_CHECK_SIZE (the
        # reference's dataset quirk): fewer rows would index out of bounds
        p.error(f"--samples must be >= {constants.SANITY_CHECK_SIZE} "
                "(sanity mode always draws that many)")
    device = resolve_device(device)

    with tempfile.TemporaryDirectory(prefix="sanity_") as tmp:
        root = pathlib.Path(args.keep_dir or tmp)
        root.mkdir(parents=True, exist_ok=True)
        synth.build_dataset(root, args.videos, args.samples)
        argv_train = [
            "--dataset", "tgif-frameqa", "--dataset-dir", str(root),
            "--log-dir", str(root / "runs"),
            "--batch-size", str(args.batch_size),
            "--epoch", str(args.epochs),
            "--num-workers", str(NUM_WORKERS),
            # group order is (fusion, text, video): train/optimizer.GROUPS
            "--lr", str(args.fusion_lr), str(args.lr), str(args.lr),
            # overfitting is the point: no regularisation (the train
            # default drop-out 0.5 blocks memorisation outright)
            "--drop-out-rate", "0", "--reg-strength", "0", "--sanity-check",
            "--cache-items", str(args.samples),
        ]
        if not args.freeze_encoders:
            # freezing needs the plateau path, whose per-group rates stay
            # constant in sanity mode (no validation: never stepped)
            argv_train += [
                "--use-cosine-scheduler",
                "--lr-decay-factor", str(args.lr_decay_factor),
                "--lr-restart-epoch", str(args.lr_restart_epoch),
            ]
        targs = parse_arg_train(argv_train)
        if model_cfg is not None:
            model_cfg = model_cfg._replace(drop_out_rate=targs.drop_out_rate)

        # the root logger at INFO at least while the run lasts (a handler
        # alone would leave it at WARNING and drop the agent's records)
        root_logger = logging.getLogger()
        level = root_logger.level
        root_logger.setLevel(min(level, logging.INFO))
        capture = _Capture(time.perf_counter())
        root_logger.addHandler(capture)
        try:
            with common.bert_vocab(root / "vocab.txt"):
                trainer = cli_train.main(targs, device=device,
                                         model_cfg=model_cfg)
        finally:
            root_logger.removeHandler(capture)
            root_logger.setLevel(level)

    result = {"samples": args.samples, "epochs": args.epochs,
              "batch_size": args.batch_size, "lr": args.lr,
              "curve": capture.records}
    print(json.dumps(result), flush=True)
    return {**result, "trainer": trainer}


if __name__ == "__main__":
    main()
