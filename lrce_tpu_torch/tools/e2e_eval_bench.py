"""Sustained end-to-end eval throughput: the eval CLI's path with real
ingest (GIF decode -> resize -> batch -> copy to the card -> flagship
forward), not the device-resident batches of a bench forward.

Counterpart of ``tools/e2e_eval_bench.py``. Writes the sanity curve's
synthetic TGIF-frameqa set (``synth.build_dataset``), builds the eval
agent as ``cli/eval.py`` builds it (random weights), cuts the test split
to ``--samples`` questions, and times ``do_evaluation`` over it three
times, between synchronisations of the card:

  cold            - nothing cached: every question decodes its GIF;
  warm-count      - the same again, the files in the OS's page cache;
  warm-clip-cache - the dataset's clip LRU (``video_decode.ClipCache``,
                    one entry per video) filled beforehand on the host:
                    no decode at all.

The JAX tool sets ``--cache-items`` to the video count for all three
passes, so there the first pass decodes each video once and the later two
both read the clip cache. Reports clips/s for each pass (a question is 3
clips) and prints one JSON line. Raises where there is no card.

    python -m lrce_tpu_torch.tools.e2e_eval_bench [--samples 256]
        [--videos 32] [--batch-size 32] [--workers 4] [--keep-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import time
from typing import Optional

from lrce_tpu_torch.cli.train import build_datasets, build_model
from lrce_tpu_torch.config import parse_arg_eval
from lrce_tpu_torch.constants import SANITY_CHECK_SIZE
from lrce_tpu_torch.data.loader import DataLoader
from lrce_tpu_torch.models.e2e import E2EConfig
from lrce_tpu_torch.tools import common, synth
from lrce_tpu_torch.train.agent import agent_factory
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

PASSES = ("cold", "warm-count", "warm-clip-cache")


def main(argv=None, *, device=DEFAULT_DEVICE,
         model_cfg: Optional[E2EConfig] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--samples", type=int, default=256)
    p.add_argument("--videos", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--keep-dir", default=None)
    p.add_argument("--plain", action="store_true", help=common.PLAIN_HELP)
    args = p.parse_args(argv)
    device = resolve_device(device)

    with tempfile.TemporaryDirectory(prefix="evalbench_") as tmp:
        root = pathlib.Path(args.keep_dir or tmp)
        root.mkdir(parents=True, exist_ok=True)
        synth.build_dataset(root, args.videos,
                            max(args.samples, SANITY_CHECK_SIZE))
        with common.bert_vocab(root / "vocab.txt"):
            return _bench(args, root, device, model_cfg)


def _bench(args, root: pathlib.Path, device, model_cfg) -> dict:
    eval_args = parse_arg_eval([
        "--dataset", "tgif-frameqa", "--dataset-dir", str(root),
        "--batch-size", str(args.batch_size),
        "--num-workers", str(args.workers),
        "--model-path", "unused", "--cache-items", "0"])
    (test_dataset,) = build_datasets(eval_args, splits=("test",))
    test_dataset.label_file = test_dataset.label_file[:args.samples]

    model = build_model(eval_args, device, model_cfg)
    model.video_extractor.swin.use_kernels = not args.plain
    agent = agent_factory(eval_args.task_type)(
        model, eval_args, log_enabled=False, is_eval=True)
    loader = DataLoader(test_dataset, eval_args.batch_size, num_replicas=1,
                        shuffle=False, num_workers=args.workers)

    n_clips = len(test_dataset) * sum(eval_args.temporal_scale)
    out = {"samples": len(test_dataset), "batch_size": args.batch_size,
           "workers": args.workers}
    for label in PASSES:
        if label == "warm-clip-cache":
            # one entry per video, filled on the host before the pass
            test_dataset.cache.max_items = args.videos
            seen = set()
            for i in range(len(test_dataset)):
                name = test_dataset._get_video_name(i)
                if name not in seen:
                    seen.add(name)
                    test_dataset[i]
        dt = common.wall(lambda: agent.do_evaluation(loader), device)[1]
        out[label] = n_clips / dt
        out[f"{label}_s"] = dt
        print(f"{label:16s} {n_clips / dt:8.1f} clips/s  ({dt:.1f}s)",
              flush=True)
    out["loss"] = agent.last_loss
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
