"""Benchmark: clips per second of the flagship forward on one card.

Counterpart of ``bench.py`` (the JAX package's, for a TPU chip) for the
CUDA port: the flagship (Swin-B + BERT-base + the 12-layer LRCE fusion, the
open-ended head over 1000 classes, temporal scale (3,), bf16 compute) at
32 questions x 3 clips of 5 x 224 x 224 frames (uniform f32 from seed 1,
token ids and mask of ones, type ids of zeros: ``common.bench_inputs``),
one warm-up forward, then 20 forwards timed on the host clock between two
``torch.cuda.synchronize()``.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} and
returns it as a dict. ``vs_baseline`` divides by bench.py's fixed 90
clips/s, BASELINE.md's estimate of the reference's torch fp16 forward on
an A100, not a measurement of this card. Raises where there is no card.

    python -m lrce_tpu_torch.tools.bench [--plain]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from lrce_tpu_torch.models.e2e import E2EConfig, e2e_forward
from lrce_tpu_torch.tools import common
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

# bench.py's denominator: an estimate of the reference's A100 throughput
# (BASELINE.md, "Derivation of the A100 denominator"), kept fixed so that
# runs compare; no card measured it
A100_BASELINE_CLIPS_PER_SEC = 90.0
BATCH = 32     # questions per forward (x 3 clips = 96 clips)
ITERS = 20     # timed forwards


def main(argv=None, *, device=DEFAULT_DEVICE,
         model_cfg: Optional[E2EConfig] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--plain", action="store_true", help=common.PLAIN_HELP)
    args = p.parse_args(argv)
    device = resolve_device(device)

    model = common.flagship(device, model_cfg, plain=args.plain).eval()
    inputs = common.bench_inputs(BATCH, model.cfg, device)
    clips = BATCH * sum(model.cfg.temporal_scale)
    out = e2e_forward(model, *inputs)
    if tuple(out.shape) != (BATCH, model.cfg.num_classes):
        raise RuntimeError(f"logits of shape {tuple(out.shape)}, expected "
                           f"{(BATCH, model.cfg.num_classes)}")
    common.sync(device)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = e2e_forward(model, *inputs)
    common.sync(device)
    clips_per_sec = clips * ITERS / (time.perf_counter() - t0)

    on_card = device.type == "cuda"
    where = torch.cuda.get_device_name(device) if on_card else "cpu"
    result = {
        # a name of its own: bench.py's clips_per_sec_per_chip is the TPU's
        "metric": "clips_per_sec_per_gpu" if on_card else "clips_per_sec_cpu",
        "value": round(clips_per_sec, 2),
        "unit": (f"clips/s (Swin-B + LRCE fwd, {'bf16' if on_card else 'f32'}"
                 f", batch {BATCH} x {clips // BATCH} clips, {where})"),
        "vs_baseline": round(clips_per_sec / A100_BASELINE_CLIPS_PER_SEC, 3),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
