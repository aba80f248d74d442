"""Flagship train-step benchmark on the card.

Counterpart of ``tools/train_bench.py``. Times the real train step (Swin-B
+ BERT-base + LRCE fusion: forward, loss, backward, AdamW over three
groups; the step the train CLI runs) through ``AgentOE`` at a given batch,
in four regimes, each over ``--iters`` steps after two warm-up steps,
between synchronisations of the card:

  wall     - the uint8 host batch copied to the card every step (a loop
             without prefetch);
  prefetch - host batches through ``data/prefetch.device_prefetch``, the
             path ``process_data`` runs: the copy of batch N+1 overlaps
             step N;
  device   - the batch already on the card: the step alone;
  lagged   - ``process_data``'s loop shape: ``agent.dispatch`` one step
             ahead, step N-1's metrics read while step N runs.

Prints the first step's seconds and loss, each regime's ms and clips/s,
and the peak device memory (``torch.cuda.max_memory_allocated``); returns
them as a dict. Raises where there is no card.

    python -m lrce_tpu_torch.tools.train_bench [--batch 16] [--iters 10]
        [--device-only]
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Optional

import torch

from lrce_tpu_torch.data.prefetch import device_prefetch
from lrce_tpu_torch.models.e2e import E2EConfig
from lrce_tpu_torch.tools import common
from lrce_tpu_torch.train.agent import AgentOE
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def main(argv=None, *, device=DEFAULT_DEVICE,
         model_cfg: Optional[E2EConfig] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--remat", action="store_true",
                   help="accepted for the JAX tool's command line; no "
                        "effect: the port has no Swin rematerialisation (K4 "
                        "and K5 recompute the attention and the MLP hidden "
                        "in the backward)")
    p.add_argument("--no-remat", dest="remat", action="store_false",
                   help="(default) explicit off switch")
    p.add_argument("--reg", type=float, default=0.0,
                   help="reg_strength (paper configs use 0.001)")
    p.add_argument("--device-only", action="store_true",
                   help="skip the wall / prefetch regimes: measure only the "
                        "device and lagged regimes")
    p.add_argument("--plain", action="store_true", help=common.PLAIN_HELP)
    args = p.parse_args(argv)
    device = resolve_device(device)

    model = common.flagship(device, model_cfg, plain=args.plain)
    agent = AgentOE(model, common.agent_args("bench", args.batch, args.reg),
                    log_enabled=False)
    b = args.batch
    host_batch = common.host_batch(b, model.cfg)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    (loss, *_), first = common.wall(
        lambda: agent.step(*host_batch, is_train=True), device)
    print(f"compile+first step: {first:.1f}s loss={loss:.4f}", flush=True)
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")

    def per_step(run) -> float:
        """Seconds per step of ``run(k)`` (k steps), after 2 warm-up
        steps, between synchronisations."""
        run(2)
        return common.wall(lambda: run(args.iters), device)[1] / args.iters

    def stepped(batch):
        def run(k):
            for _ in range(k):
                agent.step(*batch, is_train=True)
        return run

    def prefetched(k):
        for dev_b in device_prefetch((host_batch for _ in range(k)), device):
            agent.step(*dev_b, is_train=True)

    wall = pref = None
    if not args.device_only:
        wall = per_step(stepped(host_batch))
        pref = per_step(prefetched)
    dev_batch = tuple(torch.as_tensor(a).to(device) for a in host_batch)
    dev = per_step(stepped(dev_batch))

    # the lagged loop: iters + 1 steps between a synchronised start and the
    # read of the last step's vector
    common.sync(device)
    t0 = time.perf_counter()
    pending = agent.dispatch(*dev_batch, is_train=True)
    for _ in range(args.iters):
        out = agent.dispatch(*dev_batch, is_train=True)
        pending.tolist()
        pending = out
    pending.tolist()
    lag = (time.perf_counter() - t0) / (args.iters + 1)

    clips = sum(model.cfg.temporal_scale) * b
    print(f"batch {b} ({clips} clips), "
          f"plain={args.plain}, reg={args.reg}")
    result = {"batch": b, "clips": clips, "first_s": first, "loss": loss}
    for label, t in (("wall", wall), ("prefetch", pref), ("device", dev),
                     ("lagged", lag)):
        if t is None:
            continue
        print(f"  {label + ' step:':14s} {t * 1000:7.1f} ms  "
              f"{clips / t:7.1f} clips/s")
        result[f"{label}_ms"] = t * 1e3
        result[f"{label}_clips_s"] = clips / t
    if device.type == "cuda":
        result["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        print(f"  peak device memory: {result['peak_gib']:7.2f} GiB")
    return result


if __name__ == "__main__":
    main()
