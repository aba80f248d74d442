"""Preflight gate on the card: prove that the shipped defaults run.

Counterpart of ``tools/preflight.py`` for the CUDA port. Checks, in order,
each on the tree's default routing (the CUDA kernels), stopping at the
first failure:

  1. bench forward: bench.py's program, the flagship forward in bf16 at
     32 questions x 3 clips (96 clips); it must run and give finite
     (batch, classes) logits;
  2. train step: one flagship train step (forward, loss, backward, AdamW)
     at batch 16 through the real AgentOE; the loss must be finite.

Prints one JSON line {"preflight": "pass"|"fail", "device": ..., "checks":
{...}} (each check's first-call seconds, synchronised) and exits non-zero
on failure. Raises where there is no card.

    python -m lrce_tpu_torch.tools.preflight [--train-batch 16] [--skip-train]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import traceback
from typing import Optional

import torch

from lrce_tpu_torch.models.e2e import E2EConfig, e2e_forward
from lrce_tpu_torch.tools import common
from lrce_tpu_torch.train.agent import AgentOE
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

BENCH_BATCH = 32        # bench.py's questions per forward


def bench_forward(device: torch.device, model_cfg: Optional[E2EConfig],
                  plain: bool = False) -> dict:
    model = common.flagship(device, model_cfg, plain=plain).eval()
    cfg, batch = model.cfg, BENCH_BATCH
    inputs = common.bench_inputs(batch, cfg, device)
    out, dt = common.wall(lambda: e2e_forward(model, *inputs), device)
    s = float(out.float().sum())
    if tuple(out.shape) != (batch, cfg.num_classes):
        raise RuntimeError(f"logits of shape {tuple(out.shape)}, expected "
                           f"{(batch, cfg.num_classes)}")
    if not math.isfinite(s):
        raise RuntimeError(f"non-finite forward output (sum={s})")
    return {"compile_plus_first_s": round(dt, 3)}


def train_step(device: torch.device, model_cfg: Optional[E2EConfig],
               batch: int, plain: bool = False) -> dict:
    model = common.flagship(device, model_cfg, plain=plain)
    agent = AgentOE(model, common.agent_args("preflight", batch),
                    log_enabled=False)
    host = common.host_batch(batch, model.cfg)
    (loss, *_), dt = common.wall(lambda: agent.step(*host, is_train=True),
                                 device)
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite train loss ({loss})")
    return {"compile_plus_first_s": round(dt, 3), "loss": round(loss, 6)}


def main(argv=None, *, device=DEFAULT_DEVICE,
         model_cfg: Optional[E2EConfig] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train-batch", type=int, default=16)
    p.add_argument("--skip-train", action="store_true")
    p.add_argument("--plain", action="store_true", help=common.PLAIN_HELP)
    args = p.parse_args(argv)
    device = resolve_device(device)

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    result = {"preflight": "pass", "device": name, "checks": {}}
    checks = [("bench_forward", lambda: bench_forward(
        device, model_cfg, args.plain))]
    if not args.skip_train:
        checks.append(("train_step", lambda: train_step(
            device, model_cfg, args.train_batch, args.plain)))
    for label, fn in checks:
        print(f"preflight: {label} ...", file=sys.stderr, flush=True)
        try:
            result["checks"][label] = {"ok": True, **fn()}
        except Exception as e:  # noqa: BLE001 - the gate reports, then fails
            result["checks"][label] = {
                "ok": False, "error": (str(e).splitlines() or [repr(e)])[-1][:400]}
            result["preflight"] = "fail"
            print(traceback.format_exc(limit=3), file=sys.stderr)
            break   # fail fast: later checks share the broken routing
    print(json.dumps(result), flush=True)
    return 0 if result["preflight"] == "pass" else 1


if __name__ == "__main__":
    sys.exit(main())
