"""Profiling CLI: time and trace the flagship forward (or train step) on
the card.

Counterpart of ``tools/profile.py``. Prints the forward's FLOPs, the
per-step ms and clips/s, or with ``--latency`` the per-question latency
(batch 1, 3 clips: p50 / p90 over at least 20 synchronised requests), and
with ``--trace-dir`` writes a torch.profiler Chrome trace of 3 steps
(``trace.json``, loadable in Perfetto or chrome://tracing) with the
program's tracer on, so that its ``lrce.*`` spans (``utils/trace.py``: step,
forward, swin, bert, fusion and its clips, loss, backward, optimizer, ...)
sit beside the kernels they launched. Returns the numbers as a dict. Raises
where there is no card.

The FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over
one forward on the plain route, which does the same math as the kernel
route: the counter does not see inside the hand-written CUDA kernels. XLA's
"bytes accessed" has no counterpart and is not printed.

    python -m lrce_tpu_torch.tools.profile [--batch 8] [--train]
        [--latency] [--trace-dir DIR] [--iters 10]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from lrce_tpu_torch.models.e2e import E2EConfig, e2e_forward
from lrce_tpu_torch.tools import common
from lrce_tpu_torch.train.agent import AgentOE
from lrce_tpu_torch.utils import trace
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

LATENCY_REQUESTS = 20   # the least number of requests --latency times


def plain_flops(model, inputs) -> int:
    """FLOPs of one forward of ``model`` on ``inputs``, counted on the plain
    route (the model's route is restored after)."""
    swin = model.video_extractor.swin
    route = swin.use_kernels
    swin.use_kernels = False
    try:
        return common.count_flops(lambda: e2e_forward(model, *inputs), model)
    finally:
        swin.use_kernels = route


def main(argv=None, *, device=DEFAULT_DEVICE,
         model_cfg: Optional[E2EConfig] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--train", action="store_true",
                   help="profile the full train step instead of the forward")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler Chrome trace here, with the "
                        "program's lrce.* spans")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--latency", action="store_true",
                   help="measure p50/p90 per-question latency (batch 1)")
    p.add_argument("--plain", action="store_true", help=common.PLAIN_HELP)
    args = p.parse_args(argv)
    if args.latency:
        args.batch = 1
    device = resolve_device(device)

    model = common.flagship(device, model_cfg, plain=args.plain)
    b = args.batch
    inputs = common.bench_inputs(b, model.cfg, device)
    result = {"batch": b, "train": args.train}

    if args.train:
        agent = AgentOE(model, common.agent_args("profile", b, 0.001),
                        log_enabled=False)
        gt = torch.zeros((b,), dtype=torch.int64, device=device)

        def step():
            return agent.step(*inputs, gt, is_train=True)
    else:
        model.eval()

        def step():
            return float(e2e_forward(model, *inputs).float().sum())

        flops = plain_flops(model, inputs)
        result["plain_route_gflop"] = flops / 1e9
        print(f"plain-route flops: {flops / 1e9:.1f} GFLOP "
              "(FlopCounterMode over the plain route, which does the kernel "
              "route's math: the counter does not see inside the CUDA "
              "kernels)")
    _, first = common.wall(step, device)
    result["first_s"] = first

    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        trace.enable()
        try:
            with profile(activities=activities) as prof:
                for _ in range(3):
                    step()
                common.sync(device)
        finally:
            trace.disable()
            trace.drain()
        os.makedirs(args.trace_dir, exist_ok=True)
        path = os.path.join(args.trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        result["trace"] = path
        print(f"trace written to {path}")

    if args.latency:
        times = []
        for _ in range(max(args.iters, LATENCY_REQUESTS)):
            times.append(common.wall(step, device)[1])
        p50, p90 = np.percentile(times, [50, 90]) * 1e3
        n_clips = sum(model.cfg.temporal_scale)
        print(f"per-question latency: p50 {p50:.1f} ms  p90 {p90:.1f} ms "
              f"(batch 1, {n_clips} clips, "
              f"{'bf16' if device.type == 'cuda' else 'f32'}, "
              f"{len(times)} requests)")
        result.update(p50_ms=p50, p90_ms=p90, latency_ms=times)
        return result

    common.sync(device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        step()
    common.sync(device)
    dt = (time.perf_counter() - t0) / args.iters
    kind = "train" if args.train else "fwd"
    clips = b * sum(model.cfg.temporal_scale)
    print(f"{kind} step: {dt * 1e3:.1f} ms  "
          f"({clips / dt:.1f} clips/s/card, batch {b})")
    result.update(step_ms=dt * 1e3, clips_s=clips / dt)
    return result


if __name__ == "__main__":
    main()
