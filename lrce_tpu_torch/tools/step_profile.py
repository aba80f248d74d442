#!/usr/bin/env python3
"""Time and profile the flagship train step of the port on one GPU.

    python -m lrce_tpu_torch.tools.step_profile [--steps 6] [--profile]
                                                [--frames 5]

Run it from the root of the tree to be measured: the package and this
script come from the current directory, so a comparison runs each
checkout's own copy (``cd other/tree && python -m ...``) in turns on one
card.

It builds the flagship LRCEModel (f32 parameters, bf16 compute, random
weights from seed 0) and an AgentOE with the config defaults, takes two
warm-up steps at 16 questions x 3 clips of seeded uint8 frames (5 a clip,
or ``--frames``: 16 gives the window (8, 7, 7), N = 392), then
``--steps`` timed steps made of the agent's own pieces (zero_grad, forward,
loss + l2_reg, backward, AdamW): per step the wall ms (host clock around a
synchronized step, the batch's copy included) and the CUDA-event ms of each
piece and the peak device memory inside each piece (the allocator's peak is
reset between the pieces), then the step's peak. With ``--profile`` one more
step runs under torch.profiler and the device time is summed by kind of
kernel, with the launches. The device's idle share is not this tool's: a sum
of kernel times over a profiled step's wall time counts overlapping kernels
twice and the profiler's own host cost as idle. The benchmark's
``idle_share.train`` (``portbench/``: one minus the union of the device's busy
intervals over a traced window) is the measure. The last line is one JSON
object with every number printed. Fails where there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 16    # questions per step, x 3 clips: the trainer's default batch
KINDS = (   # first match wins, on the kernel's name; the names of earlier
            # versions of the kernels stay, so that an older checkout sorts alike
    ("K4 attention-backward CTA", ("attn_bwd_kernel",)),
    ("K4 rows / columns pair (N > 160)", ("attn_bwd_rows", "attn_bwd_cols")),
    ("K5 hidden kernel (fc1 + dhid + GELU backward)", ("mlp_bwd_hidden",)),
    ("split-K weight-gradient GEMM", ("gemm_tn",)),
    ("hand-written GEMM", ("gemm_wgmma", "gemm_bf16_kernel")),
    ("K1 / K3 back half (proj, LN2, fc1, GELU, fc2)", ("back_half_kernel",)),
    ("window attention forward CTA (N <= 160)", ("attn_fwd_kernel",)),
    ("window attention forward CTA (N = 161-448)", ("attn_fwd_big_kernel",)),
    ("window attention forward, WMMA CTA", ("window_attn_kernel",)),
    ("LN / gather / row-scale / partial sums (kernels)",
     ("ln_rows", "gather_rows", "scale_rows", "sum_parts")),
    ("AdamW (multi-tensor)", ("multi_tensor", "adam")),
    ("library GEMMs and convolutions",
     ("cutlass", "xmma", "cublas", "gemm", "gemv", "cudnn", "conv", "nvjet")),
    ("PyTorch reductions", ("reduce",)),
    ("PyTorch elementwise and copies",
     ("elementwise", "vectorized", "copy", "Memcpy", "Memset", "cat",
      "index", "fill", "dropout", "layer_norm", "softmax", "gather",
      "scatter")),
)


def _kind(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def _batch(rng, questions: int, frames: int = 5):
    clips = rng.integers(0, 256, (questions, 3, frames, 224, 224, 3),
                         dtype=np.uint8)
    ids = rng.integers(1000, 30000, (questions, 32))
    mask = np.ones((questions, 32), np.int64)
    mask[::2, 24:] = 0
    types = np.zeros((questions, 32), np.int64)
    gt = rng.integers(0, 1000, (questions,))
    return clips, ids, mask, types, gt


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--frames", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_profile: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)

    from lrce_tpu_torch.models.e2e import E2EConfig, LRCEModel
    from lrce_tpu_torch.train import optimizer as O
    from lrce_tpu_torch.train.agent import AgentOE, default_args

    cfg = E2EConfig(num_classes=1000, temporal_scale=(3,), text_seq_len=32,
                    frame_sample_size=args.frames)
    model = LRCEModel(cfg, dtype=torch.float32, compute_dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    agent = AgentOE(model, default_args(), log_enabled=False, seed=0)
    rng = np.random.default_rng(7)
    batches = [_batch(rng, BATCH, args.frames) for _ in range(3)]

    def step(events: bool):
        """The agent's train step, piece by piece, with an event between
        the pieces. Returns (wall ms, {piece: ms, piece_peak_gib: GiB} or
        None)."""
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        peaks = []

        def mark(i):
            # the allocator keeps its books on the host: exact per piece
            marks[i].record()
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            torch.cuda.reset_peak_memory_stats()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = agent._put_batch(batches[step.n % len(batches)])
        step.n += 1
        agent.optimizer.zero_grad(set_to_none=True)
        mark(0)
        logits = agent._forward(*batch[:4], True)
        mark(1)
        loss = agent._loss(logits, batch[4])
        mark(2)
        loss.backward()
        mark(3)
        O.set_lrs(agent.optimizer, agent.lrs)
        agent.optimizer.step()
        mark(4)
        value = loss.item()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if not np.isfinite(value):
            raise RuntimeError(f"non-finite loss {value}")
        if not events:
            return wall, None
        names = ("forward", "loss", "backward", "optimizer")
        parts = {n: marks[i].elapsed_time(marks[i + 1])
                 for i, n in enumerate(names)}
        parts.update({f"{n}_peak_gib": peaks[i + 1]
                      for i, n in enumerate(names)})
        return wall, parts

    step.n = 0
    for _ in range(2):
        print(f"[step] warm-up: {step(False)[0]:.1f} ms", flush=True)
    rows = []
    for _ in range(args.steps):
        wall, parts = step(True)
        rows.append({"wall_ms": wall, **parts})
        print(f"[step] wall {wall:.1f} ms; "
              + ", ".join(f"{k} {v:.{2 if k.endswith('gib') else 1}f}"
                          for k, v in parts.items()), flush=True)
    peak = max(v for r in rows for k, v in r.items() if k.endswith("gib"))
    med = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
    print(f"[step] {args.steps} steps of {BATCH} questions x 3 clips, "
          f"median wall {med['wall_ms']:.1f} ms "
          f"(min {min(r['wall_ms'] for r in rows):.1f}, max "
          f"{max(r['wall_ms'] for r in rows):.1f}), median forward "
          f"{med['forward']:.1f}, loss {med['loss']:.1f}, backward "
          f"{med['backward']:.1f}, optimizer {med['optimizer']:.1f} ms (CUDA "
          f"events); peak device memory {peak:.2f} GiB (inside the forward "
          f"{med['forward_peak_gib']:.2f}, the loss {med['loss_peak_gib']:.2f}, "
          f"the backward {med['backward_peak_gib']:.2f}, the optimizer "
          f"{med['optimizer_peak_gib']:.2f})", flush=True)
    result = {"card": card, "steps": rows, "median": med, "peak_gib": peak,
              "batch": BATCH}

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _ = step(False)
        kinds: dict = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if us <= 0:
                continue
            k = kinds.setdefault(_kind(e.key), {"ms": 0.0, "launches": 0})
            k["ms"] += us / 1e3
            k["launches"] += e.count
        busy = sum(k["ms"] for k in kinds.values())
        if busy <= 0:
            raise RuntimeError("the profiler recorded no device time")
        print(f"[profile] one step under torch.profiler: wall {wall:.1f} ms, "
              f"device time {busy:.1f} ms, "
              f"{sum(k['launches'] for k in kinds.values())} launches",
              flush=True)
        for name, k in sorted(kinds.items(), key=lambda kv: -kv[1]["ms"]):
            print(f"[profile]   {name}: {k['ms']:.1f} ms, {k['launches']} "
                  "launches", flush=True)
        result["profile"] = {"wall_ms": wall, "device_ms": busy,
                             "kinds": kinds}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
