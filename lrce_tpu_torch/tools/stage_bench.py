"""Per-stage Swin-B timing on the card: the CUDA kernel route against the
plain PyTorch route.

Counterpart of ``tools/stage_bench.py``. Each stage (its blocks and the
patch merging after it) runs alone, without autograd, on its flagship
input shape (``--clips`` clips of 3 x 56 x 56 x 128, 3 x 28 x 28 x 256,
3 x 14 x 14 x 512 or 3 x 7 x 7 x 1024 tokens; 48 = 16 questions x 3 clips
by default), bf16, random weights and inputs from seeds. Times are CUDA
events over ``--iters`` calls after a warm-up call, in the order kernel,
plain, plain, kernel; each route's time is the mean of its two runs.
Returns one dict per stage. Raises where there is no card.

    python -m lrce_tpu_torch.tools.stage_bench [--clips 48] [--iters 20]
        [--stage N]
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from lrce_tpu_torch.models import swin3d as S
from lrce_tpu_torch.models.e2e import E2EConfig
from lrce_tpu_torch.tools import common
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def stage_shapes(clips: int, cfg: S.SwinConfig, frames: int = 5,
                 size: int = 224):
    """Each stage's input shape (B, D, H, W, C) for ``clips`` clips of
    ``frames`` x ``size`` x ``size``."""
    pd, ph, pw = cfg.patch_size
    d, h, w = -(-frames // pd), size // ph, size // pw
    return [(clips, d, h >> i, w >> i, cfg.embed_dim << i)
            for i in range(len(cfg.depths))]


def main(argv=None, *, device=DEFAULT_DEVICE,
         model_cfg: Optional[E2EConfig] = None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--clips", type=int, default=48)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--stage", type=int, default=None,
                   help="bench only this stage index (0-3)")
    args = p.parse_args(argv)
    device = resolve_device(device)

    cfg = (model_cfg or common.FLAGSHIP).swin
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    swin = S.SwinTransformer3D(cfg, dtype=dtype,
                               generator=torch.Generator().manual_seed(0)
                               ).to(device)
    shapes = stage_shapes(args.clips, cfg)
    stages = range(len(shapes)) if args.stage is None else [args.stage]
    rows = []
    for si in stages:
        gen = torch.Generator().manual_seed(si + 1)
        x = torch.randn(shapes[si], generator=gen).to(device, dtype)
        layer = swin.layers[si]

        def run(kernels: bool, _layer=layer, _x=x):
            with torch.no_grad():
                return _layer(_x, kernels, swin.consts)

        times = {True: 0.0, False: 0.0}
        for kernels in (True, False, False, True):
            times[kernels] += common.time_ms(lambda k=kernels: run(k),
                                             device, args.iters) / 2
        row = {"stage": si, "c": shapes[si][-1], "depth": cfg.depths[si],
               "clips": args.clips, "kernel_ms": times[True],
               "plain_ms": times[False]}
        rows.append(row)
        print(f"stage{si} (C={row['c']}, depth {row['depth']}): "
              f"kernel {times[True]:7.2f} ms   plain {times[False]:7.2f} ms"
              f"   ({times[False] / times[True]:.2f}x)", flush=True)
    return rows


if __name__ == "__main__":
    main()
