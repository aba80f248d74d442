#!/usr/bin/env python3
"""Call K7 (``fused_ln_mlp``) many times on one GPU and watch for a kernel
that does not finish.

    python3 lrce_tpu_torch/tools/k7_stress.py [--clips 48,6,48] [--calls 500]

Run it from the root of the tree to be measured (the package and that tree's
``chip_smoke.py`` are imported from the current directory). At each clip
count (flagship stage 3: T = clips x 147, C = 1024, FF = 4096, random
weights from a seed) it makes ``--calls`` calls one after another, each
followed by a CUDA event that the host polls: a call that has not finished
after 5 s is reported as the call that wedged, and the process exits with
code 3 at once (the CUDA runtime ends the kernel with the process). After
the calls: the largest difference from the plain version and the time of
50 calls back to back (CUDA events). A persistent kernel whose CTAs wait
on one another fails by hanging, not by an error, so this is the test
that shows it does not.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

WEDGED_AFTER_S = 5.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips", default="48,6,48")
    ap.add_argument("--calls", type=int, default=500)
    args = ap.parse_args()
    import chip_smoke as C
    from lrce_tpu_torch.ops import swin_block as SB

    C.phase_device()
    C.phase_build()
    gen = torch.Generator().manual_seed(0)
    d, h, w, c, heads = C.STAGES[3]
    for clips in (int(v) for v in args.clips.split(",")):
        x = C._seeded((clips, d, h, w, c), gen)
        p = C._block_weights(c, heads, 147, gen, None)
        mlp = [p[k] for k in C.MLP_KEYS]
        with torch.no_grad():
            want = SB.ln_mlp_plain(x, *mlp, None)
            t0 = time.perf_counter()
            for i in range(args.calls):
                got = SB.fused_ln_mlp(x, *mlp, None)
                done = torch.cuda.Event()
                done.record()
                start = time.perf_counter()
                while not done.query():
                    if time.perf_counter() - start > WEDGED_AFTER_S:
                        print(f"[stress] {clips} clips: call {i} did not "
                              f"finish in {WEDGED_AFTER_S} s", flush=True)
                        os._exit(3)
            wall = (time.perf_counter() - t0) * 1e3 / args.calls
            err = (got.float() - want.float()).abs().max().item()
            ms = C._cuda_time_ms(lambda: SB.fused_ln_mlp(x, *mlp, None), 50)
        print(f"[stress] {clips} clips (T = {x.numel() // c}): {args.calls} "
              f"calls finished, {wall:.3f} ms each with a host poll, max "
              f"|kernel - plain| {err:.4g}; back to back {ms:.4f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
