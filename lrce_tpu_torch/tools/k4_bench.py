#!/usr/bin/env python3
"""Time K4 (``window_attention_bwd``) at the 16-frame window (8, 7, 7),
N = 392, where its rows / columns pair runs, split by kernel on the device.

    python -m lrce_tpu_torch.tools.k4_bench [--clips 48]

Run it from the root of the tree to be measured: the package, this script
and that tree's ``chip_smoke.py`` (for its helpers) come from the current
directory, so a comparison runs each checkout's own copy in turns on one
card (each tree builds its own kernel library).

At each flagship stage of 16-frame clips (stages 0-2 shifted by (0, 3, 3),
stage 3 unshifted): the wrapper's ms (CUDA events, warm, 5 calls, timed
twice) at the window groups ``ops/window_attn.attn_bwd_groups`` picks, the
device ms a call by kernel name (3 calls under torch.profiler), and the
bound (chip_smoke's K4 work at N = 392). The last line is one JSON object
with every number. Fails where there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips", type=int, default=48)
    args = ap.parse_args()
    import chip_smoke as C
    from lrce_tpu_torch.models.swin3d import compute_shift_mask
    from lrce_tpu_torch.ops import window_attn as WA
    from lrce_tpu_torch.tools.mlp_bench import _device

    card = C.phase_device()
    C.phase_build()
    gen = torch.Generator().manual_seed(0)
    dgen = torch.Generator(device="cuda").manual_seed(0)
    window, n, clips = C.WINDOW16, 392, args.clips
    rows = []
    for stage, (d, h, w, c, heads) in enumerate(C.STAGES16):
        x = C._device_seeded((clips, d, h, w, c), dgen)
        g = C._device_seeded((clips, d, h, w, c), dgen)
        p = C._block_weights(c, heads, n, gen, None)
        shift = C.SHIFT if stage < 3 else C.NO_SHIFT
        mask = None
        if stage < 3:
            nwin = (d // window[0], h // window[1], w // window[2])
            mask = torch.from_numpy(compute_shift_mask(
                (d, h, w), window, shift)).reshape(*nwin, n, n).cuda()
        k4 = (x, g, *(p[k] for k in ("ln1s", "ln1b", "qkv_w", "qkv_b",
                                     "proj_w", "rel_bias")),
              mask, window, heads, 1e-5, shift)

        def run():
            return WA.window_attention_bwd(*k4)

        windows = x.numel() // (c * n)
        groups = WA.attn_bwd_groups(windows, heads, WA.sm_count(x),
                                    WA.attn_bwd_blocks(n))
        ms = [C._cuda_time_ms(run, 5) for _ in range(2)]
        _, by_kernel = _device(run, 3)
        bound, by = C._bound_ms(C._work("K4", clips, stage, stage < 3,
                                        stages=C.STAGES16, window=window))
        row = {"stage": stage, "clips": clips, "windows": windows,
               "heads": heads, "groups": groups, "ms": ms,
               "device_ms_by_kernel": by_kernel,
               "bound_ms": bound, "bound_by": by}
        print(f"[k4] stage {stage}, {clips} clips ({windows} windows x "
              f"{heads} heads, {groups} window groups): {ms[0]:.3f} / "
              f"{ms[1]:.3f} ms; device by kernel: "
              + ", ".join(f"{k} {v:.3f}" for k, v in by_kernel.items())
              + f"; bound {bound:.4f} ms ({by})", flush=True)
        rows.append(row)
        del x, g, p, mask, k4
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "k4_bench": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
