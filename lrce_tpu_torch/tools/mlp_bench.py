#!/usr/bin/env python3
"""Time K7 (``fused_ln_mlp``) and K8 (``fused_mlp``) on one GPU, split by
kernel on the device, with the library's products beside them.

    python -m lrce_tpu_torch.tools.mlp_bench [--clips 6,48]

Run it from the root of the tree to be measured: the package, this script
and that tree's ``chip_smoke.py`` (for its helpers) come from the current
directory, so a comparison runs each checkout's own copy, or the same tree
with another version of a source under ``csrc/``, in turns on one card
(each tree builds its own kernel library).

At each clip count: K7 at the flagship's stage 3 (T = clips x 147, C =
1024, FF = 4096) without and with dp2, K8 at stage 0 (C = 128, FF = 512)
and at the stage-1 width (C = 256), and K1 / K3's back half
(``swin_back_half``) at stages 0 and 1, each held to its plain version
first. Per entry: the wrapper's ms (CUDA events, warm, 20 calls back to
back, timed twice: the host's cost of a call shows here where it exceeds
the device's), the kernels a call launches and their device ms by kernel
name (5 calls under torch.profiler: for a kernel of several launches, each
of its kernels summed over a call), the bound (the larger of 4 T C FF
operations over 989 TFLOP/s and the bytes that must move over 3.35 TB/s)
and, as yardsticks the port never calls, ``torch.matmul`` of fc1 (T x C .
C x FF) and of fc2 (T x FF . FF x C), by CUDA events and by device time.
The last line is one JSON object with every number. Fails where there is
no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import torch

ITERS = 20


def _device(fn, calls: int = 5):
    """Per call: (kernel launches, device ms by kernel name) over ``calls``
    calls under torch.profiler; (None, {}) where it records no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    launches = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        launches += 1
        name = re.search(r"\w+_kernel(<[^(]*?>)?", e.name)
        key = name.group(0) if name else e.name[:60]
        by_name[key] = by_name.get(key, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / calls
    if not launches:
        return None, {}
    return launches / calls, by_name


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips", default="6,48")
    args = ap.parse_args()
    import chip_smoke as C
    from lrce_tpu_torch.ops import gemm as G
    from lrce_tpu_torch.ops import mlp as M
    from lrce_tpu_torch.ops import swin_block as SB

    card = C.phase_device()
    C.phase_build()
    gen = torch.Generator().manual_seed(0)
    rows = []

    def timed(fn):
        a = C._cuda_time_ms(fn, ITERS)
        b = C._cuda_time_ms(fn, ITERS)
        return [a, b]

    for clips in (int(v) for v in args.clips.split(",")):
        cases = [("K7 stage 3", 3, False), ("K7 stage 3 dp2", 3, True),
                 ("K8 stage 0", 0, False), ("K8 C=256", 1, False)]
        for name, stage, with_dp in cases:
            d, h, w, c, _ = C.STAGES[stage]
            ff = 4 * c
            x = C._seeded((clips, d, h, w, c), gen)
            p = C._block_weights(c, 4, 147, gen, None)
            mlp = [p[k] for k in C.MLP_KEYS]
            dp = ((torch.rand((clips,), generator=gen) < 0.8).float().cuda()
                  / 0.8) if with_dp else None
            if name.startswith("K7"):
                def run():
                    return SB.fused_ln_mlp(x, *mlp, dp, 1e-5)
            else:
                def run():
                    return M.fused_mlp(x, *mlp, 1e-5)
            t = x.numel() // c
            with torch.no_grad():
                C._compare(f"{name} {clips} clips", run(),
                           SB.ln_mlp_plain(x, *mlp, dp, 1e-5))
                ms = timed(run)
                n_launch, by_kernel = _device(run)
                z = G.ln_rows(x, mlp[0], mlp[1])
                hid = G.gemm_bf16(z, mlp[2], G.EPI_BIAS_GELU, mlp[3])
                w1t, w2t = mlp[2].t(), mlp[4].t()
                lib = {"fc1": timed(lambda: torch.matmul(z, w1t)),
                       "fc2": timed(lambda: torch.matmul(hid, w2t))}
                lib_dev = {k: sum(_device(f)[1].values()) for k, f in (
                    ("fc1", lambda: torch.matmul(z, w1t)),
                    ("fc2", lambda: torch.matmul(hid, w2t)))}
            bound, by = C._bound_ms(C._work("K7", clips, stage,
                                            with_dp=with_dp))
            row = {"name": name, "clips": clips, "T": t, "C": c, "FF": ff,
                   "ms": ms, "launches_per_call": n_launch,
                   "device_ms_by_kernel": by_kernel,
                   "device_ms": sum(by_kernel.values()), "bound_ms": bound,
                   "bound_by": by, "matmul_ms": lib,
                   "matmul_device_ms": lib_dev}
            print(f"[mlp] {name}, {clips} clips (T = {t}): kernel "
                  f"{ms[0]:.4f} / {ms[1]:.4f} ms, device "
                  f"{row['device_ms']:.4f}"
                  f" ms in {n_launch} launches a call, by kernel "
                  + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items())
                  + f"; bound {bound:.4f} ms ({by}); torch.matmul fc1 "
                  f"{lib['fc1'][0]:.4f} (device {lib_dev['fc1']:.4f}), fc2 "
                  f"{lib['fc2'][0]:.4f} (device {lib_dev['fc2']:.4f}) ms",
                  flush=True)
            rows.append(row)
            del x, p, mlp, z, hid
            torch.cuda.empty_cache()
        for stage in (0, 1):
            d, h, w, c, heads = C.STAGES[stage]
            x = C._seeded((clips, d, h, w, c), gen)
            p = C._block_weights(c, heads, 147, gen, None)
            ctx = C._seeded((x.numel() // c, c), gen)
            bh = (ctx, x, p["proj_w"], p["proj_b"],
                  *(p[k] for k in C.MLP_KEYS), None, None, C.WINDOW,
                  C.NO_SHIFT)
            name = f"back_half stage {stage}"
            C._compare(f"{name} {clips} clips", SB.swin_back_half(*bh),
                       SB.back_half_plain(*bh))
            ms = timed(lambda: SB.swin_back_half(*bh))
            dev = sum(_device(lambda: SB.swin_back_half(*bh))[1].values())
            print(f"[mlp] {name}, {clips} clips: kernel {ms[0]:.4f} / "
                  f"{ms[1]:.4f} ms, device {dev:.4f} ms", flush=True)
            rows.append({"name": name, "clips": clips, "ms": ms,
                         "device_ms": dev})
            del x, p, ctx, bh
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "mlp_bench": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
