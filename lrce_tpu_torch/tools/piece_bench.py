#!/usr/bin/env python3
"""Time the shared GEMM and K1 / K3's back half alone on one GPU.

    python -m lrce_tpu_torch.tools.piece_bench

Run it from the root of the tree to be measured: the package, this script
and that tree's ``chip_smoke.py`` (for its helpers) come from the current
directory, so a comparison runs each checkout's own copy, or the same tree
with another version of a source under ``csrc/``, in turns on one card
(each tree builds its own kernel library).

At the flagship's 48-clip train step shapes: ``ops/gemm.gemm_bf16`` in the
epilogue mode each product uses (qkv, proj, fc1, fc2 at stages 0-3, the
backward's dz read in place) beside ``torch.matmul`` of the same operands,
each held to its plain version first; then ``ops/swin_block.swin_back_half``
at stages 0 and 1, unshifted and shifted, held to ``back_half_plain``. CUDA
events, warm, 20 calls each, the library's product timed before and after
the kernel. The last line is one JSON object: ``{"name": [kernel ms,
library ms] or kernel ms}``. Fails where there is no CUDA device.
"""

from __future__ import annotations

import json
import math
import sys

import torch

# name: (M, N, K, mode); mode -1: EPI_ATTN_OUT with the weight read in place
SHAPES = {"qkv0": (451584, 384, 128, 0), "proj0": (451584, 128, 128, 2),
          "fc1_0": (451584, 512, 128, 1), "qkv1": (112896, 768, 256, 0),
          "qkv2": (28224, 1536, 512, 0), "proj2": (28224, 512, 512, 2),
          "fc1_2": (28224, 2048, 512, 1), "fc2_2": (28224, 512, 2048, 3),
          "fc2_3": (7056, 1024, 4096, 3), "dz2": (28224, 512, 2048, -1)}


def main() -> int:
    import chip_smoke as C
    from lrce_tpu_torch.ops import gemm as G
    from lrce_tpu_torch.ops import swin_block as SB

    C.phase_device()
    C.phase_build()
    gen = torch.Generator().manual_seed(0)
    res = {}
    for name, (m, n, k, mode) in SHAPES.items():
        b_kn = mode < 0
        mode = G.EPI_ATTN_OUT if b_kn else mode
        a = C._seeded((m, k), gen)
        b = C._seeded((k, n) if b_kn else (n, k), gen, 1 / math.sqrt(k))
        kw = dict(mode=mode, b_kn=b_kn)
        if not b_kn:
            kw["bias"] = 0.02 * torch.randn((n,), generator=gen).cuda()
            if mode in (G.EPI_ATTN_OUT, G.EPI_MLP_OUT):
                kw.update(dp=torch.ones(m // 1000 + 1).cuda(), dp_rows=1000,
                          res=C._seeded((m, n), gen))
        C._compare(name, G.gemm_bf16(a, b, **kw), G.gemm_bf16_plain(a, b, **kw))
        bt = b if b_kn else b.t()
        lib1, k1, k2, lib2 = (C._cuda_time_ms(f, 20) for f in (
            lambda: torch.matmul(a, bt), lambda: G.gemm_bf16(a, b, **kw),
            lambda: G.gemm_bf16(a, b, **kw), lambda: torch.matmul(a, bt)))
        res[name] = [round((k1 + k2) / 2, 4), round((lib1 + lib2) / 2, 4)]
        print(f"[piece] gemm_bf16 {name} {(m, n, k)}: kernel {res[name][0]} "
              f"ms, library {res[name][1]} ms", flush=True)
        del a, b, kw
    for stage, (d, h, w, c, heads) in enumerate(C.STAGES[:2]):
        x = C._seeded((C.TRAIN_CLIPS, d, h, w, c), gen)
        p = C._block_weights(c, heads, 147, gen, None)
        ctx = C._seeded((x.numel() // c, c), gen)
        for shift in (C.NO_SHIFT, C.SHIFT):
            bh = (ctx, x, p["proj_w"], p["proj_b"],
                  *(p[key] for key in C.MLP_KEYS), None, None, C.WINDOW, shift)
            tag = f"back_half{stage}{'_shifted' if any(shift) else ''}"
            C._compare(tag, SB.swin_back_half(*bh), SB.back_half_plain(*bh))
            res[tag] = round(C._cuda_time_ms(lambda: SB.swin_back_half(*bh), 20),
                             4)
            print(f"[piece] {tag}: {res[tag]} ms", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
