#!/usr/bin/env python3
"""Count the SASS instructions of one GELU as the kernels compile it.

    python3 lrce_tpu_torch/tools/gelu_sass.py

Run it from the root of the tree to be measured, on a machine with the
CUDA toolkit (nvcc and cuobjdump); no GPU is needed. It compiles, for
sm_90a at -O3, one-element kernels that include that tree's
``lrce_tpu_torch/csrc/swin_common.cuh``: ``y = x`` (the baseline: the load,
the store, the exit), ``y = x / 2 (1 + erff(x / sqrt 2))`` (libm's erf),
``y = gelu_erf(x)`` (the header's GELU, as the kernels call it) and, against
a baseline of two loads and two stores, K5's recomputed GELU with its
derivative (``csrc/mlp_bwd.cu``), and counts each one's instructions with
``cuobjdump -sass``, NOPs left out. A GELU's cost is its kernel's count
less its baseline's, in all and on the FP32 and MUFU pipes; a kernel's
GELU issue time follows as GELUs x instructions / (SMs x 128 lanes x
clock). The last line is one JSON object
with the counts.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

PROBE = r"""
#include "swin_common.cuh"
extern "C" __global__ void probe_copy(const float* x, float* y) {
  y[threadIdx.x] = x[threadIdx.x];
}
extern "C" __global__ void probe_erff(const float* x, float* y) {
  const float a = x[threadIdx.x];
  y[threadIdx.x] = a * 0.5f * (1.f + erff(a * 0.70710678118654752f));
}
extern "C" __global__ void probe_gelu(const float* x, float* y) {
  y[threadIdx.x] = lrce::gelu_erf(x[threadIdx.x]);
}
extern "C" __global__ void probe_copy2(const float* x, const float* d,
                                       float* y, float* z) {
  y[threadIdx.x] = x[threadIdx.x];
  z[threadIdx.x] = d[threadIdx.x];
}
// K5's recomputed GELU and its derivative (csrc/mlp_bwd.cu)
extern "C" __global__ void probe_gelu_bwd(const float* xp, const float* dp,
                                          float* y, float* z) {
  const float x = xp[threadIdx.x];
  const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
  const float pdf = expf(-0.5f * x * x) * 0.39894228040143268f;
  y[threadIdx.x] = x * cdf;
  z[threadIdx.x] = dp[threadIdx.x] * (cdf + x * pdf);
}
"""
# opcodes issued to the FP32 pipe (and MUFU, the special-function unit)
FP32 = ("FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "FSETP", "FCHK", "FSWZADD")


def _sass(csrc: str) -> dict:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    dump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(PROBE)
        cubin = os.path.join(tmp, "probe.cubin")
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-cubin", "-I", csrc, src, "-o",
                        cubin], check=True)
        text = subprocess.run([dump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    ops: dict = {}
    fn = None
    for line in text.splitlines():
        head = re.search(r"Function : (\w+)", line)
        if head:
            fn = head.group(1)
            ops[fn] = collections.Counter()
            continue
        ins = re.search(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if fn and ins and ins.group(1) != "NOP":
            ops[fn][ins.group(1).split(".")[0]] += 1
    return ops


def main() -> int:
    csrc = os.path.join(os.getcwd(), "lrce_tpu_torch", "csrc")
    ops = _sass(csrc)
    out = {}
    for name in ("probe_erff", "probe_gelu", "probe_gelu_bwd"):
        base = ops["probe_copy2" if name.endswith("bwd") else "probe_copy"]
        diff = ops[name] - base
        total = sum(ops[name].values()) - sum(base.values())
        fp32 = sum(v for k, v in diff.items() if k in FP32)
        mufu = diff.get("MUFU", 0)
        out[name] = {"instructions": total, "fp32": fp32, "mufu": mufu,
                     "by_opcode": dict(sorted(diff.items()))}
        print(f"[gelu_sass] {name}: {total} instructions over the baseline, "
              f"{fp32} on the FP32 pipe, {mufu} MUFU; "
              f"{dict(sorted(diff.items()))}",
              flush=True)
    print(json.dumps({"gelu_sass": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
