#!/usr/bin/env python3
"""Compare the SASS of one kernel source as two trees compile it.

    python3 lrce_tpu_torch/tools/sass_diff.py OLD_ROOT NEW_ROOT SOURCE \\
        [--pair OLD_NAME NEW_NAME ...]

OLD_ROOT and NEW_ROOT are roots of two checkouts; SOURCE a file under
``lrce_tpu_torch/csrc`` (``back_half.cu``). Each tree's copy is compiled
for sm_90a at -O3 with its own headers (``nvcc -cubin``, the flags of
``ops/cuda_lib.py``), and ``cuobjdump -sass`` lists every kernel's
instructions; the kernels are named as ``cu++filt`` demangles them, up to
the parameter list. Without ``--pair`` every kernel of both trees under one
name is compared; ``--pair`` names a kernel of each tree (a substring of
its demangled name, e.g. ``back_half_kernel<(int)128>`` and
``back_half_kernel<(int)128, (bool)1>``). Per pair: the instruction count
of each side and how many lines differ (addresses, encodings and every hex
constant left out), and the first ``--show`` of them. The last line is one
JSON object. Needs nvcc, cuobjdump and cu++filt; no GPU.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile


def _tool(name: str) -> str:
    return shutil.which(name) or f"/usr/local/cuda/bin/{name}"


def _kernels(root: str, source: str) -> dict:
    csrc = os.path.join(root, "lrce_tpu_torch", "csrc")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        subprocess.run([_tool("nvcc"), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-cubin", "-I", csrc,
                        os.path.join(csrc, source), "-o", cubin], check=True)
        text = subprocess.run([_tool("cuobjdump"), "-sass", cubin],
                              check=True, capture_output=True,
                              text=True).stdout
    out: dict = {}
    name = None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = subprocess.run([_tool("cu++filt"), head.group(1)],
                                  capture_output=True, text=True,
                                  check=True).stdout.strip().split("(C")[0]
            out[name] = []
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and ins:
            out[name].append(re.sub(r"0x[0-9a-f]+", "#", ins.group(1)))
    return out


def _find(kernels: dict, part: str) -> str:
    hits = [k for k in kernels if part in k]
    if len(hits) != 1:
        raise SystemExit(f"{part!r} names {len(hits)} of {list(kernels)}")
    return hits[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old_root")
    ap.add_argument("new_root")
    ap.add_argument("source")
    ap.add_argument("--pair", nargs=2, action="append", default=[])
    ap.add_argument("--show", type=int, default=0)
    args = ap.parse_args()
    old = _kernels(args.old_root, args.source)
    new = _kernels(args.new_root, args.source)
    pairs = ([(_find(old, a), _find(new, b)) for a, b in args.pair]
             or [(k, k) for k in old if k in new])
    rows = []
    for a, b in pairs:
        diff = [d for d in difflib.unified_diff(old[a], new[b], n=0,
                                                lineterm="")
                if d[:1] in "+-" and d[:3] not in ("+++", "---")]
        rows.append({"old": a, "new": b, "old_instructions": len(old[a]),
                     "new_instructions": len(new[b]),
                     "lines_differing": len(diff)})
        print(f"[sass_diff] {a} ({len(old[a])}) vs {b} ({len(new[b])}): "
              f"{len(diff)} lines differ", flush=True)
        for d in diff[:args.show]:
            print(f"[sass_diff]   {d}")
    print(json.dumps({"sass_diff": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
