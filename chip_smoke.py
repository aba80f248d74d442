#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lrce_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):
  1. device: requires CUDA; prints the card's name and power limit as
     nvidia-smi gives them; turns TF32 off for the f32 references;
  2. build: compiles lrce_tpu_torch/csrc for sm_90a and prints the time;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     flagship shapes of the eval forward (bf16, 6 clips): max-abs and
     relative-L2 error against the stated tolerance, and kernel vs plain
     time (CUDA events, after warm-up);
  4. forward: the flagship LRCEModel (Video Swin-B, BERT-base, 12-layer
     fusion, open-ended head, random weights from a seed) on the card in
     bf16 answers 3 requests of 2 questions x 3 clips x 5 x 224 x 224 uint8
     frames with 32 tokens. Logits must be finite, (2, 1000), agree with
     the same model run on the plain route, and each request must launch
     K1 11 times, K3 11 times and K2 twice;
  5. a JSON line of kernels, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel vs plain version, bf16: the two round at the same points but sum in
# other orders, and the plain GEMMs round their product to bf16 once more
# before the bias. A few bf16 ulps (2^-8 relative each) on a small share of
# elements is the expected gap.
KERNEL_REL_L2 = 1e-2
KERNEL_MAX_ABS_REL = 2e-2       # max |kernel - plain| / max |plain|
# Whole forward, kernel route vs plain route: 24 Swin blocks, BERT and 36
# fusion layer applications in bf16 carry those differences along.
FORWARD_REL_L2 = 5e-2

N_CLIPS = 6                     # one request: 2 questions x 3 clips
STAGES = (  # (D, H, W, C, heads) per stage at 224 x 224, 5 frames
    (3, 56, 56, 128, 4), (3, 28, 28, 256, 8), (3, 14, 14, 512, 16),
    (3, 7, 7, 1024, 32))
WINDOW = (3, 7, 7)
SHIFT = (0, 3, 3)
CALLS_PER_FORWARD = {"K1": (1, 1, 9, 0), "K3": (1, 1, 9, 0),
                     "K2": (0, 0, 0, 2)}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase_device() -> str:
    require(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    return card


def phase_build():
    from lrce_tpu_torch.ops import cuda_lib

    lib = cuda_lib.library()
    print(f"[build] {lib.path.name}: nvcc {lib.build_seconds:.1f} s", flush=True)
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")
    return lib


def _block_weights(c: int, heads: int, n: int, gen: torch.Generator,
                   k: int | None):
    """Random block weights at realistic scale: unit-variance activations
    through each matrix, rel_bias of a trained model's spread."""
    lead = () if k is None else (k,)

    def mat(o, i):
        return (torch.randn(lead + (o, i), generator=gen) / math.sqrt(i)).cuda().bfloat16()

    def vec(m, scale, base=0.0):
        return (base + scale * torch.randn(lead + (m,), generator=gen)).cuda()

    ff = 4 * c
    return dict(
        ln1s=vec(c, 0.1, 1.0), ln1b=vec(c, 0.1), qkv_w=mat(3 * c, c),
        qkv_b=vec(3 * c, 0.02), proj_w=mat(c, c), proj_b=vec(c, 0.02),
        rel_bias=(torch.randn(lead + (heads, n, n), generator=gen)).cuda(),
        ln2s=vec(c, 0.1, 1.0), ln2b=vec(c, 0.1), w1=mat(ff, c),
        b1=vec(ff, 0.02), w2=mat(c, ff), b2=vec(c, 0.02))


def _cuda_time_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    require(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    max_abs = (g - w).abs().max().item()
    rel_l2 = ((g - w).norm() / w.norm()).item()
    scale = w.abs().max().item()
    ok = rel_l2 <= KERNEL_REL_L2 and max_abs <= KERNEL_MAX_ABS_REL * scale
    print(f"[kernels] {name}: max_abs {max_abs:.4g} (max|plain| {scale:.4g}, "
          f"limit {KERNEL_MAX_ABS_REL * scale:.4g}), rel_l2 {rel_l2:.3g} "
          f"(limit {KERNEL_REL_L2}) -> {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"{name}: kernel disagrees with its plain version")
    return max_abs


def phase_kernels():
    from lrce_tpu_torch.models.swin3d import compute_shift_mask
    from lrce_tpu_torch.ops import swin_block as SB
    from lrce_tpu_torch.ops import window_attn as WA

    gen = torch.Generator().manual_seed(1234)
    n = WINDOW[0] * WINDOW[1] * WINDOW[2]
    results = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
               for k in CALLS_PER_FORWARD}

    def record(kernel, stage, label, run_k, run_p, timed=True):
        err = _compare(f"{kernel} {label}", run_k(), run_p())
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)
        calls = CALLS_PER_FORWARD[kernel][stage]
        if not timed or not calls:
            return
        p1, k1, k2, p2 = (_cuda_time_ms(f) for f in (run_p, run_k, run_k, run_p))
        tk, tp = (k1 + k2) / 2, (p1 + p2) / 2
        results[kernel]["ms"] += calls * tk
        results[kernel]["plain_ms"] += calls * tp
        print(f"[kernels] {kernel} {label}: kernel {tk:.4f} ms, plain "
              f"{tp:.4f} ms per call; {calls} call(s) per forward", flush=True)

    for stage, (d, h, w, c, heads) in enumerate(STAGES):
        x = torch.randn((N_CLIPS, d, h, w, c), generator=gen).cuda().bfloat16()
        nwin = (d // WINDOW[0], h // WINDOW[1], w // WINDOW[2])
        label = f"stage {stage} {tuple(x.shape)}"
        if stage == 3:
            p = _block_weights(c, heads, n, gen, None)
            args = (x, p["ln1s"], p["ln1b"], p["qkv_w"], p["qkv_b"],
                    p["proj_w"], p["proj_b"], p["rel_bias"], None, WINDOW, heads)
            record("K2", stage, label,
                   lambda: WA.fused_window_attention_hsplit(*args),
                   lambda: WA.window_attention_plain(*args))
            continue
        mask = torch.from_numpy(compute_shift_mask((d, h, w), WINDOW, SHIFT))
        mask = mask.reshape(*nwin, n, n).cuda()
        p = _block_weights(c, heads, n, gen, None)
        k1 = (x, p["ln1s"], p["ln1b"], p["qkv_w"], p["qkv_b"], p["proj_w"],
              p["proj_b"], p["rel_bias"], None, p["ln2s"], p["ln2b"], p["w1"],
              p["b1"], p["w2"], p["b2"], None, None, WINDOW, heads)
        record("K1", stage, label, lambda: SB.fused_swin_block(*k1),
               lambda: SB.swin_block_plain(*k1))
        q = _block_weights(c, heads, n, gen, 1)
        k3 = (x, q["ln1s"], q["ln1b"], q["qkv_w"], q["qkv_b"], q["proj_w"],
              q["proj_b"], q["rel_bias"], mask, q["ln2s"], q["ln2b"], q["w1"],
              q["b1"], q["w2"], q["b2"], None, None, WINDOW, heads, (SHIFT,))
        record("K3", stage, label + " k=1", lambda: SB.fused_swin_pair(*k3),
               lambda: SB.swin_pair_plain(*k3))
        if stage == 0:
            # the rest of the contract, off the eval path: K1 with a mask
            # and drop-path multipliers, K3 with k = 2
            dp = (torch.rand((N_CLIPS, 1), generator=gen) < 0.8).float().cuda() / 0.8
            k1m = k1[:8] + (mask,) + k1[9:15] + (dp, 2.0 - dp) + k1[17:]
            record("K1", stage, label + " mask+dp", lambda: SB.fused_swin_block(*k1m),
                   lambda: SB.swin_block_plain(*k1m), timed=False)
            r = _block_weights(c, heads, n, gen, 2)
            dp2 = (torch.rand((2, N_CLIPS), generator=gen) < 0.8).float().cuda() / 0.8
            k3p = (x, r["ln1s"], r["ln1b"], r["qkv_w"], r["qkv_b"], r["proj_w"],
                   r["proj_b"], r["rel_bias"], mask, r["ln2s"], r["ln2b"],
                   r["w1"], r["b1"], r["w2"], r["b2"], dp2, dp2.flip(0),
                   WINDOW, heads, ((0, 0, 0), SHIFT))
            record("K3", stage, label + " k=2 +dp", lambda: SB.fused_swin_pair(*k3p),
                   lambda: SB.swin_pair_plain(*k3p), timed=False)
    torch.cuda.synchronize()
    return results


def phase_forward():
    from lrce_tpu_torch.models.e2e import E2EConfig, LRCEModel, e2e_forward
    from lrce_tpu_torch.ops.swin_block import fused_swin_block, fused_swin_pair
    from lrce_tpu_torch.ops.window_attn import fused_window_attention_hsplit

    wrappers = {"K1": fused_swin_block, "K3": fused_swin_pair,
                "K2": fused_window_attention_hsplit}
    per_forward = {k: sum(v) for k, v in CALLS_PER_FORWARD.items()}
    cfg = E2EConfig(num_classes=1000, temporal_scale=(3,), text_seq_len=32)
    t0 = time.perf_counter()
    model = LRCEModel(cfg, device="cuda", dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0)).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[forward] flagship model: {n_params / 1e6:.1f} M parameters, built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(7)
    requests = []
    for _ in range(3):
        clips = torch.from_numpy(rng.integers(0, 256, (2, 3, 5, 224, 224, 3),
                                              dtype=np.uint8)).cuda()
        ids = torch.from_numpy(rng.integers(1000, 30000, (2, 32))).cuda()
        mask = torch.ones((2, 32), dtype=torch.int64, device="cuda")
        mask[1, 20:] = 0
        types = torch.zeros((2, 32), dtype=torch.int64, device="cuda")
        requests.append((clips, ids, mask, types))

    def serve(label):
        outs, lat = [], []
        for req in requests:
            t = time.perf_counter()
            out = e2e_forward(model, *req)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
            outs.append(out)
        print(f"[forward] {label}: per-request latency ms "
              f"{', '.join(f'{v:.2f}' for v in lat)}", flush=True)
        return outs, lat

    e2e_forward(model, *requests[0])        # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    for wrapper in wrappers.values():
        wrapper.launches = 0
    outs, lat_kernels = serve("kernel route")
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[forward] launches over {len(requests)} requests: {launches}")
    for k, n in launches.items():
        require(n == per_forward[k] * len(requests),
                f"{k} launched {n} times, expected {per_forward[k]} per request")

    model.video_extractor.swin.use_kernels = False
    e2e_forward(model, *requests[0])
    torch.cuda.synchronize()
    refs, lat_plain = serve("plain route")
    for i, (out, ref) in enumerate(zip(outs, refs)):
        require(tuple(out.shape) == (2, 1000), f"logits shape {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), "non-finite logits")
        o, r = out.float(), ref.float()
        rel_l2 = ((o - r).norm() / r.norm()).item()
        max_abs = (o - r).abs().max().item()
        top2 = r.topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1])
        same = (o.argmax(-1) == r.argmax(-1))
        # a prediction must agree wherever the plain route's top-2 margin
        # is wider than twice the largest logit difference
        decided = margin > 2 * max_abs
        print(f"[forward] request {i}: rel_l2 {rel_l2:.4g} (limit "
              f"{FORWARD_REL_L2}), max_abs {max_abs:.4g}, argmax equal "
              f"{same.tolist()}, plain top-2 margins "
              f"{[round(v, 4) for v in margin.tolist()]}", flush=True)
        require(rel_l2 <= FORWARD_REL_L2, "kernel route disagrees with plain")
        require(bool(same[decided].all()),
                "argmax differs where the margin decides it")
    return launches, lat_kernels, lat_plain


def main() -> int:
    card = phase_device()
    lib = phase_build()
    results = phase_kernels()
    launches, lat_k, lat_p = phase_forward()
    sources = {"K1": ("lrce_tpu_torch/csrc/swin_block.cu",
                      "lrce_tpu/ops/pallas_swin_block.py:180"),
               "K3": ("lrce_tpu_torch/csrc/swin_block.cu",
                      "lrce_tpu/ops/pallas_swin_pair.py:300"),
               "K2": ("lrce_tpu_torch/csrc/window_attn.cu",
                      "lrce_tpu/ops/pallas_window_attn.py:820")}
    names = {"K1": "fused_swin_block", "K3": "fused_swin_pair",
             "K2": "fused_window_attention_hsplit"}
    kernels = [{"name": names[k], "route": "cuda", "source": sources[k][0],
                "replaces": sources[k][1], "launches": launches[k],
                "max_abs_err": results[k]["max_abs_err"],
                "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"]}
               for k in ("K1", "K3", "K2")]
    print(f"[summary] {card}; build {lib.build_seconds:.1f} s; request "
          f"latency ms kernel route {lat_k}, plain route {lat_p}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
