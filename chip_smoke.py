#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lrce_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):
  1. device: requires CUDA; prints the card's name and power limit as
     nvidia-smi gives them; turns TF32 off for the f32 references;
  2. build: compiles lrce_tpu_torch/csrc for sm_90a (one nvcc per source,
     all at once) and prints the time and, per kernel, ptxas's registers and
     spill bytes;
  2b. gemms: the two GEMMs every Swin kernel shares, on their own
     (``ops/gemm.py``), at every shape a request (6 clips) and a train step
     (48 clips) give them: the wgmma GEMM with each epilogue (qkv, proj, fc1,
     fc2, and the backward's dctx, dy, dz that read the weight in place) and
     the split-K weight-gradient GEMM (dWqkv, dWproj, dW1, dW2) against an
     f32 product of the same bf16 operands, each with its time, its bound
     and the time of the library's product of the same operands (a
     yardstick: the port never calls it), printed as one JSON line;
  2c. attn_core: the attention-forward CTA that K6, K2, K1 and K3 share, on
     its own (``ops/window_attn.window_attention_core``), against its plain
     version at stages 0-3, at 6 and at 48 clips, unmasked and (stages 0-2)
     with the shift mask; its time, its bound (qkv read, ctx written, the
     bias once a head, the mask once) and the time of the library's
     ``scaled_dot_product_attention`` on contiguous per-head operands with
     the bias (+ mask) as an additive f32 mask (a yardstick: the port never
     calls it), per call and summed over the 46 calls of a train step, as
     one JSON line; one shape outside the CTA's range (N = 392) through K6
     against plain, and a Swin stage at that window with grad mode on (the
     plain block: K4 refuses N = 392) and off (K1 / K3), its launch counts
     printed as one ``[route]`` line; and the LayerNorm (+ window gather)
     alone at every stage (``ops/gemm.ln_rows``);
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     flagship shapes (bf16), at 6 clips (one request) and at the train
     step's 48: K1, K3, K2 (forward); K6 with and without the mask at
     stages 0-2, K4 at stages 0-3, K5 at stages 0-3 (every output: dy / dz,
     each dW, db and drel); K7 at stage 3 (C = 1024) with and without dp2,
     and again at 3 clips (T = 441: a row tail past the 128-row tile, an
     odd sample count); K8 at stage 0 (C = 128) and at C = 256 without
     autograd. K7 and K8 must launch one kernel a call (torch.profiler)
     and give the same bits on a second call; the library's fc1 + fc2
     (two ``torch.matmul``) is printed beside them. Max-abs and relative-L2
     error against the stated tolerance; kernel and plain time (CUDA
     events, after warm-up, order plain-kernel-kernel-plain) beside the
     kernel's bound, the least time the card could take for the call, and
     each kernel's sums over the calls of one step at 6 and at 48 clips. Then
     the K1, K3, K2 and K7 autograd.Functions' gradients against torch
     autograd through their plain versions, one block per stage, at 6 and
     at 48 clips. K1 / K3's one-launch back half (``swin_back_half``) alone
     at stages 0-1, unshifted and shifted, against its plain version. Then
     K1, K3, K6 and K2 by piece: each per-call time beside the times of its
     pieces taken alone above (LN1 + gather, qkv, the CTA, and the back half
     at stages 0-1 or proj, LN2, fc1, fc2 at stage 2), the library's product
     for each GEMM, and the remainder, as one JSON line;
  4. forward: the flagship LRCEModel (Video Swin-B, BERT-base, 12-layer
     fusion, open-ended head, random weights from a seed) on the card in
     bf16 answers 3 requests of 2 questions x 3 clips x 5 x 224 x 224 uint8
     frames with 32 tokens. Logits must be finite, (2, 1000), agree with
     the same model run on the plain route, and each request must launch
     K1 11 times, K3 11 times, K2 twice and the back half 4 times (K1 and
     K3 at stages 0-1). Then the same requests with the
     stage-3 MLP routed through K7 (``ln_mlp=True``): K7 twice per request,
     logits within the same limit of the plain route, the request time with
     the route on and off taken in turns. Then K8 through its own entry
     point, ``fused_mlp``, on each request's patch-embedded clips with the
     first block's weights, against the model's own LN2 + MLP + residual;
  5. train: the flagship with f32 parameters and bf16 compute, AgentOE with
     the config defaults (lr 5e-6 for all three groups, reg 0.001),
     dropout 0.1 and drop-path 0.2 from a seeded generator, takes a warm-up
     step and 2 steps at 16 questions x 3 clips (48 clips) of uint8 frames.
     Every step: a finite loss, parameters of all three groups changed, and
     the launches K1 11, K3 11, K2 2 (forward), K6 22, K5 22, K4 24
     (backward). Prints the step ms and the peak device memory;
  6. training run: the same flagship with ``ln_mlp=True`` through the entry
     a user of the trainer calls: an in-memory dataset made from a seed (64
     train and 16 validation items of 3 x 5 x 224 x 224 x 3 uint8 clips, 32
     token ids, a label), ``DataLoader`` -> ``device_prefetch`` ->
     ``AgentOE.do_training`` for one epoch of 4 steps at 16 questions, a
     validation mid-epoch and one at its end, checkpoints from the writer
     thread into a temporary directory. Requires finite losses; per train
     step K1 11, K3 11, K2 2, K7 2, K6 22, K5 24, K4 24 launches (per
     validation step the forward four); ``best.pt`` and the epoch's
     checkpoint on disk and no ``.tmp``; and that a fresh model loading
     ``best.pt`` reproduces, through ``do_evaluation``, the validation loss
     and metric recorded when it was saved (1e-6 relative);
  7. route parity: one forward + backward at 2 questions, dropout and
     drop-path off, the same weights and batch, on the kernel route (with
     ``ln_mlp=True``: K7 and its backward at stage 3) and on the plain
     route: loss and per-group gradient relative L2 (each Swin
     stage, BERT, the fusion) against the stated limit;
  8. a JSON line of kernels, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

In the kernels line, ms / plain_ms / bound_ms are sums over the calls one
6-clip request (K1, K3, K2, K7; one call for K8) or the backward of one
6-clip step (K6, K5, K4) makes; ``clips48`` holds the same three sums over
the calls of one 48-clip train step. bound_ms is the larger of the call's
operations over 989 TFLOP/s (dense bf16) and its bytes (each input read
once, each output written once) over 3.35 TB/s, the H100 SXM's published
peaks. library_ms is null: no single PyTorch call computes any of these
fused functions.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Kernel vs plain version, bf16: the two round at the same points but sum in
# other orders, so a value near a bf16 rounding boundary rounds the other
# way now and then. A few bf16 ulps (2^-8 relative each) on a small share of
# elements is the expected gap; the backward kernels' f32 outputs (dW, db,
# drel) sum products of such bf16 operands and sit inside the same limits.
KERNEL_REL_L2 = 1e-2
KERNEL_MAX_ABS_REL = 2e-2       # max |kernel - plain| / max |plain|
# The autograd.Functions' gradients against autograd through the plain
# versions: the custom backward rounds at the JAX kernels' points (dctx,
# pb, dS, dq/dk/dv, dpre, the recomputed h1), which autograd through the
# plain forward does not, and a weight gradient sums ~10^5 such products.
GRAD_REL_L2 = 3e-2
GRAD_MAX_ABS_REL = 6e-2
# Whole forward, kernel route vs plain route: 24 Swin blocks, BERT and 36
# fusion layer applications in bf16 carry those differences along.
FORWARD_REL_L2 = 5e-2
# Whole backward, kernel route vs plain route, gradients per group: each
# bf16 rounding is 2^-8 = 3.9e-3 relative, and a Swin stage-0 gradient
# passes back through the fusion (36 layer applications), Swin's 24 blocks
# and their residual streams, each route rounding at its own points (the
# kernel route at the JAX kernels' points, the plain route where autograd
# casts). Independent roundings over ~100 such ops grow like sqrt(100) x
# 3.9e-3 = 3.9e-2; the limit allows 2.5x that.
TRAIN_GRAD_REL_L2 = 1e-1
TRAIN_LOSS_REL = 1e-2

N_CLIPS = 6                     # one request: 2 questions x 3 clips
STAGES = (  # (D, H, W, C, heads) per stage at 224 x 224, 5 frames
    (3, 56, 56, 128, 4), (3, 28, 28, 256, 8), (3, 14, 14, 512, 16),
    (3, 7, 7, 1024, 32))
WINDOW = (3, 7, 7)
SHIFT = (0, 3, 3)
NO_SHIFT = (0, 0, 0)
CALLS_PER_FORWARD = {"K1": (1, 1, 9, 0), "K3": (1, 1, 9, 0),
                     "K2": (0, 0, 0, 2),
                     # K1 / K3's one-launch back half, at stages 0-1
                     "back_half": (2, 2, 0, 0)}
# backward of one train step: K6 and K5 once per K1/K3 block, K4 once per
# block of every stage (K2's backward included); K6 and K4 run half their
# calls with the mask (the shifted blocks)
CALLS_PER_BACKWARD = {"K6": (2, 2, 18, 0), "K5": (2, 2, 18, 0),
                      "K4": (2, 2, 18, 2)}
# with the stage-3 MLP routed through K7 (ln_mlp=True): K7 once per stage-3
# block forward, and K5 is its backward too
LN_MLP_FORWARD = {**CALLS_PER_FORWARD, "K7": (0, 0, 0, 2)}
LN_MLP_BACKWARD = {**CALLS_PER_BACKWARD, "K5": (2, 2, 18, 2)}
TRAIN_BATCH = 16                # questions per step (tools/train_bench.py)
TRAIN_CLIPS = TRAIN_BATCH * 3   # the Swin batch of a train step
TRAIN_STEPS = 2
RUN_TRAIN_ITEMS, RUN_VAL_ITEMS = 64, 16     # the training run's dataset
KERNEL_ORDER = ("K1", "K3", "K2", "K7", "K8", "K6", "K5", "K4")
PEAK_BF16_FLOPS = 989e12        # H100 SXM, dense
PEAK_BYTES_PER_S = 3.35e12
EVAL_REPRODUCE_REL = 1e-6


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
    # the host cost of a TMA tensor map (a GEMM call encodes two, K1 / K3's
    # back half four, each cached by pointer and shape)
    import ctypes
    from lrce_tpu_torch.ops.cuda_lib import check
    ns = ctypes.c_double()
    check("lrce_tmap_encode_ns",
          lib.lib.lrce_tmap_encode_ns(2000, ctypes.addressof(ns)))
    print(f"[build] TMA tensor-map encode: {ns.value:.1f} ns on the host "
          "each (2000 encodes)", flush=True)
    # ptxas -v: "Compiling entry function '<mangled>'", then its spill
    # bytes, then its registers; a spilled wgmma accumulator shows here
    name = None
    spills = ""
    for line in lib.build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel = re.search(r"(?<=\d)[a-z][a-z_]*_kernel", entry.group(1))
            name = kernel.group(0) if kernel else entry.group(1)[:60]
            targs = re.findall(r"L[ib](\d+)E", entry.group(1).split(name)[-1]
                               .split("Ev")[0])
            name += f"<{','.join(targs)}>" if targs else ""
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and name:
            used = re.search(r"Used (\d+) registers", line)
            print(f"[build]   {name}: {used.group(1) if used else '?'} "
                  f"registers; {spills}")
            name = None
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


ATTN_KEYS = ("ln1s", "ln1b", "qkv_w", "qkv_b", "proj_w", "proj_b", "rel_bias")
MLP_KEYS = ("ln2s", "ln2b", "w1", "b1", "w2", "b2")


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


def _compare(name: str, got: torch.Tensor, want: torch.Tensor,
             rel_limit: float = KERNEL_REL_L2,
             max_limit: float = KERNEL_MAX_ABS_REL) -> float:
    g, w = got.float(), want.float()
    require(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    max_abs = (g - w).abs().max().item()
    rel_l2 = ((g - w).norm() / w.norm()).item()
    scale = w.abs().max().item()
    ok = rel_l2 <= rel_limit and max_abs <= max_limit * scale
    print(f"[kernels] {name}: max_abs {max_abs:.4g} (max|plain| {scale:.4g}, "
          f"limit {max_limit * scale:.4g}), rel_l2 {rel_l2:.3g} "
          f"(limit {rel_limit}) -> {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"{name}: kernel disagrees with its plain version")
    return max_abs


def _work(kernel: str, clips: int, stage: int, masked: bool = False,
          with_dp: bool = False):
    """(operations, bytes) of one call at a flagship stage: every matrix
    product at 2 m n k, each input read once and each output written once
    (bf16 activations and matrices, f32 LN parameters, biases, rel_bias,
    mask, dp and weight gradients)."""
    d, h, w, c, heads = STAGES[stage]
    n = WINDOW[0] * WINDOW[1] * WINDOW[2]
    t = clips * d * h * w
    ff = 4 * c
    act = t * c * 2
    rel = heads * n * n * 4
    mask = (d // WINDOW[0]) * (h // WINDOW[1]) * (w // WINDOW[2]) * n * n * 4 \
        if masked else 0
    attn_w = 4 * c * c * 2 + (3 * c + c + 2 * c) * 4    # qkv, proj, biases, LN1
    mlp_w = 2 * c * ff * 2 + (2 * c + ff + c) * 4       # fc1, fc2, LN2, biases
    dp = clips * 4 if with_dp else 0
    attn_ops = t * (8 * c * c + 4 * n * c)      # qkv, q k^T, p v, proj
    mlp_ops = 4 * t * c * ff                    # fc1, fc2
    if kernel in ("K1", "K3"):
        return (attn_ops + mlp_ops,
                2 * act + attn_w + mlp_w + rel + mask + 2 * dp)
    if kernel in ("K2", "K6"):
        return attn_ops, 2 * act + attn_w + rel + mask
    if kernel in ("K7", "K8"):
        return mlp_ops, 2 * act + mlp_w + dp
    if kernel == "K5":
        # fc1 again, dhid, dW2, dW1, dz; in: h1, g, w1, w2; out: dz, dW1,
        # db1, dW2 (f32)
        return (10 * t * c * ff,
                3 * act + mlp_w + dp + 2 * c * ff * 4 + ff * 4)
    if kernel == "K4":
        # qkv again, q k^T, p v, dctx, dWproj, dP, dV, dq, dk, dWqkv, dy
        return (t * (22 * c * c + 12 * n * c),
                3 * act + attn_w + rel + mask + 4 * c * c * 4 + 3 * c * 4
                + rel)
    raise KeyError(kernel)


def _bound_ms(work):
    ops_ms = work[0] / PEAK_BF16_FLOPS * 1e3
    bytes_ms = work[1] / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def _seeded(shape, gen, scale=1.0):
    return (scale * torch.randn(shape, generator=gen)).cuda().bfloat16()


def _one_launch_repeat(name: str, run) -> None:
    """A wrapper call launches one kernel (torch.profiler), and a second
    call on the same inputs equals the first bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        first = run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            again = run()
            torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"[kernels] {name}: {len(kernels)} kernel launch(es) a call "
          f"{sorted(set(k[:60] for k in kernels))}, repeat bit-identical "
          f"{torch.equal(first, again)}", flush=True)
    require(len(kernels) == 1, f"{name}: {len(kernels)} launches a call")
    require(torch.equal(first, again), f"{name}: a second launch differs")


def _matmul_yardstick(name: str, t: int, c: int, ff: int, gen) -> float:
    """fc1 + fc2 of an MLP as two ``torch.matmul`` calls at (T, C, FF): a
    yardstick printed beside K7 / K8 (the port never calls it)."""
    z, hid = _seeded((t, c), gen), _seeded((t, ff), gen)
    w1, w2 = _seeded((ff, c), gen), _seeded((c, ff), gen)
    ms = (_cuda_time_ms(lambda: torch.matmul(z, w1.t()))
          + _cuda_time_ms(lambda: torch.matmul(hid, w2.t())))
    print(f"[kernels] {name}: torch.matmul fc1 + fc2 at T = {t}, C = {c}, "
          f"FF = {ff}: {ms:.4f} ms (yardstick)", flush=True)
    return ms


GEMM_REL_L2_F32 = 1e-4     # split-K GEMM, f32 out: only the sum's order differs
# calls per block of a train step, (stages 0-2, stage 3): qkv runs in the
# forward, K6's recompute and K4's; proj in the forward and K6; K6 does not
# run at stage 3
GEMM_CALLS = {"qkv": (3, 2), "proj": (2, 1), "fc1": (1, 1), "fc2": (1, 1),
              "dctx": (1, 1), "dy": (1, 1), "dz": (1, 1), "dWqkv": (1, 1),
              "dWproj": (1, 1), "dW1": (1, 1), "dW2": (1, 1)}
BLOCKS = (2, 2, 18, 2)


def phase_gemms():
    """The shared wgmma GEMM and the split-K GEMM alone, at every shape of a
    request and of a train step, against f32 products of the same operands."""
    from lrce_tpu_torch.ops import gemm as G

    gen = torch.Generator().manual_seed(99)
    n_win = WINDOW[0] * WINDOW[1] * WINDOW[2]
    rows = []
    for clips in (N_CLIPS, TRAIN_CLIPS):
        iters = 2 if clips == N_CLIPS else 4
        for stage, (d, h, w, c, _) in enumerate(STAGES):
            t = clips * d * h * w
            ff = 4 * c
            dp = (torch.rand((clips,), generator=gen) < 0.8).float().cuda() / 0.8
            dp_rows = d * h * w
            # name: (M, N, K, mode, b_kn, epilogue arguments)
            nt = {"qkv": (3 * c, c, G.EPI_BIAS, False, "b"),
                  "proj": (c, c, G.EPI_ATTN_OUT, False, "bdr"),
                  "fc1": (ff, c, G.EPI_BIAS_GELU, False, "b"),
                  "fc2": (c, ff, G.EPI_MLP_OUT, False, "bdr"),
                  "dctx": (c, c, G.EPI_ATTN_OUT, True, ""),
                  "dy": (c, 3 * c, G.EPI_ATTN_OUT, True, ""),
                  "dz": (c, ff, G.EPI_ATTN_OUT, True, "")}
            for name, (n, k, mode, b_kn, epi) in nt.items():
                a = _seeded((t, k), gen)
                b = _seeded((k, n) if b_kn else (n, k), gen, 1 / math.sqrt(k))
                kw = dict(mode=mode, b_kn=b_kn)
                if "b" in epi:
                    kw["bias"] = 0.02 * torch.randn((n,), generator=gen).cuda()
                if "d" in epi:
                    kw.update(dp=dp, dp_rows=dp_rows)
                if "r" in epi:
                    kw["res"] = _seeded((t, n), gen)
                got = G.gemm_bf16(a, b, **kw)
                err = _compare(f"gemm {name} stage {stage} ({t}, {n}, {k})",
                               got, G.gemm_bf16_plain(a, b, **kw))
                del got
                bt = b if b_kn else b.t()
                lib, k1, k2, lib2 = (_cuda_time_ms(f, iters) for f in (
                    lambda: torch.matmul(a, bt),
                    lambda: G.gemm_bf16(a, b, **kw),
                    lambda: G.gemm_bf16(a, b, **kw),
                    lambda: torch.matmul(a, bt)))
                nbytes = 2 * (t * k + n * k + t * n * (2 if "r" in epi else 1))
                rows.append((name, clips, stage, (t, n, k), err, (k1 + k2) / 2,
                             (lib + lib2) / 2, (2 * t * n * k, nbytes)))
                del a, b, kw
            tn = {"dWqkv": (3 * c, c), "dWproj": (c, c), "dW1": (ff, c),
                  "dW2": (c, ff)}
            for name, (n, k) in tn.items():
                g, a = _seeded((t, n), gen), _seeded((t, k), gen)
                err = _compare(f"gemm_tn {name} stage {stage} ({t}, {n}, {k})",
                               G.gemm_tn(g, a), G.gemm_tn_plain(g, a),
                               GEMM_REL_L2_F32, GEMM_REL_L2_F32)
                lib, k1, k2, lib2 = (_cuda_time_ms(f, iters) for f in (
                    lambda: torch.mm(g.t(), a, out_dtype=torch.float32),
                    lambda: G.gemm_tn(g, a), lambda: G.gemm_tn(g, a),
                    lambda: torch.mm(g.t(), a, out_dtype=torch.float32)))
                rows.append((name, clips, stage, (t, n, k), err, (k1 + k2) / 2,
                             (lib + lib2) / 2,
                             (2 * t * n * k, 2 * t * (n + k) + 4 * n * k)))
                del g, a
            torch.cuda.empty_cache()
    require(G.gemm_bf16.launches > 0 and G.gemm_tn.launches > 0,
            "the GEMM wrappers launched nothing")
    out = []
    sums = {}
    for name, clips, stage, shape, err, ms, lib, work in rows:
        bound, by = _bound_ms(work)
        calls = BLOCKS[stage] * GEMM_CALLS[name][stage == 3]
        print(f"[gemms] {name} stage {stage}, {clips} clips, (M, N, K) "
              f"{shape}: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"library {lib:.4f} ms; {calls} call(s) a step", flush=True)
        tot = sums.setdefault(("gemm_tn" if name.startswith("dW") else
                               "gemm_bf16", clips), [0.0, 0.0, 0.0])
        for i, v in enumerate((ms, bound, lib)):
            tot[i] += calls * v
        out.append({"name": name, "clips": clips, "stage": stage,
                    "shape": list(shape), "max_abs_err": err, "ms": ms,
                    "bound_ms": bound, "bound_by": by, "library_ms": lib,
                    "calls_per_step": calls})
    for (kind, clips), (ms, bound, lib) in sums.items():
        print(f"[gemms] {kind}, the calls of one train step at {clips} clips: "
              f"kernel {ms:.4f} ms, bound {bound:.4f} ms, library {lib:.4f} ms",
              flush=True)
    print(json.dumps({"gemms": out}), flush=True)
    return out


# the attention-forward CTA's calls in one train step, per stage: once per
# block in the forward (K1, K3, K2) and once more in K6's recompute at stages
# 0-2; half of them (the shifted blocks) with the mask at stages 0-2
ATTN_CORE_CALLS = (4, 4, 36, 2)


def phase_attn_core():
    """The attention-forward CTA alone against its plain version, timed
    between two timings of the library's attention; the LayerNorm alone."""
    import torch.nn.functional as F

    from lrce_tpu_torch.models.swin3d import compute_shift_mask
    from lrce_tpu_torch.ops import gemm as G
    from lrce_tpu_torch.ops import window_attn as WA

    gen = torch.Generator().manual_seed(77)
    n = WINDOW[0] * WINDOW[1] * WINDOW[2]
    rows, ln_ms = [], {}
    for clips in (N_CLIPS, TRAIN_CLIPS):
        iters = 5 if clips == N_CLIPS else 10
        for stage, (d, h, w, c, heads) in enumerate(STAGES):
            nwin_clip = (d // WINDOW[0]) * (h // WINDOW[1]) * (w // WINDOW[2])
            nwin = clips * nwin_clip
            t, hd = nwin * n, c // heads
            qkv = _seeded((nwin, n, 3 * c), gen)
            rel = torch.randn((heads, n, n), generator=gen).cuda()
            # the library's operands: contiguous (windows, heads, N, hd)
            q, k, v = (a.contiguous() for a in qkv.reshape(
                nwin, n, 3, heads, hd).permute(2, 0, 3, 1, 4))
            for masked in ((False, True) if stage < 3 else (False,)):
                mask = None
                lq, lk, lv, add = q, k, v, rel[None]
                if masked:
                    mask = torch.from_numpy(compute_shift_mask(
                        (d, h, w), WINDOW, SHIFT)).cuda()
                    # one additive mask per (window of a clip, head): the
                    # clips become the batch, the windows join the heads
                    lq, lk, lv = (a.reshape(clips, nwin_clip * heads, n, hd)
                                  for a in (q, k, v))
                    add = (rel[None] + mask[:, None]).reshape(
                        1, nwin_clip * heads, n, n)
                label = (f"attn_core stage {stage}, {clips} clips, "
                         f"{'masked' if masked else 'unmasked'} ({nwin} "
                         f"windows x {heads} heads, N {n}, head_dim {hd})")
                got = WA.window_attention_core(qkv, rel, mask, heads)
                err = _compare(label, got, WA.window_attention_core_plain(
                    qkv, rel, mask, heads))
                del got

                def run_lib():
                    return F.scaled_dot_product_attention(lq, lk, lv,
                                                          attn_mask=add)

                def run_k():
                    return WA.window_attention_core(qkv, rel, mask, heads)

                lib, k1, k2, lib2 = (_cuda_time_ms(f, iters) for f in (
                    run_lib, run_k, run_k, run_lib))
                work = (4 * t * n * c, 2 * t * 4 * c + heads * n * n * 4
                        + (nwin_clip * n * n * 4 if masked else 0))
                calls = ATTN_CORE_CALLS[stage] // (2 if stage < 3 else 1)
                rows.append((clips, stage, masked, err, (k1 + k2) / 2,
                             (lib + lib2) / 2, work, calls))
                del mask, add, lq, lk, lv
            del qkv, q, k, v
            # LN1 + gather (unshifted, shifted) and LN2 of a block, alone
            x = _seeded((clips, d, h, w, c), gen)
            gam = 1.0 + 0.1 * torch.randn((c,), generator=gen).cuda()
            bet = 0.1 * torch.randn((c,), generator=gen).cuda()
            for kind, kw in (("ln1", dict(window=WINDOW, gather=True)),
                             ("ln1_shift", dict(window=WINDOW, shift=SHIFT,
                                                gather=True)),
                             ("ln2", dict())):
                _compare(f"ln_rows {kind} stage {stage}, {clips} clips",
                         G.ln_rows(x, gam, bet, **kw),
                         G.ln_rows_plain(x, gam, bet, **kw))
                ln_ms[(clips, stage, kind)] = _cuda_time_ms(
                    lambda: G.ln_rows(x, gam, bet, **kw), iters)
            del x
            torch.cuda.empty_cache()
    require(WA.window_attention_core.launches > 0 and G.ln_rows.launches > 0,
            "the attention CTA's or the LayerNorm's wrapper launched nothing")
    out, sums = [], {}
    for clips, stage, masked, err, ms, lib, work, calls in rows:
        bound, by = _bound_ms(work)
        print(f"[attn_core] stage {stage}, {clips} clips, "
              f"{'masked' if masked else 'unmasked'}: kernel {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}: {work[0] / 1e9:.3f} GFLOP, "
              f"{work[1] / 1e6:.3f} MB), library {lib:.4f} ms; {calls} call(s) "
              "a step", flush=True)
        tot = sums.setdefault(clips, [0.0, 0.0, 0.0])
        for i, val in enumerate((ms, bound, lib)):
            tot[i] += calls * val
        out.append({"clips": clips, "stage": stage, "masked": masked,
                    "max_abs_err": err, "ms": ms, "bound_ms": bound,
                    "bound_by": by, "library_ms": lib,
                    "calls_per_step": calls})
    for clips, (ms, bound, lib) in sums.items():
        print(f"[attn_core] the {sum(ATTN_CORE_CALLS)} calls of one train step "
              f"at {clips} clips: kernel {ms:.4f} ms, bound {bound:.4f} ms, "
              f"library {lib:.4f} ms", flush=True)
    for (clips, stage, kind), ms in ln_ms.items():
        print(f"[attn_core] ln_rows {kind} stage {stage}, {clips} clips: "
              f"{ms:.4f} ms", flush=True)

    # a shape outside the CTA's range: a 16-frame clip's window (8, 7, 7),
    # N = 392, through K6; the launcher's shape rule takes the WMMA CTA
    window, shift, c, heads = (8, 7, 7), (4, 3, 3), 128, 4
    n_big = window[0] * window[1] * window[2]
    x = _seeded((2, 8, 14, 14, c), gen)
    p = _block_weights(c, heads, n_big, gen, None)
    mask = torch.from_numpy(compute_shift_mask((8, 14, 14), window, shift))
    k6 = (x, *(p[k] for k in ATTN_KEYS), mask.reshape(1, 2, 2, n_big,
                                                      n_big).cuda(),
          window, heads, 1e-5, shift)
    _compare(f"K6 beyond the CTA's range, window {window} (N {n_big})",
             WA.fused_window_attention(*k6), WA.window_attention_plain(*k6))
    # the same geometry through a Swin stage: with grad mode on it trains on
    # the plain block (K4 refuses N = 392), with it off it runs the kernels
    from lrce_tpu_torch.models.swin3d import (BasicLayer, DeviceConstants,
                                              SwinConfig)

    layer = BasicLayer(c, 2, heads, SwinConfig(window_size=window), False,
                       torch.bfloat16, torch.Generator().manual_seed(3)).cuda()
    xs = x.detach().requires_grad_()
    _reset_counts()
    layer(xs, True, DeviceConstants()).float().sum().backward()
    with_grad = _counts()
    _reset_counts()
    with torch.no_grad():
        layer(x, True, DeviceConstants())
    without = _counts()
    print(f"[route] window {window} (N {n_big}), head_dim {c // heads}: K4 "
          f"takes it {WA.attn_bwd_supported(n_big, c // heads)}; launches, "
          f"forward + backward with grad {with_grad}, forward without grad "
          f"{without}", flush=True)
    require(all(v == 0 for v in with_grad.values()) and xs.grad is not None,
            "a stage at N = 392 launched a kernel with grad mode on")
    require(without["K1"] == 1 and without["K3"] == 1,
            "a stage at N = 392 did not run K1 / K3 without grad")
    del layer, xs
    print(json.dumps({"attn_core": out}), flush=True)
    return out, ln_ms


def phase_by_piece(gemms, attn_rows, ln_ms, call_ms, back_half_ms):
    """K1, K3, K6 and K2 per call beside the times of their pieces taken
    alone (the GEMMs by phase_gemms, the CTA and the LayerNorms by
    phase_attn_core, K1 / K3's one-launch back half at stages 0-1 by
    phase_kernels): what is left over is launch gaps, the wrapper's
    allocations and, for K6 and K2, the cheaper proj epilogue (the proj timed
    alone is K1's, with dp1 and the residual)."""
    gemm = {(g["name"], g["clips"], g["stage"]): g for g in gemms}
    cta = {(a["clips"], a["stage"], a["masked"]): a["ms"] for a in attn_rows}
    out = []
    for (kernel, clips, stage, masked), total in sorted(call_ms.items()):
        fused = (kernel in ("K1", "K3")
                 and (clips, stage, masked) in back_half_ms)
        names = ["qkv"] + ([] if fused else ["proj"]) + (
            ["fc1", "fc2"] if kernel in ("K1", "K3") and not fused else [])
        pieces = {"ln1_gather": ln_ms[(clips, stage,
                                       "ln1_shift" if masked else "ln1")],
                  "cta": cta[(clips, stage, masked)]}
        if fused:
            pieces["back_half"] = back_half_ms[(clips, stage, masked)]
        elif kernel in ("K1", "K3"):
            pieces["ln2"] = ln_ms[(clips, stage, "ln2")]
        for name in names:
            pieces[name] = gemm[(name, clips, stage)]["ms"]
        library = {name: gemm[(name, clips, stage)]["library_ms"]
                   for name in names}
        rest = total - sum(pieces.values())
        print(f"[by_piece] {kernel} stage {stage}, {clips} clips, "
              f"{'masked' if masked else 'unmasked'}: {total:.4f} ms = "
              + " + ".join(f"{k} {v:.4f}" for k, v in pieces.items())
              + f" + remainder {rest:.4f}; library products "
              + ", ".join(f"{k} {v:.4f}" for k, v in library.items()),
              flush=True)
        out.append({"kernel": kernel, "clips": clips, "stage": stage,
                    "masked": masked, "ms": total, "pieces": pieces,
                    "remainder_ms": rest, "library_ms": library})
    print(json.dumps({"by_piece": out}), flush=True)
    return out


def phase_kernels():
    from lrce_tpu_torch.models.swin3d import compute_shift_mask
    from lrce_tpu_torch.ops import swin_block as SB
    from lrce_tpu_torch.ops import window_attn as WA

    gen = torch.Generator().manual_seed(1234)
    n = WINDOW[0] * WINDOW[1] * WINDOW[2]
    from lrce_tpu_torch.ops import mlp as M

    def totals():
        return {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                    "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
                    "gflop": 0.0, "mb": 0.0} for k in KERNEL_ORDER}

    # sums over the calls of one request or backward at 6 clips (the kernels
    # line) and of one train step at 48 clips
    by_clips = {N_CLIPS: totals(), TRAIN_CLIPS: totals()}
    per_call = []

    call_ms = {}    # (kernel, clips, stage, masked) -> per-call kernel ms
    back_half_ms = {}   # (clips, stage, shifted) -> the back half alone

    def record(kernel, calls, label, run_k, run_p, work, timed=None,
               piece_key=None):
        """Compare every output; time when ``timed`` (default: when a step
        at this clip count makes ``calls`` > 0 calls, which go into its
        totals). work: the call's (operations, bytes), for its bound.
        piece_key: (stage, masked) of a call that phase_by_piece splits."""
        results = by_clips[clips]
        got, want = run_k(), run_p()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        for i, (a, b) in enumerate(zip(got, want)):
            err = _compare(f"{kernel} {label} out{i}", a, b)
            results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"],
                                                 err)
        del got, want
        if not (bool(calls) if timed is None else timed):
            return
        # fewer timed iterations at 6 clips and for the plain versions
        it_k, it_p = (10, 5) if train_shape else (4, 4)
        p1, k1, k2, p2 = (_cuda_time_ms(f, it) for f, it in (
            (run_p, it_p), (run_k, it_k), (run_k, it_k), (run_p, it_p)))
        tk, tp = (k1 + k2) / 2, (p1 + p2) / 2
        bound, by = _bound_ms(work)
        r = results[kernel]
        r["ms"] += calls * tk
        r["plain_ms"] += calls * tp
        r["bound_ms"] += calls * bound
        r["ops_ms"] += calls * work[0] / PEAK_BF16_FLOPS * 1e3
        r["bytes_ms"] += calls * work[1] / PEAK_BYTES_PER_S * 1e3
        r["gflop"] += calls * work[0] / 1e9
        r["mb"] += calls * work[1] / 1e6
        per_call.append((kernel, label, tk, tp, calls, bound))
        if piece_key is not None:
            call_ms[(kernel, clips, *piece_key)] = tk
        where = (f"{calls} call(s) per forward or backward of a {clips}-clip "
                 "step" if calls else "outside the step's totals")
        print(f"[kernels] {kernel} {label}: kernel {tk:.4f} ms, plain "
              f"{tp:.4f} ms, bound {bound:.4f} ms ({by}: "
              f"{work[0] / 1e9:.3f} GFLOP, {work[1] / 1e6:.3f} MB) per call; "
              f"{where}", flush=True)

    # 6 clips (one request), then the train step's own shape, 48 clips
    # (T = 451,584 tokens at stage 0): every kernel held to its plain
    # version, timed per call and summed over the calls of a step.
    for clips in (N_CLIPS, TRAIN_CLIPS):
        train_shape = clips != N_CLIPS
        for stage, (d, h, w, c, heads) in enumerate(STAGES):
            x = _seeded((clips, d, h, w, c), gen)
            g = _seeded((clips, d, h, w, c), gen)
            nwin = (d // WINDOW[0], h // WINDOW[1], w // WINDOW[2])
            label = f"stage {stage} {tuple(x.shape)}"
            p = _block_weights(c, heads, n, gen, None)
            attn = [p[k] for k in ATTN_KEYS]
            bwd = [p[k] for k in ("ln1s", "ln1b", "qkv_w", "qkv_b", "proj_w",
                                  "rel_bias")]
            dp = (torch.rand((clips,), generator=gen) < 0.8).float().cuda() / 0.8
            mlp = [p[k] for k in MLP_KEYS]
            if stage == 3:
                args = (x, *attn, None, WINDOW, heads)
                record("K2", CALLS_PER_FORWARD["K2"][stage], label,
                       lambda: WA.fused_window_attention_hsplit(*args),
                       lambda: WA.window_attention_plain(*args),
                       _work("K2", clips, stage), timed=True,
                       piece_key=(stage, False))
                k4 = (x, g, *bwd, None, WINDOW, heads, 1e-5, NO_SHIFT)
                record("K4", CALLS_PER_BACKWARD["K4"][stage],
                       label, lambda: WA.window_attention_bwd(*k4),
                       lambda: WA.window_attention_bwd_plain(*k4),
                       _work("K4", clips, stage), timed=True)
                # K7: without dp2 and without autograd, as a request runs
                # it; with dp2 through the autograd.Function, as a train
                # step does. K5 at C = 1024 is its backward.
                for with_dp in (False, True):
                    k7 = (x, *mlp, dp if with_dp else None, 1e-5)

                    def run_k7():
                        if with_dp:
                            return SB.fused_ln_mlp(*k7)
                        with torch.no_grad():
                            return SB.fused_ln_mlp(*k7)

                    record("K7", LN_MLP_FORWARD["K7"][stage]
                           if with_dp == train_shape else 0,
                           label + (" dp2" if with_dp else " no dp2"), run_k7,
                           lambda: SB.ln_mlp_plain(*k7),
                           _work("K7", clips, stage, with_dp=with_dp),
                           timed=True)
                    _one_launch_repeat(f"K7 {label} "
                                       + ("dp2" if with_dp else "no dp2"),
                                       run_k7)
                _matmul_yardstick(f"K7 {label}", x.numel() // c, c, 4 * c,
                                  gen)
                k5 = (x, g, *mlp[:5], dp, 1e-5)
                record("K5", LN_MLP_BACKWARD["K5"][stage],
                       label + " dp2", lambda: SB.mlp_bwd(*k5),
                       lambda: SB.mlp_bwd_plain(*k5),
                       _work("K5", clips, stage, with_dp=True), timed=True)
                del x, g
                continue
            mask = torch.from_numpy(compute_shift_mask((d, h, w), WINDOW,
                                                       SHIFT))
            mask = mask.reshape(*nwin, n, n).cuda()
            half = CALLS_PER_FORWARD["K1"][stage]     # blocks of each kind
            k1 = (x, *attn, None, *mlp, None, None, WINDOW, heads)
            record("K1", half, label,
                   lambda: SB.fused_swin_block(*k1),
                   lambda: SB.swin_block_plain(*k1),
                   _work("K1", clips, stage), timed=True,
                   piece_key=(stage, False))
            if SB.back_half_supported(c, 4 * c):
                # K1 / K3's one-launch back half alone, unshifted (K1) and
                # shifted (K3), for the by-piece split
                ctx = _seeded((x.numel() // c, c), gen)
                for masked in (False, True):
                    bh = (ctx, x, p["proj_w"], p["proj_b"], *mlp, None, None,
                          WINDOW, SHIFT if masked else NO_SHIFT)
                    tag = (f"swin_back_half {label}"
                           + (" shifted" if masked else " unshifted"))
                    _compare(tag, SB.swin_back_half(*bh),
                             SB.back_half_plain(*bh))
                    it = 10 if train_shape else 4
                    back_half_ms[(clips, stage, masked)] = _cuda_time_ms(
                        lambda: SB.swin_back_half(*bh), it)
                    print(f"[kernels] {tag}: kernel "
                          f"{back_half_ms[(clips, stage, masked)]:.4f} ms",
                          flush=True)
                del ctx
            q = _block_weights(c, heads, n, gen, 1)
            k3 = (x, *(q[k] for k in ATTN_KEYS), mask,
                  *(q[k] for k in MLP_KEYS), None, None, WINDOW, heads,
                  (SHIFT,))
            record("K3", half, label + " k=1",
                   lambda: SB.fused_swin_pair(*k3),
                   lambda: SB.swin_pair_plain(*k3),
                   _work("K3", clips, stage, masked=True), timed=True,
                   piece_key=(stage, True))
            del q
            if stage == 0:
                # K8 at the shape it was written for, without autograd
                k8 = (x, *mlp, 1e-5)

                def run_k8():
                    with torch.no_grad():
                        return M.fused_mlp(*k8)

                record("K8", 1, label, run_k8,
                       lambda: M.fused_mlp_plain(*k8),
                       _work("K8", clips, stage), timed=True)
                _one_launch_repeat(f"K8 {label}", run_k8)
                _matmul_yardstick(f"K8 {label}", x.numel() // c, c, 4 * c,
                                  gen)
            if stage == 1:
                # K8 at C = 256, the back half's other width, outside the
                # step's totals
                k8w = (x, *mlp, 1e-5)

                def run_k8w():
                    with torch.no_grad():
                        return M.fused_mlp(*k8w)

                record("K8", 0, label, run_k8w,
                       lambda: M.fused_mlp_plain(*k8w),
                       _work("K8", clips, stage), timed=True)
                _one_launch_repeat(f"K8 {label}", run_k8w)
            for masked in (False, True):
                m, s = (mask, SHIFT) if masked else (None, NO_SHIFT)
                tag = label + (" masked, shift (0,3,3)" if masked
                               else " unmasked")
                k6 = (x, *attn, m, WINDOW, heads, 1e-5, s)
                record("K6", half, tag,
                       lambda: WA.fused_window_attention(*k6),
                       lambda: WA.window_attention_plain(*k6),
                       _work("K6", clips, stage, masked=masked), timed=True,
                       piece_key=(stage, masked))
                k4 = (x, g, *bwd, m, WINDOW, heads, 1e-5, s)
                record("K4", half, tag,
                       lambda: WA.window_attention_bwd(*k4),
                       lambda: WA.window_attention_bwd_plain(*k4),
                       _work("K4", clips, stage, masked=masked), timed=True)
            for with_dp in ((True,) if train_shape else (False, True)):
                k5 = (x, g, *mlp[:5], dp if with_dp else None, 1e-5)
                record("K5", 2 * half if with_dp else 0,
                       label + (" dp2" if with_dp else " no dp2"),
                       lambda: SB.mlp_bwd(*k5), lambda: SB.mlp_bwd_plain(*k5),
                       _work("K5", clips, stage, with_dp=with_dp),
                       timed=with_dp)
            if stage == 0 and not train_shape:
                # the rest of the contract, off the eval path: K1 with a mask
                # and drop-path multipliers, K3 with k = 2
                dpv = ((torch.rand((N_CLIPS, 1), generator=gen) < 0.8)
                       .float().cuda() / 0.8)
                k1m = k1[:8] + (mask,) + k1[9:15] + (dpv, 2.0 - dpv) + k1[17:]
                record("K1", 0, label + " mask+dp",
                       lambda: SB.fused_swin_block(*k1m),
                       lambda: SB.swin_block_plain(*k1m),
                       _work("K1", clips, stage, True, True))
                r = _block_weights(c, heads, n, gen, 2)
                dp2 = ((torch.rand((2, N_CLIPS), generator=gen) < 0.8)
                       .float().cuda() / 0.8)
                k3p = (x, *(r[k] for k in ATTN_KEYS), mask,
                       *(r[k] for k in MLP_KEYS), dp2, dp2.flip(0), WINDOW,
                       heads, ((0, 0, 0), SHIFT))
                record("K3", 0, label + " k=2 +dp",
                       lambda: SB.fused_swin_pair(*k3p),
                       lambda: SB.swin_pair_plain(*k3p),
                       _work("K3", clips, stage, True, True))
            del x, g
            torch.cuda.empty_cache()
    # K7 where T is no multiple of the 128-row tile, at an odd sample count:
    # 3 clips, T = 441, with and without dp2 (fc2 in eight slices of FF)
    clips, train_shape = 3, False
    d, h, w, c, heads = STAGES[3]
    x = _seeded((clips, d, h, w, c), gen)
    mlp = [_block_weights(c, heads, n, gen, None)[k] for k in MLP_KEYS]
    dp = (torch.rand((clips,), generator=gen) < 0.8).float().cuda() / 0.8
    by_clips[clips] = totals()
    for with_dp in (False, True):
        k7r = (x, *mlp, dp if with_dp else None, 1e-5)
        tag = f"stage 3 {tuple(x.shape)} " + ("dp2" if with_dp else "no dp2")
        record("K7", 0, tag, lambda: SB.fused_ln_mlp(*k7r),
               lambda: SB.ln_mlp_plain(*k7r),
               _work("K7", clips, 3, with_dp=with_dp))
        _one_launch_repeat(f"K7 {tag}", lambda: SB.fused_ln_mlp(*k7r))
    by_clips[N_CLIPS]["K7"]["max_abs_err"] = max(
        by_clips[N_CLIPS]["K7"]["max_abs_err"],
        by_clips.pop(clips)["K7"]["max_abs_err"])
    del x, mlp
    torch.cuda.synchronize()
    for count, res in by_clips.items():
        for k, r in res.items():
            print(f"[kernels] {k}, the calls of one step at {count} clips: "
                  f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['gflop']:.3f} GFLOP, "
                  f"{r['mb']:.3f} MB)", flush=True)
    # an error found at either clip count counts for the kernel
    for k, r in by_clips[N_CLIPS].items():
        r["max_abs_err"] = max(r["max_abs_err"],
                               by_clips[TRAIN_CLIPS][k]["max_abs_err"])
    require(SB.swin_back_half.launches > 0, "the back half never launched")
    return (by_clips[N_CLIPS], by_clips[TRAIN_CLIPS], per_call, call_ms,
            back_half_ms)


def _grads(fn, x, leaves, g):
    x = x.detach().requires_grad_()
    ws = [t.detach().requires_grad_() for t in leaves]
    fn(x, ws).backward(g)
    return [x.grad] + [t.grad for t in ws]


def phase_function_grads():
    """K1 / K3 / K2 / K7 autograd.Functions (backward K6 + K5 + K4, K4, or
    K5) vs torch autograd through their plain versions, one block per stage,
    at 6 clips and at the train step's 48."""
    from lrce_tpu_torch.models.swin3d import compute_shift_mask
    from lrce_tpu_torch.ops import swin_block as SB
    from lrce_tpu_torch.ops import window_attn as WA

    gen = torch.Generator().manual_seed(4321)
    n = WINDOW[0] * WINDOW[1] * WINDOW[2]
    for clips, (stage, (d, h, w, c, heads)) in itertools.product(
            (N_CLIPS, TRAIN_CLIPS), enumerate(STAGES)):
        x = _seeded((clips, d, h, w, c), gen)
        g = _seeded((clips, d, h, w, c), gen)
        label = f"stage {stage}, {clips} clips"
        if stage == 3:
            p = _block_weights(c, heads, n, gen, None)
            leaves = [p[k] for k in ATTN_KEYS]
            dp2 = ((torch.rand((clips,), generator=gen) < 0.8).float()
                   .cuda() / 0.8)
            cases = [("K2", lambda f: lambda x_, ws: f(x_, *ws, None, WINDOW,
                                                       heads),
                      WA.fused_window_attention_hsplit,
                      WA.window_attention_plain, leaves, ATTN_KEYS),
                     ("K7", lambda f: lambda x_, ws: f(x_, *ws, dp2),
                      SB.fused_ln_mlp, SB.ln_mlp_plain,
                      [p[k] for k in MLP_KEYS], MLP_KEYS)]
        else:
            nwin = (d // WINDOW[0], h // WINDOW[1], w // WINDOW[2])
            mask = torch.from_numpy(compute_shift_mask(
                (d, h, w), WINDOW, SHIFT)).reshape(*nwin, n, n).cuda()
            dp = ((torch.rand((2, clips), generator=gen) < 0.8).float()
                  .cuda() / 0.8)
            p = _block_weights(c, heads, n, gen, None)
            q = _block_weights(c, heads, n, gen, 1)
            cases = [
                ("K1", lambda f: lambda x_, ws: f(x_, *ws[:7], None, *ws[7:],
                                                  dp[0], dp[1], WINDOW, heads),
                 SB.fused_swin_block, SB.swin_block_plain,
                 [p[k] for k in ATTN_KEYS + MLP_KEYS], ATTN_KEYS + MLP_KEYS),
                ("K3", lambda f: lambda x_, ws: f(x_, *ws[:7], mask, *ws[7:],
                                                  dp[:1], dp[1:], WINDOW,
                                                  heads, (SHIFT,)),
                 SB.fused_swin_pair, SB.swin_pair_plain,
                 [q[k] for k in ATTN_KEYS + MLP_KEYS], ATTN_KEYS + MLP_KEYS)]
        for kernel, wrap, fn_k, fn_p, leaves, keys in cases:
            got = _grads(wrap(fn_k), x, leaves, g)
            want = _grads(wrap(fn_p), x, leaves, g)
            for name, a, b in zip(("x",) + keys, got, want):
                _compare(f"{kernel} autograd {label} d{name}", a, b,
                         GRAD_REL_L2, GRAD_MAX_ABS_REL)
        del x, g
        torch.cuda.empty_cache()


def _wrappers():
    from lrce_tpu_torch.ops import mlp as M
    from lrce_tpu_torch.ops import swin_block as SB
    from lrce_tpu_torch.ops import window_attn as WA

    return {"K1": SB.fused_swin_block, "K3": SB.fused_swin_pair,
            "K2": WA.fused_window_attention_hsplit, "K7": SB.fused_ln_mlp,
            "K8": M.fused_mlp, "K6": WA.fused_window_attention,
            "K5": SB.mlp_bwd, "K4": WA.window_attention_bwd,
            "back_half": SB.swin_back_half}


def _reset_counts():
    for w in _wrappers().values():
        w.launches = 0


def _counts():
    return {k: w.launches for k, w in _wrappers().items()}


def phase_forward():
    from lrce_tpu_torch.models.e2e import E2EConfig, LRCEModel, e2e_forward

    per_forward = {k: sum(v) for k, v in CALLS_PER_FORWARD.items()}
    cfg = E2EConfig(num_classes=1000, temporal_scale=(3,), text_seq_len=32)
    t0 = time.perf_counter()
    model = LRCEModel(cfg, dtype=torch.bfloat16,
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
    _reset_counts()
    outs, lat_kernels = serve("kernel route")
    counts = _counts()
    launches = {k: counts[k] for k in per_forward}
    print(f"[forward] launches over {len(requests)} requests: {counts}")
    for k, n in launches.items():
        require(n == per_forward[k] * len(requests),
                f"{k} launched {n} times, expected {per_forward[k]} per request")
    require(all(counts[k] == 0 for k in ("K7", "K8", "K6", "K5", "K4")),
            "the eval forward launched a kernel that is not on its route")

    swin = model.video_extractor.swin
    swin.use_kernels = False
    e2e_forward(model, *requests[0])
    torch.cuda.synchronize()
    refs, lat_plain = serve("plain route")

    def check(outs, label):
        for i, (out, ref) in enumerate(zip(outs, refs)):
            require(tuple(out.shape) == (2, 1000),
                    f"logits shape {tuple(out.shape)}")
            require(bool(torch.isfinite(out).all()), "non-finite logits")
            o, r = out.float(), ref.float()
            rel_l2 = ((o - r).norm() / r.norm()).item()
            max_abs = (o - r).abs().max().item()
            top2 = r.topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1])
            same = (o.argmax(-1) == r.argmax(-1))
            # a prediction must agree wherever the plain route's top-2
            # margin is wider than twice the largest logit difference
            decided = margin > 2 * max_abs
            print(f"[forward] {label}, request {i}: rel_l2 {rel_l2:.4g} "
                  f"(limit {FORWARD_REL_L2}), max_abs {max_abs:.4g}, argmax "
                  f"equal {same.tolist()}, plain top-2 margins "
                  f"{[round(v, 4) for v in margin.tolist()]}", flush=True)
            require(rel_l2 <= FORWARD_REL_L2,
                    f"{label} disagrees with the plain route")
            require(bool(same[decided].all()),
                    "argmax differs where the margin decides it")

    check(outs, "kernel route")

    # the stage-3 MLP through K7, and its request time against the stock
    # route's in turns: on (counted), off, off, on
    swin.use_kernels, swin.ln_mlp = True, True
    e2e_forward(model, *requests[0])
    torch.cuda.synchronize()
    _reset_counts()
    outs7, lat_on = serve("kernel route + K7")
    counts7 = _counts()
    per_forward7 = {k: sum(v) for k, v in LN_MLP_FORWARD.items()}
    print(f"[forward] launches over {len(requests)} requests with ln_mlp: "
          f"{counts7}")
    for k, n in counts7.items():
        want = per_forward7.get(k, 0) * len(requests)
        require(n == want, f"{k} launched {n} times with ln_mlp, expected "
                f"{want}")
    check(outs7, "kernel route + K7")
    launches["K7"] = counts7["K7"]
    swin.ln_mlp = False
    lat_off = serve("kernel route, stock stage-3 MLP")[1]
    lat_off += serve("kernel route, stock stage-3 MLP")[1]
    swin.ln_mlp = True
    lat_on = lat_on + serve("kernel route + K7")[1]
    print(f"[forward] request ms, stage-3 MLP through K7 {np.mean(lat_on):.2f}"
          f" (median {np.median(lat_on):.2f}), stock "
          f"{np.mean(lat_off):.2f} (median {np.median(lat_off):.2f}), "
          f"{len(lat_on)} requests each, in turns", flush=True)

    # K8 through its own entry point: LN2 + MLP + residual of the first
    # block on each request's patch-embedded clips, the model's weights
    from lrce_tpu_torch.constants import IMAGENET_MEAN, IMAGENET_STD
    from lrce_tpu_torch.models.swin3d import LN_EPS
    from lrce_tpu_torch.ops.mlp import fused_mlp

    blk = swin.layers[0].blocks[0]
    mean = torch.tensor(IMAGENET_MEAN, dtype=model.dtype, device="cuda")
    std = torch.tensor(IMAGENET_STD, dtype=model.dtype, device="cuda")
    _reset_counts()
    with torch.no_grad():
        for i, req in enumerate(requests):
            frames = ((req[0].float() / 255.0).to(model.dtype) - mean) / std
            x = swin.patch_embed(frames.reshape(-1, *frames.shape[2:]))
            got = fused_mlp(x, blk.norm2.weight, blk.norm2.bias,
                            blk.mlp.fc1.weight, blk.mlp.fc1.bias,
                            blk.mlp.fc2.weight, blk.mlp.fc2.bias, LN_EPS)
            _compare(f"K8 fused_mlp on request {i} {tuple(x.shape)} vs the "
                     "model's LN2 + MLP + residual", got,
                     x + blk.mlp(blk.norm2(x)))
    launches["K8"] = _counts()["K8"]
    require(launches["K8"] == len(requests),
            f"K8 launched {launches['K8']} times, expected one per request")
    del model
    torch.cuda.empty_cache()
    return launches, lat_kernels, lat_plain, lat_on, lat_off


def _train_batch(rng, questions: int):
    clips = rng.integers(0, 256, (questions, 3, 5, 224, 224, 3), dtype=np.uint8)
    ids = rng.integers(1000, 30000, (questions, 32))
    mask = np.ones((questions, 32), np.int64)
    mask[::2, 24:] = 0
    types = np.zeros((questions, 32), np.int64)
    gt = rng.integers(0, 1000, (questions,))
    return clips, ids, mask, types, gt


def _flagship_train_model(ln_mlp: bool = False, seed: int = 0):
    from lrce_tpu_torch.models.e2e import E2EConfig, LRCEModel

    cfg = E2EConfig(num_classes=1000, temporal_scale=(3,), text_seq_len=32)
    return LRCEModel(cfg, dtype=torch.float32, compute_dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(seed),
                     ln_mlp=ln_mlp)


def phase_train():
    from lrce_tpu_torch.train.agent import AgentOE, default_args

    per_step = {"K7": 0, "K8": 0,
                **{k: sum(v) for k, v in {**CALLS_PER_FORWARD,
                                          **CALLS_PER_BACKWARD}.items()}}
    model = _flagship_train_model()
    agent = AgentOE(model, default_args(), log_enabled=False, seed=0)
    print(f"[train] flagship, f32 parameters, bf16 compute; lr {agent.lrs}, "
          f"reg {agent.reg_strength}, dropout {model.cfg.drop_out_rate}, "
          f"drop-path {model.cfg.swin.drop_path_rate}", flush=True)
    rng = np.random.default_rng(7)
    batches = [_train_batch(rng, TRAIN_BATCH) for _ in range(TRAIN_STEPS + 1)]
    probes = {"fusion_model": model.fusion_model.final_fc.weight,
              "text_extractor":
                  model.text_extractor.bert.encoder.layer[0].intermediate.dense.weight,
              "video_extractor":
                  model.video_extractor.swin.layers[0].blocks[0].attn.qkv.weight}

    def one_step(batch):
        before = {k: p.detach().clone() for k, p in probes.items()}
        torch.cuda.synchronize()
        _reset_counts()
        t = time.perf_counter()
        loss, m0, m1 = agent.step(*batch, is_train=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        counts = _counts()
        require(math.isfinite(loss), f"non-finite loss {loss}")
        for k, n in per_step.items():
            require(counts[k] == n, f"{k} launched {counts[k]} times in a train "
                    f"step, expected {n}")
        for k, p in probes.items():
            require(not torch.equal(before[k], p.detach()),
                    f"a train step left {k}'s parameters unchanged")
        return loss, ms, counts

    loss, ms, _ = one_step(batches[0])
    print(f"[train] warm-up step: loss {loss:.5f}, {ms:.1f} ms", flush=True)
    torch.cuda.reset_peak_memory_stats()
    times, counts = [], {}
    totals = {k: 0 for k in per_step}
    for batch in batches[1:]:
        loss, ms, counts = one_step(batch)
        times.append(ms)
        for k in totals:
            totals[k] += counts[k]
        print(f"[train] step: loss {loss:.5f}, {ms:.1f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    clips = TRAIN_CLIPS
    mean_ms = sum(times) / len(times)
    print(f"[train] {TRAIN_STEPS} steps of {TRAIN_BATCH} questions x 3 clips: "
          f"step ms {', '.join(f'{t:.1f}' for t in times)} (mean {mean_ms:.1f},"
          f" {clips / mean_ms * 1e3:.1f} clips/s); peak device memory "
          f"{peak:.2f} GiB; launches per step {counts}", flush=True)
    del agent, model
    torch.cuda.empty_cache()
    return totals, times, peak


class _SyntheticQA:
    """An in-memory VideoQA dataset made from a seed: item i is (uint8 clips
    (3, 5, 224, 224, 3), 32 token ids, attention mask, type ids, label)."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.clips, self.ids, self.mask, self.types, self.gt = _train_batch(
            rng, n)

    def __len__(self) -> int:
        return len(self.gt)

    def __getitem__(self, i: int):
        return (self.clips[i], self.ids[i], self.mask[i], self.types[i],
                self.gt[i])


def phase_training_run():
    """One epoch through DataLoader -> device_prefetch -> do_training, the
    stage-3 MLP through K7, checkpoints from the writer thread; then
    ``best.pt`` reloaded into a fresh model must reproduce its validation."""
    from lrce_tpu_torch.data.loader import DataLoader
    from lrce_tpu_torch.train.agent import AgentOE, default_args

    train_step = {"K8": 0, **{k: sum(v) for k, v in {
        **LN_MLP_FORWARD, **LN_MLP_BACKWARD}.items()}}
    eval_step = {**{k: 0 for k in train_step},
                 **{k: sum(v) for k, v in LN_MLP_FORWARD.items()}}
    train_dl = DataLoader(_SyntheticQA(RUN_TRAIN_ITEMS, 21), TRAIN_BATCH,
                          shuffle=True, seed=0, num_workers=2)
    val_dl = DataLoader(_SyntheticQA(RUN_VAL_ITEMS, 22), TRAIN_BATCH,
                        shuffle=False, num_workers=2)
    n_steps = len(train_dl)
    require(n_steps == 4 and len(val_dl) == 1, "the run is 4 steps + 1 val")

    with tempfile.TemporaryDirectory(prefix="lrce_smoke_") as log_dir:
        model = _flagship_train_model(ln_mlp=True)
        args = default_args(epoch=1, ckpt_interval=1, log_dir=log_dir,
                            async_checkpoint=True)
        agent = AgentOE(model, args, seed=0)
        print(f"[run] flagship, ln_mlp=True, f32 parameters, bf16 compute; "
              f"{RUN_TRAIN_ITEMS} train / {RUN_VAL_ITEMS} validation items, "
              f"batch {TRAIN_BATCH}, lr {agent.lrs}, async_checkpoint "
              f"{args.async_checkpoint}, TensorBoard "
              f"{agent.summary_writer is not None}; log dir made by the agent",
              flush=True)

        steps = []      # (is_train, counts, start event, end event)
        real_dispatch = agent.dispatch

        def dispatch(*batch, is_train):
            require(all(torch.is_tensor(b) and b.is_cuda for b in batch),
                    "a batch reached the step without device_prefetch")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            _reset_counts()
            start.record()
            out = real_dispatch(*batch, is_train=is_train)
            end.record()
            steps.append((is_train, _counts(), start, end))
            return out

        agent.dispatch = dispatch
        validations = []    # (epoch, loss, metric) at each validation
        real_better = agent.is_metric_val_better

        def is_better(epoch=None):
            better = real_better(epoch)
            validations.append((epoch, agent.last_loss, agent.last_metric_val,
                                better))
            return better

        agent.is_metric_val_better = is_better
        save_ms = []        # what the loop pays for each (async) save
        real_save = agent.save_checkpoint

        def save_checkpoint(*a, **k):
            t = time.perf_counter()
            real_save(*a, **k)
            save_ms.append((time.perf_counter() - t) * 1e3)

        agent.save_checkpoint = save_checkpoint

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        agent.do_training(train_dl, val_dl, eval_per_epoch=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30

        totals = {k: 0 for k in train_step}
        step_ms = []
        for is_train, counts, start, end in steps:
            want = train_step if is_train else eval_step
            for k, n in want.items():
                require(counts[k] == n, f"{k} launched {counts[k]} times in a "
                        f"{'train' if is_train else 'validation'} step of the "
                        f"run, expected {n}")
                totals[k] += counts[k]
            if is_train:
                step_ms.append(start.elapsed_time(end))
        n_train = sum(1 for st in steps if st[0])
        require(n_train == n_steps and len(steps) == n_steps + 2,
                f"the run took {n_train} train and {len(steps) - n_train} "
                "validation steps, expected 4 and 2")
        require(len(validations) == 2, "expected two validations")
        for v in validations:
            require(math.isfinite(v[1]), f"non-finite validation loss {v[1]}")
        require(math.isfinite(agent.last_train_loss),
                f"non-finite train loss {agent.last_train_loss}")
        print(f"[run] epoch of {n_steps} steps + 2 validations + checkpoints: "
              f"{wall:.2f} s wall; train steps on the device (events around "
              f"each dispatch) ms {', '.join(f'{t:.1f}' for t in step_ms)}; "
              f"host ms inside each save_checkpoint call (the snapshot, and "
              f"the join of the writer before it) "
              f"{', '.join(f'{t:.1f}' for t in save_ms)}; "
              f"train loss {agent.last_train_loss:.5f}; validations (epoch, "
              f"loss, metric, better) {validations}; peak device memory "
              f"{peak:.2f} GiB; launches per train step {steps[0][1]}, over "
              f"the run {totals}", flush=True)

        files = sorted(os.listdir(args.ckpt_dir))
        print(f"[run] {args.ckpt_dir.replace(log_dir, '<log dir>')}: "
              f"{[(f, os.path.getsize(os.path.join(args.ckpt_dir, f))) for f in files]}",
              flush=True)
        require(agent._ckpt_thread is None, "a checkpoint writer is still up")
        require(not [f for f in files if f.endswith(".tmp")],
                f"a .tmp file was left: {files}")
        require("best.pt" in files, f"no best.pt in {files}")
        require(any(f.startswith("epoch01_loss") for f in files),
                f"no epoch checkpoint in {files}")
        require(os.path.isfile(os.path.join(args.log_dir, "config.json")),
                "no config.json")

        # best.pt was written at the first validation that improved
        recorded = [v for v in validations if v[3]][-1]
        del agent, model
        torch.cuda.empty_cache()
        fresh = AgentOE(_flagship_train_model(ln_mlp=True, seed=5),
                        default_args(), log_enabled=False, is_eval=True)
        fresh.load_checkpoint(os.path.join(args.ckpt_dir, "best.pt"))
        fresh.do_evaluation(val_dl)
        rel = abs(fresh.last_loss - recorded[1]) / abs(recorded[1])
        print(f"[run] best.pt reloaded: validation loss {fresh.last_loss:.8f} "
              f"vs recorded {recorded[1]:.8f} (relative {rel:.3g}, limit "
              f"{EVAL_REPRODUCE_REL}), metric {fresh.last_metric_val} vs "
              f"{recorded[2]}", flush=True)
        require(rel <= EVAL_REPRODUCE_REL,
                "best.pt does not reproduce its validation loss")
        require(abs(fresh.last_metric_val - recorded[2])
                <= EVAL_REPRODUCE_REL * max(abs(recorded[2]), 1.0),
                "best.pt does not reproduce its validation metric")
        del fresh
        torch.cuda.empty_cache()
    return totals, step_ms, wall, peak


def phase_route_parity():
    """One forward + backward, kernel route (the stage-3 MLP through K7,
    ``ln_mlp=True``) vs plain route, dropout and drop-path off
    (training=False, grad enabled), the task loss's gradients per group."""
    from lrce_tpu_torch.models.e2e import e2e_apply
    from lrce_tpu_torch.train import losses as L

    model = _flagship_train_model(ln_mlp=True)
    batch = [torch.from_numpy(a).cuda()
             for a in _train_batch(np.random.default_rng(11), 2)]

    def groups():
        out = {f"swin stage {i}": f"video_extractor.swin.layers.{i}."
               for i in range(4)}
        out.update({"bert": "text_extractor.", "fusion": "fusion_model."})
        return out

    def grads(use_kernels):
        model.video_extractor.swin.use_kernels = use_kernels
        model.zero_grad(set_to_none=True)
        loss = L.cross_entropy(e2e_apply(model, *batch[:4]), batch[4])
        loss.backward()
        named = dict(model.named_parameters())
        flat = {}
        for label, pre in groups().items():
            flat[label] = torch.cat([p.grad.float().reshape(-1)
                                     for n, p in named.items()
                                     if n.startswith(pre) and p.grad is not None])
        return loss.item(), flat

    lk, gk = grads(True)
    lp, gp = grads(False)
    rel_loss = abs(lk - lp) / abs(lp)
    print(f"[parity] loss kernel route {lk:.6f}, plain route {lp:.6f}, "
          f"relative difference {rel_loss:.3g} (limit {TRAIN_LOSS_REL})",
          flush=True)
    require(math.isfinite(lk) and rel_loss <= TRAIN_LOSS_REL,
            "kernel-route loss disagrees with the plain route")
    worst = 0.0
    for label in groups():
        a, b = gk[label], gp[label]
        require(bool(torch.isfinite(a).all()), f"{label}: non-finite gradient")
        rel = ((a - b).norm() / b.norm()).item()
        worst = max(worst, rel)
        print(f"[parity] {label}: gradient relative L2 {rel:.4g} (limit "
              f"{TRAIN_GRAD_REL_L2}), |grad| {b.norm().item():.4g}", flush=True)
        require(rel <= TRAIN_GRAD_REL_L2,
                f"{label}: kernel-route gradients disagree with the plain route")
    del model
    torch.cuda.empty_cache()
    return worst


SOURCES = {
    "K1": ("fused_swin_block", "lrce_tpu_torch/csrc/swin_block.cu",
           "lrce_tpu/ops/pallas_swin_block.py:180"),
    "K3": ("fused_swin_pair", "lrce_tpu_torch/csrc/swin_block.cu",
           "lrce_tpu/ops/pallas_swin_pair.py:300"),
    "K2": ("fused_window_attention_hsplit", "lrce_tpu_torch/csrc/window_attn.cu",
           "lrce_tpu/ops/pallas_window_attn.py:820"),
    "K7": ("fused_ln_mlp", "lrce_tpu_torch/csrc/ln_mlp.cu",
           "lrce_tpu/ops/pallas_swin_block.py:544"),
    # at C = 128 / 256 (stage 0, where it is held and timed); K7's kernel
    # at other widths (ops/mlp.mlp_route)
    "K8": ("fused_mlp", "lrce_tpu_torch/csrc/back_half.cu",
           "lrce_tpu/ops/pallas_mlp.py:86"),
    "K6": ("fused_window_attention", "lrce_tpu_torch/csrc/window_attn.cu",
           "lrce_tpu/ops/pallas_window_attn.py:254"),
    "K5": ("mlp_bwd", "lrce_tpu_torch/csrc/mlp_bwd.cu",
           "lrce_tpu/ops/pallas_swin_block.py:357"),
    "K4": ("window_attention_bwd", "lrce_tpu_torch/csrc/attn_bwd.cu",
           "lrce_tpu/ops/pallas_window_attn.py:585"),
}


def main() -> int:
    t_start = time.perf_counter()
    card = phase_device()
    lib = phase_build()
    gemms = phase_gemms()
    attn_rows, ln_ms = phase_attn_core()
    results, results48, per_call, call_ms, back_half_ms = phase_kernels()
    phase_by_piece(gemms, attn_rows, ln_ms, call_ms, back_half_ms)
    phase_function_grads()
    fwd_launches, lat_k, lat_p, lat_on, lat_off = phase_forward()
    train_launches, step_ms, peak = phase_train()
    run_launches, run_step_ms, run_wall, run_peak = phase_training_run()
    worst = phase_route_parity()
    # the forward kernels from the serving requests, K8 from its own entry
    # point, the backward kernels from the training run; every kernel of
    # the run's path must have launched there
    for k in ("K1", "K3", "K2", "K7", "K6", "K5", "K4"):
        require(run_launches[k] > 0 and (k == "K7" or train_launches[k] > 0),
                f"{k} never launched on the training path")
    launches = {**fwd_launches,
                **{k: run_launches[k] for k in ("K6", "K5", "K4")}}
    kernels = []
    for k in KERNEL_ORDER:
        r = results[k]
        require(launches[k] > 0, f"{k} never launched on its path")
        kernels.append({
            "name": SOURCES[k][0], "route": "cuda", "source": SOURCES[k][1],
            "replaces": SOURCES[k][2], "launches": launches[k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": ("operations" if r["ops_ms"] >= r["bytes_ms"]
                         else "bytes"),
            "library_ms": None,
            "clips48": {key: results48[k][key]
                        for key in ("ms", "plain_ms", "bound_ms")}})
    print(f"[summary] {card}; build {lib.build_seconds:.1f} s; request "
          f"latency ms kernel route {lat_k}, plain route {lat_p}, with K7 "
          f"{lat_on}, stock stage-3 MLP {lat_off}; train step ms {step_ms} at "
          f"{TRAIN_CLIPS} clips, peak {peak:.2f} GiB; training run "
          f"{run_wall:.2f} s, step ms {run_step_ms}, peak {run_peak:.2f} GiB; "
          f"route parity worst gradient rel L2 {worst:.4g}; per call "
          f"(kernel ms, plain ms, calls, bound ms) "
          f"{[(k, l, round(a, 4), round(b, 4), c, round(d, 4)) for k, l, a, b, c, d in per_call]}"
          f"; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
