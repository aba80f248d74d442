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
     one JSON line, each call's CTA named by the library's launch counts
     (``ops/window_attn.attn_fwd_cta_launches``): attn_fwd_kernel at N =
     147; K6 at head_dim 64, a shape no attention CTA takes, refused
     before any launch, and a Swin stage at that width on the plain block,
     with grad mode on and off, no kernel launched; the 16-frame window (8, 7, 7), N = 392, which
     the launcher gives attn_fwd_big_kernel, at every stage at 6 and 48
     clips (its output held to plain chunk by chunk of 12 / 24 / 48 / 48
     clips, the output being per window), timed beside its bound and the
     library's attention (rows with ``n`` 392 in the same JSON line); a
     Swin stage at that window with grad mode on (K1 / K3 forward, K6 / K5
     and K4's rows / columns pair backward, attn_fwd_big_kernel four times)
     and off (K1 / K3), its launch counts printed as one ``[route]`` line;
     and the LayerNorm (+ window gather) alone at every stage
     (``ops/gemm.ln_rows``);
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     flagship shapes (bf16), at 6 clips (one request) and at the train
     step's 48: K1, K3, K2 (forward); K6 with and without the mask at
     stages 0-2, K4 at stages 0-3, K5 at stages 0-3 (every output: dy / dz,
     each dW, db and drel); K7 at stage 3 (C = 1024) with and without dp2,
     and again at 3 clips (T = 441: a row tail past the 128-row tile, an
     odd sample count); K8 at stage 0 (C = 128) and at C = 256 without
     autograd. K4 at the 16-frame window, N = 392 (its rows / columns pair):
     every output at stages 0-3, shifted and not, at 6 and 48 clips (at
     stages 0-1 the plain version runs the 48 clips in chunks of 12 / 24,
     where its f32 (N, N) tensors fit: dy concatenated, the window sums
     added), a second call bit-identical, the pair's two CTAs seen by the
     profiler, its time beside its bound and the plain time (the measured
     total of the chunk calls). K7 and
     K8 must launch one kernel a call (torch.profiler) and give the same
     bits on a second call; the library's fc1 + fc2
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
  3b. swinl: Video Swin-L at 384 x 384 and 5 frames, as the
     msvd-swinl384-train cell runs it (the window (3, 12, 12), N = 432 at
     every stage, C = 192 / 384 / 768 / 1536): the forward CTA alone
     (attn_fwd_big_kernel in 64-row CTAs) and K4's rows / columns pair at
     every stage, masked and not at stages 0-2, at 6 clips and at a step's
     60, as at N = 392 above (the CTA counted, reset before each call; the
     plain versions in chunks of 12 / 24 / 30 / 60 clips); K2 at stages 2-3
     (C = 768 masked and not, C = 1536 with 48 heads, its LN1 over 1536
     columns) at 60 clips against its plain version, attn_fwd_big_kernel
     and K2 once a call; LN1 + gather at C = 1536 alone; each timed beside
     its bound and summed over a step's calls (forward CTA 28, K4 24, K2
     20); then one stage of each route at Swin-L's widths through
     ``BasicLayer`` with grad mode on and off, its launches counted (K1 /
     K3 / K6 / K5 / K4 at C = 192, K2 / K4 at C = 768 and 1536, the
     forward CTAs attn_fwd_big_kernel alone);
  4. forward: the flagship LRCEModel (Video Swin-B, BERT-base, 12-layer
     fusion, open-ended head, random weights from a seed) on the card in
     bf16 answers 3 requests of 2 questions x 3 clips x 5 x 224 x 224 uint8
     frames with 32 tokens. Logits must be finite, (2, 1000), agree with
     the same model run on the plain route, and each request must launch
     K1 11 times, K3 11 times, K2 twice, K7 twice (stage 3's LN2 + MLP)
     and the back half 4 times (K1 and K3 at stages 0-1). Then K8 through
     its own entry
     point, ``fused_mlp``, on each request's patch-embedded clips with the
     first block's weights, against the model's own LN2 + MLP + residual;
  5. train: the flagship with f32 parameters and bf16 compute, AgentOE with
     the config defaults (lr 5e-6 for all three groups, reg 0.001),
     dropout 0.1 and drop-path 0.2 from a seeded generator, takes a warm-up
     step and 2 steps at 16 questions x 3 clips (48 clips) of uint8 frames.
     Every step: a finite loss, parameters of all three groups changed, and
     the launches K1 11, K3 11, K2 2, K7 2 (forward), K6 22, K5 24, K4 24
     (backward), and attn_fwd_kernel 46 times. Prints the step ms and the
     peak device memory;
  6. training run: the same flagship through the entry
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
     drop-path off, the same weights and batch, on the kernel route (K7
     and its backward K5 at stage 3) and on the plain
     route: loss and per-group gradient relative L2 (each Swin
     stage, BERT, the fusion) against the stated limit;
  7b. frames16: the flagship at 16 frames (``frame_sample_size`` 16, the
     window (8, 7, 7) unclamped, N = 392 at every stage): at 2 questions x 3
     clips the kernel route against the plain route (loss, per-group
     gradients, a request's logits, the limits of 7 and 4), then a warm-up
     and 2 AgentOE steps at 16 questions x 3 clips on the kernel route, each
     launching K1 11, K3 11, K2 2, K7 2, K6 22, K5 24, K4 24 and attn_fwd_big_kernel
     46 times; step ms, peak and the card on one
     ``[frames16]`` line;
  8. cli: the file-based path through the command lines a user runs. A
     TGIF-frameqa directory made from a seed in a temporary directory (8
     GIFs of 12-40 frames written by ``tools/synth.write_gif`` without an
     image library, seven at 224 x 224 and one at 320 x 240; 32 train and 16 test
     questions in the tab-separated annotation files; a vocab.txt). The
     port's native library (``lrce_tpu_torch/native``) is built with g++
     and required, and so is its WordPiece on the dataset's tokenizer; one
     item's uint8 clips from ``E2ETGIFDataset`` must equal the palette
     colours of the frames written at ``clip_indices`` byte for byte, the
     320 x 240 GIF's must be (3, 5, 224, 224, 3) uint8; the host ms per item
     of the native decode, the resize and the tokenizer are timed on the
     dataset alone. Then ``lrce_tpu_torch.cli.train.main`` for one epoch of
     the tgif-frameqa configuration at full width (batch 8: 4 train steps
     and 2 validation steps, async checkpoints): finite losses, every
     group's parameters moved, ``config.json`` and ``best.pt`` written,
     K1 11, K3 11, K2 2, K7 2, K6 22, K5 24, K4 24 launches on every train
     step; and ``lrce_tpu_torch.cli.eval.main`` on that ``best.pt`` over the
     test split: a finite loss and accuracy, K1 11, K3 11, K2 2, K7 2 a
     step. One
     ``[cli]`` line gives both walls, the train steps' device ms, the
     loader-wait share of each step, the peak device memory and the card;
  9. ddp: training across ranks. ``cli.train_ddp.main`` (the legacy
     parser's temporal scale [1, 2, 3], batch 8 a rank: 4 train and 2
     validation steps over a TGIF-frameqa directory of 32 / 16 questions
     written as in 8) at one rank per card over NCCL, one card: a one-rank
     NCCL group with DDP around the full-width model, K1-K6 counted on
     every train step and K1 / K3 / K2 on every eval step; then
     ``cli.eval.main`` on its ``best.pt``. Then two ranks sharing the card
     over gloo (NCCL refuses two ranks on one card), the flagship with f32
     parameters, bf16 compute, dropout and drop-path 0, 4 questions x 3
     clips a rank: 2 DDP steps, both ranks' parameters bit-identical after
     each; tensor parallelism (model 2) and FSDP (fsdp 2, its all-gathers
     and reduce-scatters over gloo too) one step each; each step against
     one process on the concatenated 8 questions (loss 1e-2, per-group
     gradient 1e-1 relative, per-group update 1e-1 relative where every
     step's gradient so far is above 0.1 of its group's RMS); every rank's
     step launches what the one-card step does. One ``[ddp]``
     line: the CLI's walls, step ms and peak, each two-rank run's step ms
     and peak a rank, the gradient all-reduce's share over gloo (through
     the host: no NCCL figure);
 10. tools: each tool of ``lrce_tpu_torch/tools`` through its ``main`` at
     full width, iteration counts cut (``phase_tools``): first the forward
     at 32 questions x 3 clips (96 clips, bench.py's inputs) and at 1 x 3
     clips on the kernel route, K1 11, K3 11, K2 2 launches each and no
     other kernel, held to the plain route as in 4; then bench (bench.py's
     program: one JSON line, clips/s of the 96-clip forward over 20
     forwards), preflight,
     profile --latency (20 requests, K1 / K3 / K2 counted on each),
     stage_bench (48 clips, K7 on stage 3), train_bench (batch 16, K7),
     e2e_eval_bench (64 questions of the synthetic sanity set, batch 32),
     sanity_curve (500 samples, 2 epochs: finite losses, whether the loss
     fell), parity_eval on the sanity run's weights (its loss within 1e-4
     of ``cli.eval.main``'s), extract_features video and text on 4 GIFs,
     flops and graft_entry's forward; each tool's kernels must launch. One
     ``[tools]`` line of the walls and headline numbers; bench_ingest is
     not run (cv2);
 11. a JSON line of kernels, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

In the kernels line, ms / plain_ms / bound_ms are sums over the calls one
6-clip request (K1, K3, K2, K7; one call for K8) or the backward of one
6-clip step (K6, K5, K4) makes; ``clips48`` holds the same three sums over
the calls of one 48-clip train step; K4's ``clips6_n392`` and
``clips48_n392`` the same at 16 frames (N = 392) and ``clips6_n432`` /
``clips60_n432`` at Swin-L's N = 432, with the clips of each
call of each stage's plain version (``plain_chunk``: its time is the sum
of those calls over all the clips). bound_ms is the larger of the call's
operations over 989 TFLOP/s (dense bf16) and its bytes (each input read
once, each output written once) over 3.35 TB/s, the H100 SXM's published
peaks. library_ms is null: no single PyTorch call computes any of these
fused functions.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import itertools
import json
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional

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
# 16-frame clips: the window (8, 7, 7) unclamped, N = 392 at every stage,
# stages 0-2 shifted by (0, 3, 3) in every other block (K4's rows / columns
# pair in the backward, attn_fwd_big_kernel in the forward)
STAGES16 = (
    (8, 56, 56, 128, 4), (8, 28, 28, 256, 8), (8, 14, 14, 512, 16),
    (8, 7, 7, 1024, 32))
WINDOW16 = (8, 7, 7)
# clips a call of each stage's plain K4 / attention takes when a step's 48
# do not fit in one: one f32 (N, N) tensor of every window-head of stage 0
# at 48 clips is 12,288 x 0.61 MB = 7.5 GB; the plain version then runs
# the 48 clips in chunks of this many
N392_PLAIN_CLIPS = (12, 24, 48, 48)
FRAMES16_BATCH = 16         # questions of the 16-frame train steps
FRAMES16_STEPS = 2
# stage 3 (C = 1024) runs K2, then its LN2 + MLP through K7
CALLS_PER_FORWARD = {"K1": (1, 1, 9, 0), "K3": (1, 1, 9, 0),
                     "K2": (0, 0, 0, 2), "K7": (0, 0, 0, 2),
                     # K1 / K3's one-launch back half, at stages 0-1
                     "back_half": (2, 2, 0, 0)}
# backward of one train step: K6 once per K1/K3 block, K5 once per block
# (K7's backward included), K4 once per block of every stage (K2's backward
# included); K6 and K4 run half their calls with the mask (the shifted
# blocks)
CALLS_PER_BACKWARD = {"K6": (2, 2, 18, 0), "K5": (2, 2, 18, 2),
                      "K4": (2, 2, 18, 2)}
TRAIN_BATCH = 16                # questions per step (tools/train_bench.py)
TRAIN_CLIPS = TRAIN_BATCH * 3   # the Swin batch of a train step
TRAIN_STEPS = 2
# clip counts phase_tools gives K1 / K3 / K2 besides 6 and 48, held per
# kernel in phase_kernels: one question (profile --latency: odd window
# counts, row tails) and bench.py's 32 questions (preflight, e2e_eval_bench,
# parity_eval: T = 903,168 tokens at stage 0), the most any tool gives them
TOOLS_CLIPS = (3, 96)
RUN_TRAIN_ITEMS, RUN_VAL_ITEMS = 64, 16     # the training run's dataset
KERNEL_ORDER = ("K1", "K3", "K2", "K7", "K8", "K6", "K5", "K4")
PEAK_BF16_FLOPS = 989e12        # H100 SXM, dense
PEAK_BYTES_PER_S = 3.35e12
EVAL_REPRODUCE_REL = 1e-6
# phase_cli: a TGIF-frameqa dataset on disk (``tools/synth.
# write_tgif_frameqa``'s GIFs), questions per split (the CLIs' default
# batch of 20: 20 train steps, far more than the loader's lookahead of
# CLI_LOOKAHEAD batches, so the steps after it show whether the loader keeps
# up), the items timed alone on the host
CLI_TRAIN_QUESTIONS, CLI_TEST_QUESTIONS = 400, 40
CLI_HOST_ITEMS = 32
# batches the train loop can draw without waiting once its first step ends:
# the loader's queue (2) and the batch its producer holds (1);
# device_prefetch pulls its depth (2) and one more before that step
CLI_LOOKAHEAD = 3


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
          with_dp: bool = False, stages=STAGES, window=WINDOW):
    """(operations, bytes) of one call at a flagship stage (of ``stages``,
    windows ``window``): every matrix product at 2 m n k, each input read
    once and each output written once (bf16 activations and matrices, f32
    LN parameters, biases, rel_bias, mask, dp and weight gradients)."""
    d, h, w, c, heads = stages[stage]
    n = window[0] * window[1] * window[2]
    t = clips * d * h * w
    ff = 4 * c
    act = t * c * 2
    rel = heads * n * n * 4
    mask = (d // window[0]) * (h // window[1]) * (w // window[2]) * n * n * 4 \
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


PROFILE_TRIES = 3    # captures _one_launch_checks takes before it fails


def _one_launch_checks(checks) -> None:
    """Each wrapper call of ``checks`` ((name, run) pairs) launches one
    kernel (torch.profiler), and a second call on the same inputs equals
    the first bit for bit.

    All the calls run in one profiled region, each after a marker kernel
    (``torch.cuda._sleep``'s ``spin_kernel``, found by its name) and a
    synchronize; the kernels between two markers are one call's. The
    region opens with another kernel, so that the capture is running
    before the first marker (a capture can miss its first kernel). A
    capture with fewer markers than calls lost events (torch.profiler has
    returned no CUDA events for a region late in a long process) and is
    taken again, up to PROFILE_TRIES times; if none holds every marker,
    the check fails."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        firsts = [run() for _, run in checks]
        for _ in range(PROFILE_TRIES):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
                agains = []
                for _, run in checks:
                    torch.cuda._sleep(1000)
                    torch.cuda.synchronize()
                    agains.append(run())
                    torch.cuda.synchronize()
            events = sorted((e for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
            marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
            if len(marks) == len(checks):
                break
    require(len(marks) == len(checks), f"one launch a call: the profiler "
            f"caught {len(marks)} of {len(checks)} markers in "
            f"{PROFILE_TRIES} captures; the last: "
            f"{[e.name[:40] for e in events]}")
    for (name, _), first, again, lo, hi in zip(
            checks, firsts, agains, marks, marks[1:] + [len(events)]):
        kernels = [e.name for e in events[lo + 1:hi]]
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


class Geometry(NamedTuple):
    """Clips whose windows take attn_fwd_big_kernel and K4's rows / columns
    pair: the stages (D, H, W, C, heads), the window and the shift of the
    shifted blocks, the clips of a request and of a train step, the clips a
    call of each stage's plain version takes (where a step's f32 (N, N)
    tensors do not fit in one), and the forward CTA's and K4's calls a
    train step, per stage (half of them masked at stages 0-2)."""
    stages: tuple
    window: tuple
    shift: tuple
    clips: tuple
    plain_clips: tuple
    core_calls: tuple
    k4_calls: tuple


# Swin-B's 16-frame clips, N = 392 (see STAGES16)
N392 = Geometry(STAGES16, WINDOW16, SHIFT, (N_CLIPS, TRAIN_CLIPS),
                N392_PLAIN_CLIPS, ATTN_CORE_CALLS, CALLS_PER_BACKWARD["K4"])
# Video Swin-L at 384 x 384, 5 frames, as the msvd-swinl384-train cell runs
# it: the window (8, 12, 12) clamped to (3, 12, 12), N = 432 at every stage,
# stages 0-2 shifted by (0, 6, 6) in every other block, stage 3 one
# unshifted window over its 12 x 12 map. Stages 0-1 run K1 / K3 (K6
# recomputes their attention in the backward), stages 2-3 K2 (C > 512); K4
# answers every block. A step of the cell: 20 questions x 3 clips.
STAGESL = ((3, 96, 96, 192, 6), (3, 48, 48, 384, 12), (3, 24, 24, 768, 24),
           (3, 12, 12, 1536, 48))
WINDOWL = (3, 12, 12)
SWINL_CLIPS = 60
N432 = Geometry(STAGESL, WINDOWL, (0, 6, 6), (N_CLIPS, SWINL_CLIPS),
                (12, 24, 30, 60), (4, 4, 18, 2), (2, 2, 18, 2))
K2_CALLS_SWINL = (0, 0, 18, 2)


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
                WA.attn_fwd_cta_launches(reset=True)
                got = WA.window_attention_core(qkv, rel, mask, heads)
                ctas = WA.attn_fwd_cta_launches(reset=True)
                require(ctas == _only_cta("attn_fwd_kernel"),
                        f"{label} launched {ctas}, expected attn_fwd_kernel "
                        "once")
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
        out.append({"n": n, "clips": clips, "stage": stage, "masked": masked,
                    "max_abs_err": err, "ms": ms, "bound_ms": bound,
                    "bound_by": by, "library_ms": lib,
                    "calls_per_step": calls, "cta": "attn_fwd_kernel"})
    for clips, (ms, bound, lib) in sums.items():
        print(f"[attn_core] the {sum(ATTN_CORE_CALLS)} calls of one train step "
              f"at {clips} clips: kernel {ms:.4f} ms, bound {bound:.4f} ms, "
              f"library {lib:.4f} ms", flush=True)
    for (clips, stage, kind), ms in ln_ms.items():
        print(f"[attn_core] ln_rows {kind} stage {stage}, {clips} clips: "
              f"{ms:.4f} ms", flush=True)

    from lrce_tpu_torch.models.swin3d import (BasicLayer, DeviceConstants,
                                              SwinConfig)

    # head_dim 64 (C = 256, 4 heads), which no attention CTA takes, at the
    # 5-frame window, shifted: K6 refuses it before any launch, and a Swin
    # stage of that width takes the plain block, with grad mode on and off
    c64, heads64 = 256, 4
    x64 = _seeded((2, 3, 14, 14, c64), gen)
    p64 = _block_weights(c64, heads64, n, gen, None)
    mask64 = torch.from_numpy(compute_shift_mask((3, 14, 14), WINDOW, SHIFT))
    k6 = (x64, *(p64[k] for k in ATTN_KEYS),
          mask64.reshape(1, 2, 2, n, n).cuda(), WINDOW, heads64, 1e-5, SHIFT)
    WA.attn_fwd_cta_launches(reset=True)
    try:
        WA.fused_window_attention(*k6)
        refused = None
    except ValueError as e:
        refused = str(e)
    ctas = WA.attn_fwd_cta_launches(reset=True)
    require(refused is not None and ctas == _only_cta(None),
            f"K6 at head_dim 64: refused {refused!r}, launched {ctas}; "
            "expected a ValueError before any launch")
    layer64 = BasicLayer(c64, 2, heads64, SwinConfig(window_size=(8, 7, 7)),
                         False, torch.bfloat16,
                         torch.Generator().manual_seed(4)).cuda()
    x64s = x64.detach().requires_grad_()
    _reset_counts()
    WA.attn_fwd_cta_launches(reset=True)
    layer64(x64s, True, DeviceConstants()).float().sum().backward()
    with torch.no_grad():
        y64 = layer64(x64, True, DeviceConstants())
    counts64, ctas = _counts(), WA.attn_fwd_cta_launches(reset=True)
    print(f"[route] head_dim 64, window {WINDOW} (N {n}): K6 refused "
          f"({refused}); a stage with grad and without launched {counts64}, "
          f"forward CTAs {ctas}", flush=True)
    require(not any(counts64.values()) and ctas == _only_cta(None)
            and bool(torch.isfinite(y64.float()).all())
            and x64s.grad is not None
            and bool(torch.isfinite(x64s.grad).all()),
            f"a stage at head_dim 64 launched {counts64} and the forward "
            f"CTAs {ctas}, expected the plain block and no kernel")
    del x64, x64s, p64, k6, layer64, y64
    window, c, heads = (8, 7, 7), 128, 4
    n_big = window[0] * window[1] * window[2]
    x = _seeded((2, 8, 14, 14, c), gen)
    n392_rows, n392_sums = _attn_core_big(gen, N392)
    out += n392_rows
    # the same geometry through a Swin stage: with grad mode on and off it
    # runs K1 / K3, and with grad K6 / K5 and K4 (its rows / columns pair)
    # in the backward
    layer = BasicLayer(c, 2, heads, SwinConfig(window_size=window), False,
                       torch.bfloat16, torch.Generator().manual_seed(3)).cuda()
    xs = x.detach().requires_grad_()
    _reset_counts()
    WA.attn_fwd_cta_launches(reset=True)
    layer(xs, True, DeviceConstants()).float().sum().backward()
    with_grad = _counts()
    ctas = WA.attn_fwd_cta_launches(reset=True)
    _reset_counts()
    with torch.no_grad():
        layer(x, True, DeviceConstants())
    without = _counts()
    print(f"[route] window {window} (N {n_big}), head_dim {c // heads}: K4 "
          f"takes it {WA.attn_supported(n_big, c // heads)}; launches, "
          f"forward + backward with grad {with_grad}, forward without grad "
          f"{without}; forward attention CTAs with grad {ctas}", flush=True)
    require(ctas == _only_cta("attn_fwd_big_kernel", 4),
            f"a stage at N = 392 launched the forward CTAs {ctas}, expected "
            "attn_fwd_big_kernel 4 times (K1, K3, K6 twice)")
    want = {"K1": 1, "K3": 1, "K6": 2, "K5": 2, "K4": 2}
    require(all(with_grad[k] == v for k, v in want.items())
            and xs.grad is not None and bool(torch.isfinite(xs.grad).all()),
            f"a stage at N = 392 with grad mode on launched {with_grad}, "
            f"expected {want}")
    require(without["K1"] == 1 and without["K3"] == 1,
            "a stage at N = 392 did not run K1 / K3 without grad")
    del layer, xs
    print(json.dumps({"attn_core": out}), flush=True)
    return out, ln_ms, n392_sums


def _only_cta(cta: Optional[str], times: int = 1) -> dict:
    """The forward attention CTAs' launch counts when only ``cta`` ran
    (None: none ran)."""
    from lrce_tpu_torch.ops import window_attn as WA

    return {k: (times if k == cta else 0) for k in WA.ATTN_FWD_CTAS}


def _cta_named(counts: dict) -> str:
    """The forward attention CTAs that launched, by name and count."""
    return ", ".join(f"{k} x{v}" for k, v in counts.items() if v) or "none"


def _attn_core_big(gen, geo: Geometry):
    """The attention-forward CTA at the windows of ``geo`` (N392: the
    16-frame window (8, 7, 7); N432: Swin-L's (3, 12, 12)), which the
    launcher gives attn_fwd_big_kernel: at every stage (masked and not at
    stages 0-2), at a request's clips and a step's, each call's CTA named by
    the library's launch counts, reset just before (that CTA once, the
    others never), its output held to the plain version chunk by chunk of
    ``geo.plain_clips`` clips (the output is per window), timed between two
    timings of the library's attention and two of the plain version (the
    total of its chunk calls), with its bound. Returns attn_core rows (``n``
    the window's tokens) and {clips: the sums over the calls of a step}."""
    import torch.nn.functional as F

    from lrce_tpu_torch.models.swin3d import compute_shift_mask
    from lrce_tpu_torch.ops import window_attn as WA

    n = math.prod(geo.window)
    dgen = torch.Generator(device="cuda").manual_seed(n + 1)
    rows, totals = [], {}
    for clips in geo.clips:
        total = totals[clips] = {"ms": 0.0, "plain_ms": 0.0,
                                 "bound_ms": 0.0, "library_ms": 0.0}
        for stage, (d, h, w, c, heads) in enumerate(geo.stages):
            nwin_clip = ((d // geo.window[0]) * (h // geo.window[1])
                         * (w // geo.window[2]))
            nwin, hd = clips * nwin_clip, c // heads
            pc = min(clips, geo.plain_clips[stage])
            qkv = _device_seeded((nwin, n, 3 * c), dgen)
            rel = torch.randn((heads, n, n), generator=gen).cuda()
            q, k, v = (a.contiguous() for a in qkv.reshape(
                nwin, n, 3, heads, hd).permute(2, 0, 3, 1, 4))
            for masked in ((False, True) if stage < 3 else (False,)):
                mask, lq, lk, lv, add = None, q, k, v, rel[None]
                if masked:
                    mask = torch.from_numpy(compute_shift_mask(
                        (d, h, w), geo.window, geo.shift)).cuda()
                    lq, lk, lv = (a.reshape(clips, nwin_clip * heads, n, hd)
                                  for a in (q, k, v))
                    add = (rel[None] + mask[:, None]).reshape(
                        1, nwin_clip * heads, n, n)
                WA.attn_fwd_cta_launches(reset=True)
                got, err = WA.window_attention_core(qkv, rel, mask, heads), 0.0
                ctas = WA.attn_fwd_cta_launches(reset=True)
                require(ctas == _only_cta("attn_fwd_big_kernel"),
                        f"attn_core at N = {n} launched {ctas}, expected "
                        "attn_fwd_big_kernel once")
                label = (f"attn_core N {n} stage {stage}, {clips} clips, "
                         f"{'masked' if masked else 'unmasked'} ({nwin} "
                         f"windows x {heads} heads, head_dim {hd}, "
                         f"{_cta_named(ctas)})")
                for first in range(0, clips, pc):
                    win = slice(first * nwin_clip, (first + pc) * nwin_clip)
                    err = max(err, _compare(
                        label + (f" (clips {first}-{first + pc - 1})"
                                 if pc < clips else ""), got[win],
                        WA.window_attention_core_plain(qkv[win], rel, mask,
                                                       heads)))
                del got

                def run_lib():
                    return F.scaled_dot_product_attention(lq, lk, lv,
                                                          attn_mask=add)

                def run_k():
                    return WA.window_attention_core(qkv, rel, mask, heads)

                def run_p():
                    return [WA.window_attention_core_plain(
                        qkv[f * nwin_clip:(f + pc) * nwin_clip], rel, mask,
                        heads) for f in range(0, clips, pc)]

                iters = 5 if clips == geo.clips[-1] else 10
                p1, lib, k1, k2, lib2, p2 = (_cuda_time_ms(f, i) for f, i in (
                    (run_p, 1), (run_lib, iters), (run_k, iters),
                    (run_k, iters), (run_lib, iters), (run_p, 1)))
                t = nwin * n
                work = (4 * t * n * c, 2 * t * 4 * c + heads * n * n * 4
                        + (nwin_clip * n * n * 4 if masked else 0))
                bound, by = _bound_ms(work)
                calls = geo.core_calls[stage] // (2 if stage < 3 else 1)
                ms, lib, plain = (k1 + k2) / 2, (lib + lib2) / 2, (p1 + p2) / 2
                for key, val in (("ms", ms), ("plain_ms", plain),
                                 ("bound_ms", bound), ("library_ms", lib)):
                    total[key] += calls * val
                print(f"[attn_core] {label}: kernel {ms:.4f} ms, plain "
                      f"{plain:.4f} ms" + (f" ({clips // pc} calls of {pc} "
                                           "clips)" if pc < clips else "")
                      + f", bound {bound:.4f} ms ({by}: {work[0] / 1e9:.3f} "
                      f"GFLOP, {work[1] / 1e6:.3f} MB), library {lib:.4f} "
                      f"ms; {calls} call(s) a step", flush=True)
                rows.append({"n": n, "clips": clips, "stage": stage,
                             "masked": masked, "max_abs_err": err, "ms": ms,
                             "plain_ms": plain, "bound_ms": bound,
                             "bound_by": by, "library_ms": lib,
                             "calls_per_step": calls,
                             "cta": "attn_fwd_big_kernel"})
                del mask, add, lq, lk, lv
            del qkv, q, k, v
            torch.cuda.empty_cache()
        print(f"[attn_core] N = {n}, attn_fwd_big_kernel, the "
              f"{sum(geo.core_calls)} calls of one {clips}-clip step: kernel {total['ms']:.4f} ms, plain "
              f"{total['plain_ms']:.4f} ms, bound {total['bound_ms']:.4f} "
              f"ms, library {total['library_ms']:.4f} ms", flush=True)
    return rows, totals


def phase_by_piece(gemms, attn_rows, ln_ms, call_ms, back_half_ms):
    """K1, K3, K6 and K2 per call beside the times of their pieces taken
    alone (the GEMMs by phase_gemms, the CTA and the LayerNorms by
    phase_attn_core, K1 / K3's one-launch back half at stages 0-1 by
    phase_kernels): what is left over is launch gaps, the wrapper's
    allocations and, for K6 and K2, the cheaper proj epilogue (the proj timed
    alone is K1's, with dp1 and the residual)."""
    gemm = {(g["name"], g["clips"], g["stage"]): g for g in gemms}
    cta = {(a["clips"], a["stage"], a["masked"]): a["ms"] for a in attn_rows
           if a["n"] == WINDOW[0] * WINDOW[1] * WINDOW[2]}
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
    one_launch = []     # (name, run) of each K7 / K8 call held to one launch
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

                    def run_k7(k7=k7, with_dp=with_dp):
                        if with_dp:
                            return SB.fused_ln_mlp(*k7)
                        with torch.no_grad():
                            return SB.fused_ln_mlp(*k7)

                    record("K7", CALLS_PER_FORWARD["K7"][stage]
                           if with_dp == train_shape else 0,
                           label + (" dp2" if with_dp else " no dp2"), run_k7,
                           lambda: SB.ln_mlp_plain(*k7),
                           _work("K7", clips, stage, with_dp=with_dp),
                           timed=True)
                    one_launch.append((f"K7 {label} "
                                       + ("dp2" if with_dp else "no dp2"),
                                       run_k7))
                _matmul_yardstick(f"K7 {label}", x.numel() // c, c, 4 * c,
                                  gen)
                k5 = (x, g, *mlp[:5], dp, 1e-5)
                record("K5", CALLS_PER_BACKWARD["K5"][stage],
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

                def run_k8(k8=k8):
                    with torch.no_grad():
                        return M.fused_mlp(*k8)

                record("K8", 1, label, run_k8,
                       lambda: M.fused_mlp_plain(*k8),
                       _work("K8", clips, stage), timed=True)
                one_launch.append((f"K8 {label}", run_k8))
                _matmul_yardstick(f"K8 {label}", x.numel() // c, c, 4 * c,
                                  gen)
            if stage == 1:
                # K8 at C = 256, the back half's other width, outside the
                # step's totals
                k8w = (x, *mlp, 1e-5)

                def run_k8w(k8w=k8w):
                    with torch.no_grad():
                        return M.fused_mlp(*k8w)

                record("K8", 0, label, run_k8w,
                       lambda: M.fused_mlp_plain(*k8w),
                       _work("K8", clips, stage), timed=True)
                one_launch.append((f"K8 {label}", run_k8w))
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
    n392 = _k4_pair(gen, N392)
    n392["forward"] = _fwd_n392(gen)
    by_clips[N_CLIPS]["K4"]["max_abs_err"] = max(
        by_clips[N_CLIPS]["K4"]["max_abs_err"], n392.pop("max_abs_err"))
    # the other clip counts the tools give K1 / K3 / K2 (phase_tools), each
    # held to its plain version outside the step's totals
    for clips in TOOLS_CLIPS:
        by_clips[clips] = totals()
        for stage, (d, h, w, c, heads) in enumerate(STAGES):
            x = _seeded((clips, d, h, w, c), gen)
            p = _block_weights(c, heads, n, gen, None)
            attn = [p[k] for k in ATTN_KEYS]
            label = f"stage {stage} {tuple(x.shape)}"
            if stage == 3:
                args = (x, *attn, None, WINDOW, heads)
                record("K2", 0, label,
                       lambda: WA.fused_window_attention_hsplit(*args),
                       lambda: WA.window_attention_plain(*args),
                       _work("K2", clips, stage))
            else:
                mlp = [p[k] for k in MLP_KEYS]
                k1 = (x, *attn, None, *mlp, None, None, WINDOW, heads)
                record("K1", 0, label, lambda: SB.fused_swin_block(*k1),
                       lambda: SB.swin_block_plain(*k1),
                       _work("K1", clips, stage))
                mask = torch.from_numpy(compute_shift_mask((d, h, w), WINDOW,
                                                           SHIFT))
                mask = mask.reshape(d // WINDOW[0], h // WINDOW[1],
                                    w // WINDOW[2], n, n).cuda()
                q = _block_weights(c, heads, n, gen, 1)
                k3 = (x, *(q[k] for k in ATTN_KEYS), mask,
                      *(q[k] for k in MLP_KEYS), None, None, WINDOW, heads,
                      (SHIFT,))
                record("K3", 0, label + " k=1",
                       lambda: SB.fused_swin_pair(*k3),
                       lambda: SB.swin_pair_plain(*k3),
                       _work("K3", clips, stage, masked=True))
                del q, k1, k3
            del x, p, attn
            torch.cuda.empty_cache()
        for k, r in by_clips.pop(clips).items():
            by_clips[N_CLIPS][k]["max_abs_err"] = max(
                by_clips[N_CLIPS][k]["max_abs_err"], r["max_abs_err"])
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
        one_launch.append((f"K7 {tag}",
                           lambda k7r=k7r: SB.fused_ln_mlp(*k7r)))
    by_clips[N_CLIPS]["K7"]["max_abs_err"] = max(
        by_clips[N_CLIPS]["K7"]["max_abs_err"],
        by_clips.pop(clips)["K7"]["max_abs_err"])
    del x, mlp
    _one_launch_checks(one_launch)
    del one_launch
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
            back_half_ms, n392)


def _device_seeded(shape, gen, scale=1.0):
    """bf16 normal values drawn on the card (a step's 48 clips of 16 frames
    are 154 M values at stage 0: drawn on the host they take seconds)."""
    return (scale * torch.randn(shape, generator=gen, device="cuda")).bfloat16()


def _pair_launched(run, n: int) -> None:
    """One call of ``run`` (K4 at N > 160) launches the rows and the columns
    CTA of the pair, and no capture holds attn_bwd_kernel (torch.profiler; a
    capture that lost events, even some of one call's, is taken again, up to
    PROFILE_TRIES captures)."""
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)     # the capture is running before run()
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        seen.append(sorted(set(n[:60] for n in names)))
        pair = {k: any(k + "<" in n for n in names)
                for k in ("attn_bwd_rows_kernel", "attn_bwd_cols_kernel",
                          "attn_bwd_kernel")}
        require(not pair["attn_bwd_kernel"],
                f"K4 at N = {n} launched attn_bwd_kernel: {seen[-1]}")
        if pair["attn_bwd_rows_kernel"] and pair["attn_bwd_cols_kernel"]:
            return
    require(False, f"K4 at N = {n}: no capture of {PROFILE_TRIES} held both "
            f"CTAs of the pair: {seen}")


def _k4_plain_in_chunks(k4, clips: int):
    """K4's plain version over the clips of ``k4`` in calls of ``clips``
    clips each: dy concatenated, the window-summed outputs (dqkv_w, dqkv_b,
    dproj_w, drel) added in f32."""
    from lrce_tpu_torch.ops import window_attn as WA

    x, g, rest = k4[0], k4[1], k4[2:]
    dys, sums = [], None
    for first in range(0, x.shape[0], clips):
        dy, *part = WA.window_attention_bwd_plain(
            x[first:first + clips], g[first:first + clips], *rest)
        dys.append(dy)
        sums = part if sums is None else [a + b for a, b in zip(sums, part)]
    return (torch.cat(dys), *sums)


def _k4_pair(gen, geo: Geometry):
    """K4 at the windows of ``geo`` (N392, N432), the rows / columns pair:
    every output against the plain version at every stage (shifted and not
    at stages 0-2), at a request's clips and a train step's (the plain
    version in chunks of ``geo.plain_clips`` clips where a step's do not
    fit: ``_k4_plain_in_chunks``), a second call bit-identical, the pair's
    two CTAs seen by the profiler; kernel time, plain time (all the chunk
    calls) and the bound, summed over the calls of a step. Returns {clips:
    sums} and the largest error."""
    from lrce_tpu_torch.models.swin3d import compute_shift_mask
    from lrce_tpu_torch.ops import window_attn as WA

    n = math.prod(geo.window)
    dgen = torch.Generator(device="cuda").manual_seed(n)
    out, worst = {}, 0.0
    for clips in geo.clips:
        sums = out[clips] = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                             "plain_chunk": []}
        for stage, (d, h, w, c, heads) in enumerate(geo.stages):
            x = _device_seeded((clips, d, h, w, c), dgen)
            g = _device_seeded((clips, d, h, w, c), dgen)
            p = _block_weights(c, heads, n, gen, None)
            bwd = [p[k] for k in ("ln1s", "ln1b", "qkv_w", "qkv_b",
                                  "proj_w", "rel_bias")]
            nwin = (d // geo.window[0], h // geo.window[1], w // geo.window[2])
            mask = torch.from_numpy(compute_shift_mask(
                (d, h, w), geo.window, geo.shift)).reshape(*nwin, n, n).cuda()
            pc = min(clips, geo.plain_clips[stage])
            sums["plain_chunk"].append(pc)
            kinds = (False, True) if stage < 3 else (False,)
            for masked in kinds:
                m, s = (mask, geo.shift) if masked else (None, NO_SHIFT)
                k4 = (x, g, *bwd, m, geo.window, heads, 1e-5, s)
                label = (f"K4 N {n} stage {stage} ({clips}, {d}, {h}, {w}, "
                         f"{c}) {'masked' if masked else 'unmasked'}")
                got = WA.window_attention_bwd(*k4)
                again = WA.window_attention_bwd(*k4)
                require(all(torch.equal(a, b) for a, b in zip(got, again)),
                        f"{label}: a second call differs")
                del again
                want = _k4_plain_in_chunks(k4, pc)
                for i, (a, b) in enumerate(zip(got, want)):
                    worst = max(worst, _compare(
                        f"{label} out{i}" + (f" (plain in chunks of {pc} "
                                             "clips)" if pc < clips else ""),
                        a, b))
                del got, want
                if clips == geo.clips[0]:
                    _pair_launched(lambda: WA.window_attention_bwd(*k4), n)
                it_k, it_p = (5, 2) if clips == geo.clips[-1] else (4, 4)
                p1, k1, k2, p2 = (_cuda_time_ms(f, i) for f, i in (
                    (lambda: _k4_plain_in_chunks(k4, pc), it_p),
                    (lambda: WA.window_attention_bwd(*k4), it_k),
                    (lambda: WA.window_attention_bwd(*k4), it_k),
                    (lambda: _k4_plain_in_chunks(k4, pc), it_p)))
                tk, tp = (k1 + k2) / 2, (p1 + p2) / 2
                work = _work("K4", clips, stage, masked, stages=geo.stages,
                             window=geo.window)
                bound, by = _bound_ms(work)
                calls = geo.k4_calls[stage] // len(kinds)
                for key, v in (("ms", tk), ("plain_ms", tp),
                               ("bound_ms", bound)):
                    sums[key] += calls * v
                print(f"[kernels] {label}: kernel {tk:.4f} ms, plain "
                      f"{tp:.4f} ms" + (f" ({clips // pc} calls of {pc} "
                                        "clips)" if pc < clips else "")
                      + f", bound {bound:.4f} ms ({by}: {work[0] / 1e9:.3f} "
                      f"GFLOP, {work[1] / 1e6:.3f} MB) per call; {calls} "
                      "call(s) a step", flush=True)
                del k4
            del x, g, mask
            torch.cuda.empty_cache()
        print(f"[kernels] K4 at N = {n}, the {sum(geo.k4_calls)} calls of "
              f"one {clips}-clip step: kernel {sums['ms']:.4f} ms, plain "
              f"{sums['plain_ms']:.4f} ms (each stage's plain calls of "
              f"{sums['plain_chunk']} clips), bound "
              f"{sums['bound_ms']:.4f} ms", flush=True)
    out["max_abs_err"] = worst
    return out


def _fwd_n392(gen):
    """K1, K3, K2, K6 (their attention on attn_fwd_big_kernel) and K5 at the
    16-frame window (8, 7, 7), N = 392, at a train step's 48 clips: each
    output held to its plain version, which runs the clips in chunks of
    N392_PLAIN_CLIPS (the outputs are per clip; its plain time is the total
    of the chunk calls; K5 in one call), timed beside its bound, summed over
    a step's calls (K6 half masked). Returns {kernel: sums}."""
    from lrce_tpu_torch.models.swin3d import compute_shift_mask
    from lrce_tpu_torch.ops import swin_block as SB
    from lrce_tpu_torch.ops import window_attn as WA

    dgen = torch.Generator(device="cuda").manual_seed(394)
    n = WINDOW16[0] * WINDOW16[1] * WINDOW16[2]
    clips = TRAIN_CLIPS
    sums = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "max_abs_err": 0.0, "plain_chunk": []}
            for k in ("K1", "K3", "K2", "K6", "K5")}

    def chunks(fn, args, pc):
        """fn over the clips of args[0] in calls of pc clips, joined."""
        return torch.cat([fn(args[0][f:f + pc], *args[1:])
                          for f in range(0, clips, pc)])

    def one(kernel, calls, label, run_k, run_p, work, pc):
        r = sums[kernel]
        got, want = run_k(), run_p()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        for i, (a, b) in enumerate(zip(got, want)):
            r["max_abs_err"] = max(r["max_abs_err"], _compare(
                f"{kernel} N 392 {label} out{i}" + (
                    f" (plain in chunks of {pc} clips)" if pc < clips
                    else ""), a, b))
        del got, want
        p1, k1, k2, p2 = (_cuda_time_ms(f, i) for f, i in (
            (run_p, 1), (run_k, 3), (run_k, 3), (run_p, 1)))
        tk, tp = (k1 + k2) / 2, (p1 + p2) / 2
        bound, by = _bound_ms(work)
        r["ms"] += calls * tk
        r["plain_ms"] += calls * tp
        r["bound_ms"] += calls * bound
        r["plain_chunk"].append(pc)
        print(f"[kernels] {kernel} N 392 {label}: kernel {tk:.4f} ms, plain "
              f"{tp:.4f} ms, bound {bound:.4f} ms ({by}) per call; {calls} "
              "call(s) a step", flush=True)

    for stage, (d, h, w, c, heads) in enumerate(STAGES16):
        pc = N392_PLAIN_CLIPS[stage]
        x = _device_seeded((clips, d, h, w, c), dgen)
        p = _block_weights(c, heads, n, gen, None)
        attn = [p[k] for k in ATTN_KEYS]
        mlp = [p[k] for k in MLP_KEYS]
        label = f"stage {stage} {tuple(x.shape)}"
        kw = dict(stages=STAGES16, window=WINDOW16)
        if stage == 3:
            k2 = (x, *attn, None, WINDOW16, heads)
            one("K2", CALLS_PER_FORWARD["K2"][stage], label,
                lambda: WA.fused_window_attention_hsplit(*k2),
                lambda: chunks(WA.window_attention_plain, k2, pc),
                _work("K2", clips, stage, **kw), pc)
            del x, p, attn, mlp, k2
            torch.cuda.empty_cache()
            continue
        nwin = (d // WINDOW16[0], h // WINDOW16[1], w // WINDOW16[2])
        mask = torch.from_numpy(compute_shift_mask(
            (d, h, w), WINDOW16, SHIFT)).reshape(*nwin, n, n).cuda()
        half = CALLS_PER_FORWARD["K1"][stage]
        k1 = (x, *attn, None, *mlp, None, None, WINDOW16, heads)
        one("K1", half, label, lambda: SB.fused_swin_block(*k1),
            lambda: chunks(SB.swin_block_plain, k1, pc),
            _work("K1", clips, stage, **kw), pc)
        q = _block_weights(c, heads, n, gen, 1)
        k3 = (x, *(q[k] for k in ATTN_KEYS), mask, *(q[k] for k in MLP_KEYS),
              None, None, WINDOW16, heads, (SHIFT,))
        one("K3", half, label + " k=1", lambda: SB.fused_swin_pair(*k3),
            lambda: chunks(SB.swin_pair_plain, k3, pc),
            _work("K3", clips, stage, masked=True, **kw), pc)
        for masked in (False, True):
            m, sh = (mask, SHIFT) if masked else (None, NO_SHIFT)
            k6 = (x, *attn, m, WINDOW16, heads, 1e-5, sh)
            one("K6", half, label + (" masked" if masked else " unmasked"),
                lambda: WA.fused_window_attention(*k6),
                lambda: chunks(WA.window_attention_plain, k6, pc),
                _work("K6", clips, stage, masked=masked, **kw), pc)
        g = _device_seeded((clips, d, h, w, c), dgen)
        dp = (torch.rand((clips,), generator=gen) < 0.8).float().cuda() / 0.8
        k5 = (x, g, *mlp[:5], dp, 1e-5)
        one("K5", CALLS_PER_BACKWARD["K5"][stage], label + " dp2",
            lambda: SB.mlp_bwd(*k5), lambda: SB.mlp_bwd_plain(*k5),
            _work("K5", clips, stage, with_dp=True, **kw), clips)
        del x, g, p, q, attn, mlp, mask, k1, k3, k6, k5
        torch.cuda.empty_cache()
    for k, r in sums.items():
        print(f"[kernels] {k} at N = 392, the calls of one {clips}-clip step "
              f"of 16 frames: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms (plain calls of {r['plain_chunk']} "
              f"clips), bound {r['bound_ms']:.4f} ms", flush=True)
    return sums


def phase_swinl():
    """Video Swin-L at the msvd-swinl384-train cell's shapes (N432: N = 432
    at every stage, C = 192-1536): the forward CTA alone and K4's pair at
    every stage (``_attn_core_big``, ``_k4_pair``), K2 at stages 2-3 (C =
    768 masked and not; C = 1536 with 48 heads, whose LN1 spans 1536
    columns) held to its plain version chunk by chunk and timed beside its
    bound, its forward CTA counted; LN1 + gather at C = 1536 alone; the
    stage 2-3 LN2 + MLP (``_swinl_mlp``: K7 at C = 768, K5 at C = 768 and
    1536); and a Swin-L stage of each route through ``BasicLayer`` with
    grad mode on and off, its launches and the tracer's counters counted
    (K4's pair and attn_fwd_big_kernel, never the plain block; K7 / K5 for LN2 + MLP at C > 512). Returns {"core": {clips:
    sums}, "K4": {clips: sums}, "K2" / "K7" / "K5": sums at a step's
    clips}."""
    from lrce_tpu_torch.models.swin3d import (BasicLayer, DeviceConstants,
                                              SwinConfig, compute_shift_mask)
    from lrce_tpu_torch.ops import gemm as G
    from lrce_tpu_torch.ops import window_attn as WA
    from lrce_tpu_torch.utils import trace

    geo, gen = N432, torch.Generator().manual_seed(432)
    n = math.prod(geo.window)
    require(WA.attn_fwd_cta(n, 32) == "attn_fwd_big_kernel"
            and WA.attn_supported(n, 32),
            f"N = {n}, head_dim 32: the shape rules name no kernel")
    core_rows, core = _attn_core_big(gen, geo)
    print(json.dumps({"attn_core_n432": core_rows}), flush=True)
    k4 = _k4_pair(gen, geo)
    worst = k4.pop("max_abs_err")

    dgen = torch.Generator(device="cuda").manual_seed(n + 2)
    clips = geo.clips[-1]
    k2 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    for stage in (2, 3):
        d, h, w, c, heads = geo.stages[stage]
        pc = geo.plain_clips[stage]
        x = _device_seeded((clips, d, h, w, c), dgen)
        p = _block_weights(c, heads, n, gen, None)
        attn = [p[k] for k in ATTN_KEYS]
        nwin = tuple(v // wv for v, wv in zip((d, h, w), geo.window))
        kinds = (False, True) if stage < 3 else (False,)
        for masked in kinds:
            mask = (torch.from_numpy(compute_shift_mask(
                (d, h, w), geo.window, geo.shift)).reshape(*nwin, n, n).cuda()
                if masked else None)
            args = (x, *attn, mask, geo.window, heads)
            label = (f"K2 N {n} stage {stage} ({clips}, {d}, {h}, {w}, {c}), "
                     f"{heads} heads, {'masked' if masked else 'unmasked'}")
            WA.attn_fwd_cta_launches(reset=True)
            _reset_counts()
            got = WA.fused_window_attention_hsplit(*args)
            ctas, counts = WA.attn_fwd_cta_launches(reset=True), _counts()
            require(ctas == _only_cta("attn_fwd_big_kernel")
                    and counts["K2"] == 1,
                    f"{label} launched {ctas}, K2 {counts['K2']} time(s); "
                    "expected attn_fwd_big_kernel and K2 once")

            def run_p():
                return torch.cat([WA.window_attention_plain(
                    x[f:f + pc], *args[1:]) for f in range(0, clips, pc)])

            k2["max_abs_err"] = max(k2["max_abs_err"], _compare(
                label + (f" (plain in chunks of {pc} clips)" if pc < clips
                         else ""), got, run_p()))
            del got
            p1, t1, t2, p2 = (_cuda_time_ms(f, i) for f, i in (
                (run_p, 1), (lambda: WA.fused_window_attention_hsplit(*args),
                             3),
                (lambda: WA.fused_window_attention_hsplit(*args), 3),
                (run_p, 1)))
            work = _work("K2", clips, stage, masked, stages=geo.stages,
                         window=geo.window)
            bound, by = _bound_ms(work)
            calls = K2_CALLS_SWINL[stage] // len(kinds)
            tk, tp = (t1 + t2) / 2, (p1 + p2) / 2
            for key, v in (("ms", tk), ("plain_ms", tp), ("bound_ms", bound)):
                k2[key] += calls * v
            print(f"[swinl] {label}: kernel {tk:.4f} ms, plain {tp:.4f} ms, "
                  f"bound {bound:.4f} ms ({by}: {work[0] / 1e9:.3f} GFLOP, "
                  f"{work[1] / 1e6:.3f} MB) per call; {calls} call(s) a step",
                  flush=True)
            del mask, args
        if stage == 3:      # LN1 + gather over 1536 columns, alone
            gam = 1.0 + 0.1 * torch.randn((c,), generator=gen).cuda()
            bet = 0.1 * torch.randn((c,), generator=gen).cuda()
            kw = dict(window=geo.window, gather=True)
            _compare(f"ln_rows ln1 C {c}, {clips} clips",
                     G.ln_rows(x, gam, bet, **kw),
                     G.ln_rows_plain(x, gam, bet, **kw))
            print(f"[swinl] ln_rows ln1 C {c}, {clips} clips: "
                  f"{_cuda_time_ms(lambda: G.ln_rows(x, gam, bet, **kw)):.4f}"
                  " ms", flush=True)
        del x, p, attn
        torch.cuda.empty_cache()
    print(f"[swinl] K2 at N = {n}, the {sum(K2_CALLS_SWINL)} calls of one "
          f"{clips}-clip step: kernel {k2['ms']:.4f} ms, plain "
          f"{k2['plain_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms",
          flush=True)
    mlp = _swinl_mlp(gen, dgen, geo, clips)

    # a stage of each route at Swin-L's widths, two clips: K1 / K3 with K6,
    # K5 and K4 (C = 192), K2 and K4 (C = 768 shifted, C = 1536 unshifted)
    # with LN2 + MLP through fused_ln_mlp: K7 and K5 at C = 768, the plain
    # forward and K5 at C = 1536; the tracer counts the blocks of each
    cfg = SwinConfig(window_size=(8, 12, 12))
    for c, heads, (d, h, w), want, k7 in (
            (192, 6, (3, 24, 24), {"K1": 1, "K3": 1, "K6": 2, "K5": 2,
                                   "K4": 2, "K2": 0, "K7": 0}, 0),
            (768, 24, (3, 24, 24), {"K2": 2, "K4": 2, "K7": 2, "K5": 2,
                                    "K1": 0, "K3": 0, "K6": 0}, 2),
            (1536, 48, (3, 12, 12), {"K2": 2, "K4": 2, "K7": 0, "K5": 2,
                                     "K1": 0, "K3": 0, "K6": 0}, 0)):
        layer = BasicLayer(c, 2, heads, cfg, False, torch.bfloat16,
                           torch.Generator().manual_seed(c)).cuda()
        x = _device_seeded((2, d, h, w, c), dgen)
        xs = x.detach().requires_grad_()
        _reset_counts()
        WA.attn_fwd_cta_launches(reset=True)
        trace.drain()
        trace.enable(detail=True)
        try:
            layer(xs, True, DeviceConstants()).float().sum().backward()
        finally:
            trace.disable()
        with_grad, ctas = _counts(), WA.attn_fwd_cta_launches(reset=True)
        counters = trace.drain()[1]
        _reset_counts()
        with torch.no_grad():
            layer(x, True, DeviceConstants())
        without = _counts()
        fwd = sum(want[k] for k in ("K1", "K3", "K2")) + want.get("K6", 0)
        wide = 2 if c > 512 else 0
        print(f"[route] Swin-L C {c}, {heads} heads, map {(d, h, w)}: with "
              f"grad {with_grad}, forward CTAs {ctas}, counters {counters}; "
              f"without grad {without}", flush=True)
        require(all(with_grad[k] == v for k, v in want.items())
                and ctas == _only_cta("attn_fwd_big_kernel", fwd)
                and xs.grad is not None
                and bool(torch.isfinite(xs.grad).all()),
                f"a Swin-L stage at C = {c} launched {with_grad} and the "
                f"forward CTAs {ctas}, expected {want} and "
                f"attn_fwd_big_kernel {fwd} times")
        require(counters.get("swin.wide_mlp_fused", 0) == wide
                and counters.get("swin.wide_mlp_k7", 0) == k7,
                f"a Swin-L stage at C = {c} counted {counters}, expected "
                f"{wide} fused LN2 + MLP blocks, {k7} of them on K7")
        require(all(without[k] == want[k] for k in ("K1", "K3", "K2", "K7"))
                and without["K5"] == 0,
                f"a Swin-L stage at C = {c} without grad launched {without}")
        del layer, x, xs
    worst = max(worst, k2["max_abs_err"], mlp.pop("max_abs_err"))
    print(f"[swinl] N = {n}, largest |kernel - plain| {worst:.4g}",
          flush=True)
    return {"core": core, "K4": k4, "K2": k2, **mlp}


def _swinl_mlp(gen, dgen, geo: Geometry, clips: int) -> dict:
    """LN2 + MLP + residual of Swin-L's K2-route blocks at a step's
    ``clips``, through ``fused_ln_mlp`` as the route runs them: K7 at
    stage 2 (C = 768, T = 103,680 rows at 60 clips), the plain forward at
    stage 3 (C = 1536, wider than K7 takes; no launch, bit-equal to
    ``ln_mlp_plain``), K5 the backward of both. Each against its plain
    version and timed beside its bound, summed over a step's calls (18
    blocks at stage 2, 2 at stage 3). Returns {"K7" / "K5": sums,
    "max_abs_err"}."""
    from lrce_tpu_torch.ops import swin_block as SB

    out = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
           for k in ("K7", "K5")}
    worst = 0.0
    for stage in (2, 3):
        d, h, w, c, heads = geo.stages[stage]
        calls = K2_CALLS_SWINL[stage]
        x = _device_seeded((clips, d, h, w, c), dgen)
        g = _device_seeded((clips, d, h, w, c), dgen)
        p = _block_weights(c, heads, 1, gen, None)
        mlp = [p[k] for k in MLP_KEYS]
        dp = (torch.rand((clips,), generator=gen) < 0.8).float().cuda() / 0.8
        label = f"stage {stage} {tuple(x.shape)}, FF {4 * c}, dp2"

        k7_args, k5_args = (x, *mlp, dp, 1e-5), (x, g, *mlp[:5], dp, 1e-5)

        def k7():
            with torch.no_grad():
                return SB.fused_ln_mlp(*k7_args)

        def plain7():
            return SB.ln_mlp_plain(*k7_args)

        cases = [("K5", lambda: SB.mlp_bwd(*k5_args),
                  lambda: SB.mlp_bwd_plain(*k5_args))]
        _reset_counts()
        got = k7()
        launched = _counts()["K7"]
        if SB.ln_mlp_supported(c, 4 * c):
            require(launched == 1, f"K7 {label}: {launched} launches")
            cases.insert(0, ("K7", k7, plain7))
        else:
            require(launched == 0 and torch.equal(got, plain7()),
                    f"fused_ln_mlp {label}: {launched} K7 launches, or its "
                    "plain forward differs from ln_mlp_plain")
            print(f"[swinl] fused_ln_mlp {label}: the plain forward, no "
                  f"launch, {_cuda_time_ms(k7, 3):.4f} ms a call",
                  flush=True)
        del got
        for kernel, run_k, run_p in cases:
            got, want = run_k(), run_p()
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            for i, (a, b) in enumerate(zip(got, want)):
                worst = max(worst, _compare(f"{kernel} {label} out{i}", a, b))
            del got, want
            p1, t1, t2, p2 = (_cuda_time_ms(f, i) for f, i in (
                (run_p, 1), (run_k, 5), (run_k, 5), (run_p, 1)))
            work = _work(kernel, clips, stage, with_dp=True,
                         stages=geo.stages, window=geo.window)
            bound, by = _bound_ms(work)
            tk, tp = (t1 + t2) / 2, (p1 + p2) / 2
            for key, v in (("ms", tk), ("plain_ms", tp), ("bound_ms", bound)):
                out[kernel][key] += calls * v
            print(f"[swinl] {kernel} {label}: kernel {tk:.4f} ms, plain "
                  f"{tp:.4f} ms, bound {bound:.4f} ms ({by}: "
                  f"{work[0] / 1e9:.3f} GFLOP, {work[1] / 1e6:.3f} MB) per "
                  f"call, {100 * bound / tk:.1f}% of it; {calls} call(s) a "
                  "step", flush=True)
        del x, g, p, mlp, k7_args, k5_args, cases
        torch.cuda.empty_cache()
    for kernel, r in out.items():
        print(f"[swinl] {kernel}, the LN2 + MLP calls of one {clips}-clip "
              f"step at stages 2-3: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms",
              flush=True)
    out["max_abs_err"] = worst
    return out


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


def _hold_to_plain(out: torch.Tensor, ref: torch.Tensor, shape: tuple,
                   label: str) -> float:
    """Logits of the kernel route against the plain route's: the shape,
    finite, relative L2 within FORWARD_REL_L2, and the same argmax wherever
    the plain route's top-2 margin is wider than twice the largest logit
    difference. Prints one line and returns the relative L2."""
    require(tuple(out.shape) == shape, f"{label}: logits shape "
            f"{tuple(out.shape)}, expected {shape}")
    require(bool(torch.isfinite(out).all()), f"{label}: non-finite logits")
    o, r = out.float(), ref.float()
    rel_l2 = ((o - r).norm() / r.norm()).item()
    max_abs = (o - r).abs().max().item()
    top2 = r.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1])
    same = (o.argmax(-1) == r.argmax(-1))
    decided = margin > 2 * max_abs
    print(f"{label}: rel_l2 {rel_l2:.4g} (limit {FORWARD_REL_L2}), max_abs "
          f"{max_abs:.4g}, argmax equal {int(same.sum())} of {len(same)}, "
          f"{int(decided.sum())} decided by the plain top-2 margin (smallest "
          f"margin {margin.min().item():.4g})", flush=True)
    require(rel_l2 <= FORWARD_REL_L2, f"{label}: disagrees with the plain "
            "route")
    require(bool(same[decided].all()),
            f"{label}: argmax differs where the margin decides it")
    return rel_l2


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
    require(all(counts[k] == 0 for k in ("K8", "K6", "K5", "K4")),
            "the eval forward launched a kernel that is not on its route")

    swin = model.video_extractor.swin
    swin.use_kernels = False
    e2e_forward(model, *requests[0])
    torch.cuda.synchronize()
    refs, lat_plain = serve("plain route")

    def check(outs, label):
        for i, (out, ref) in enumerate(zip(outs, refs)):
            _hold_to_plain(out, ref, (2, 1000), f"[forward] {label}, request "
                           f"{i}")

    check(outs, "kernel route")
    swin.use_kernels = True

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
    return launches, lat_kernels, lat_plain


def _train_batch(rng, questions: int, frames: int = 5):
    clips = rng.integers(0, 256, (questions, 3, frames, 224, 224, 3),
                         dtype=np.uint8)
    ids = rng.integers(1000, 30000, (questions, 32))
    mask = np.ones((questions, 32), np.int64)
    mask[::2, 24:] = 0
    types = np.zeros((questions, 32), np.int64)
    gt = rng.integers(0, 1000, (questions,))
    return clips, ids, mask, types, gt


def _flagship_train_model(seed: int = 0, frames: int = 5):
    from lrce_tpu_torch.models.e2e import E2EConfig, LRCEModel

    cfg = E2EConfig(num_classes=1000, temporal_scale=(3,), text_seq_len=32,
                    frame_sample_size=frames)
    return LRCEModel(cfg, dtype=torch.float32, compute_dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(seed))


def _probes(model) -> dict:
    """A weight of each parameter group, to see a train step move it."""
    return {"fusion_model": model.fusion_model.final_fc.weight,
            "text_extractor":
                model.text_extractor.bert.encoder.layer[0].intermediate.dense.weight,
            "video_extractor":
                model.video_extractor.swin.layers[0].blocks[0].attn.qkv.weight}


def _counted_step(agent, batch, per_step: dict, probes: dict):
    """One ``agent.step`` on the card: a finite loss, ``per_step``'s
    launches exactly, every probe moved. Returns (loss, host ms, counts)."""
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


def _train_per_step() -> dict:
    """Launches of one train step on the kernel route."""
    return {"K7": 0, "K8": 0,
            **{k: sum(v) for k, v in {**CALLS_PER_FORWARD,
                                      **CALLS_PER_BACKWARD}.items()}}


def phase_train():
    from lrce_tpu_torch.ops import window_attn as WA
    from lrce_tpu_torch.train.agent import AgentOE, default_args

    per_step = _train_per_step()
    model = _flagship_train_model()
    agent = AgentOE(model, default_args(), log_enabled=False, seed=0)
    print(f"[train] flagship, f32 parameters, bf16 compute; lr {agent.lrs}, "
          f"reg {agent.reg_strength}, dropout {model.cfg.drop_out_rate}, "
          f"drop-path {model.cfg.swin.drop_path_rate}", flush=True)
    rng = np.random.default_rng(7)
    batches = [_train_batch(rng, TRAIN_BATCH) for _ in range(TRAIN_STEPS + 1)]
    probes = _probes(model)

    def one_step(batch):
        """A counted step; at 5 frames (N = 147) all 46 forward attention
        calls run attn_fwd_kernel."""
        WA.attn_fwd_cta_launches(reset=True)
        out = _counted_step(agent, batch, per_step, probes)
        ctas = WA.attn_fwd_cta_launches(reset=True)
        require(ctas == _only_cta("attn_fwd_kernel", sum(ATTN_CORE_CALLS)),
                f"a 5-frame step launched the forward CTAs {ctas}, expected "
                f"attn_fwd_kernel {sum(ATTN_CORE_CALLS)} times")
        return out

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
    checkpoints from the writer thread; then
    ``best.pt`` reloaded into a fresh model must reproduce its validation."""
    from lrce_tpu_torch.data.loader import DataLoader
    from lrce_tpu_torch.train.agent import AgentOE, default_args

    train_step = _train_per_step()
    eval_step = {**{k: 0 for k in train_step},
                 **{k: sum(v) for k, v in CALLS_PER_FORWARD.items()}}
    train_dl = DataLoader(_SyntheticQA(RUN_TRAIN_ITEMS, 21), TRAIN_BATCH,
                          shuffle=True, seed=0, num_workers=2)
    val_dl = DataLoader(_SyntheticQA(RUN_VAL_ITEMS, 22), TRAIN_BATCH,
                        shuffle=False, num_workers=2)
    n_steps = len(train_dl)
    require(n_steps == 4 and len(val_dl) == 1, "the run is 4 steps + 1 val")

    with tempfile.TemporaryDirectory(prefix="lrce_smoke_") as log_dir:
        model = _flagship_train_model()
        args = default_args(epoch=1, ckpt_interval=1, log_dir=log_dir,
                            async_checkpoint=True)
        agent = AgentOE(model, args, seed=0)
        print(f"[run] flagship, f32 parameters, bf16 compute; "
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
        fresh = AgentOE(_flagship_train_model(seed=5),
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


def _route_parity(model, batch, tag: str) -> float:
    """One forward + backward of ``model`` on ``batch`` (dropout and
    drop-path off: training=False, grad enabled) on the kernel route and on
    the plain route: the task loss (TRAIN_LOSS_REL) and its gradients per
    group (each Swin stage, BERT, the fusion; TRAIN_GRAD_REL_L2). Returns
    the worst gradient relative L2."""
    from lrce_tpu_torch.models.e2e import e2e_apply
    from lrce_tpu_torch.train import losses as L

    groups = {f"swin stage {i}": f"video_extractor.swin.layers.{i}."
              for i in range(4)}
    groups.update({"bert": "text_extractor.", "fusion": "fusion_model."})

    def grads(use_kernels):
        model.video_extractor.swin.use_kernels = use_kernels
        model.zero_grad(set_to_none=True)
        loss = L.cross_entropy(e2e_apply(model, *batch[:4]), batch[4])
        loss.backward()
        named = dict(model.named_parameters())
        flat = {}
        for label, pre in groups.items():
            flat[label] = torch.cat([p.grad.float().reshape(-1)
                                     for n, p in named.items()
                                     if n.startswith(pre) and p.grad is not None])
        return loss.item(), flat

    lk, gk = grads(True)
    lp, gp = grads(False)
    model.video_extractor.swin.use_kernels = True
    model.zero_grad(set_to_none=True)
    rel_loss = abs(lk - lp) / abs(lp)
    print(f"{tag} loss kernel route {lk:.6f}, plain route {lp:.6f}, "
          f"relative difference {rel_loss:.3g} (limit {TRAIN_LOSS_REL})",
          flush=True)
    require(math.isfinite(lk) and rel_loss <= TRAIN_LOSS_REL,
            f"{tag} kernel-route loss disagrees with the plain route")
    worst = 0.0
    for label in groups:
        a, b = gk[label], gp[label]
        require(bool(torch.isfinite(a).all()), f"{label}: non-finite gradient")
        rel = ((a - b).norm() / b.norm()).item()
        worst = max(worst, rel)
        print(f"{tag} {label}: gradient relative L2 {rel:.4g} (limit "
              f"{TRAIN_GRAD_REL_L2}), |grad| {b.norm().item():.4g}", flush=True)
        require(rel <= TRAIN_GRAD_REL_L2,
                f"{tag} {label}: kernel-route gradients disagree with the "
                "plain route")
    return worst


def phase_route_parity():
    """One forward + backward, kernel route (the stage-3 MLP through K7)
    vs plain route, dropout and drop-path off (training=False, grad
    enabled), the task loss's gradients per group."""
    model = _flagship_train_model()
    batch = [torch.from_numpy(a).cuda()
             for a in _train_batch(np.random.default_rng(11), 2)]
    worst = _route_parity(model, batch, "[parity]")
    del model
    torch.cuda.empty_cache()
    return worst


def phase_frames16(card: str):
    """16-frame clips through the flagship's training path (f32 parameters,
    bf16 compute; ``frame_sample_size`` 16, as a config JSON sets it): the
    window (8, 7, 7), N = 392 at every stage, trains on K1 / K3 / K2 with
    K6 / K5 / K4 (its rows / columns pair) in the backward. At 2 questions x
    3 clips the kernel route against the plain route (``_route_parity``: the
    loss 1e-2, per-group gradients 1e-1) and a request's logits
    (FORWARD_REL_L2); then AgentOE (the config defaults) takes a warm-up and
    FRAMES16_STEPS steps at 16 questions x 3 clips on the kernel route
    alone, each with a train step's launches (K4 24) and its 46 forward
    attention calls all on attn_fwd_big_kernel: the plain route keeps
    f32 (N, N) scores of every window-head, ~58 GB for one saved tensor at
    48 clips. One ``[frames16]`` line: parity, step ms, peak, the card."""
    from lrce_tpu_torch.models.e2e import e2e_forward
    from lrce_tpu_torch.ops import window_attn as WA
    from lrce_tpu_torch.train.agent import AgentOE, default_args

    t0 = time.perf_counter()
    model = _flagship_train_model(frames=16)
    rng = np.random.default_rng(16)
    batch = [torch.from_numpy(a).cuda() for a in _train_batch(rng, 2, 16)]
    worst = _route_parity(model, batch, "[frames16]")
    with torch.no_grad():
        out = e2e_forward(model, *batch[:4])
        model.video_extractor.swin.use_kernels = False
        ref = e2e_forward(model, *batch[:4])
        model.video_extractor.swin.use_kernels = True
    logits_rel = _hold_to_plain(out, ref, (2, 1000),
                                "[frames16] request logits vs plain route")
    del out, ref, batch

    per_step = _train_per_step()
    agent = AgentOE(model, default_args(), log_enabled=False, seed=0)
    batches = [_train_batch(rng, FRAMES16_BATCH, 16)
               for _ in range(FRAMES16_STEPS + 1)]
    probes = _probes(model)

    def step(b):
        """A counted step; every forward attention call of it (24 in the
        forward, K6's 22 in the backward) on attn_fwd_big_kernel."""
        WA.attn_fwd_cta_launches(reset=True)
        out = _counted_step(agent, b, per_step, probes)
        ctas = WA.attn_fwd_cta_launches(reset=True)
        require(ctas == _only_cta("attn_fwd_big_kernel",
                                  sum(ATTN_CORE_CALLS)),
                f"a 16-frame step launched the forward CTAs {ctas}, expected "
                f"attn_fwd_big_kernel {sum(ATTN_CORE_CALLS)} times")
        return (*out, ctas)

    loss, ms, _, _ = step(batches[0])
    print(f"[frames16] warm-up step: loss {loss:.5f}, {ms:.1f} ms", flush=True)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for b in batches[1:]:
        loss, ms, counts, ctas = step(b)
        times.append(ms)
        print(f"[frames16] step: loss {loss:.5f}, {ms:.1f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    report = {"parity_worst_grad_rel_l2": worst, "logits_rel_l2": logits_rel,
              "step_ms": times, "peak_gib": peak, "launches": counts,
              "attn_ctas": ctas, "wall_s": time.perf_counter() - t0}
    print(f"[frames16] {card}; {FRAMES16_STEPS} steps of {FRAMES16_BATCH} "
          f"questions x 3 clips x 16 frames: step ms "
          f"{', '.join(f'{t:.1f}' for t in times)}, peak {peak:.2f} GiB, "
          f"launches per step {counts}, forward attention CTAs per step "
          f"{ctas}; route parity worst gradient rel L2 "
          f"{worst:.4g}, logits rel L2 {logits_rel:.4g}; phase "
          f"{report['wall_s']:.1f} s", flush=True)
    del agent, model
    torch.cuda.empty_cache()
    return report


def _cli_host_ms(dataset) -> dict:
    """Host ms per item of the loader's work, on the dataset's first
    CLI_HOST_ITEMS items alone: native GIF probe + decode (up to the last
    sampled frame), the resize of the 15 sampled frames, the tokenizer, and
    the whole ``dataset[i]``."""
    from lrce_tpu_torch import native
    from lrce_tpu_torch.data.sampling import clip_indices

    sums = {"decode": 0.0, "resize": 0.0, "tokenize": 0.0, "item": 0.0}
    items = min(CLI_HOST_ITEMS, len(dataset))
    for i in range(items):
        path = os.path.join(dataset.videos_path, dataset._get_video_name(i))
        t0 = time.perf_counter()
        _, _, n = native.gif_probe(path)
        idx = clip_indices(n, dataset.frames_per_clip, dataset.temporal_scale)
        frames = native.gif_decode(path, max_frames=int(idx.max()) + 1)
        t1 = time.perf_counter()
        for j in idx.reshape(-1):
            native.resize_bilinear(frames[int(j)], dataset.frame_size)
        t2 = time.perf_counter()
        dataset._get_texts(i)
        t3 = time.perf_counter()
        dataset[i]
        t4 = time.perf_counter()
        for key, dt in zip(sums, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            sums[key] += dt * 1e3
    return {k: v / items for k, v in sums.items()}


def phase_cli(card: str):
    """The file-based path through the port's command lines: a TGIF-frameqa
    dataset written to disk (GIFs by ``synth.write_gif``, tab-separated
    questions, a vocab.txt), the native library built and required, decoded clips held
    byte for byte against the frames written, then ``cli.train.main`` for
    one epoch at full width (Swin-B, BERT-base, 12 fusion layers, oe, 1000
    classes) and ``cli.eval.main`` on its ``best.pt``."""
    from lrce_tpu_torch import native
    from lrce_tpu_torch.cli import eval as cli_eval
    from lrce_tpu_torch.cli import train as cli_train
    from lrce_tpu_torch.config import parse_arg_eval, parse_arg_train
    from lrce_tpu_torch.data.sampling import clip_indices
    from lrce_tpu_torch.tools.synth import write_tgif_frameqa

    core, video = native.built(native.CORE), native.built(native.VIDEO)
    require(core.lib is not None and native.native_available(),
            "the native library did not build")
    print(f"[cli] native library: g++ {core.build_seconds:.2f} s; video "
          f"library (libav*) "
          f"{'built, g++ %.2f s' % video.build_seconds if video.lib else 'not built'}",
          flush=True)
    train_step = {"K7": 0, "K8": 0,
                  **{k: sum(v) for k, v in {**CALLS_PER_FORWARD,
                                            **CALLS_PER_BACKWARD}.items()}}
    eval_step = {"K6": 0, "K5": 0, "K4": 0, "K7": 0, "K8": 0,
                 **{k: sum(v) for k, v in CALLS_PER_FORWARD.items()}}
    real_factory, real_loader = cli_train.agent_factory, cli_train.DataLoader
    old_vocab = os.environ.get("LRCE_TPU_BERT_VOCAB")
    steps = []          # (is_train, counts, host start s, start ev, end ev)
    waits = []          # (host s after the wait, ms) per batch fetched
    items = []          # (host start s, host end s, split size) per item

    class TimedItems:
        """The dataset, with the host span of each item fetched."""

        def __init__(self, dataset):
            self.dataset = dataset

        def __len__(self):
            return len(self.dataset)

        def __getitem__(self, i):
            t = time.perf_counter()
            out = self.dataset[i]
            items.append((t, time.perf_counter(), len(self.dataset)))
            return out

    class TimedLoader(real_loader):
        def __init__(self, dataset, *a, **k):
            super().__init__(TimedItems(dataset), *a, **k)

        def __iter__(self):
            it = super().__iter__()
            while True:
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                now = time.perf_counter()
                waits.append((now, (now - t) * 1e3))
                yield batch

    def factory(task_type):
        class Instrumented(real_factory(task_type)):
            def __init__(self, model, *a, **k):
                super().__init__(model, *a, **k)
                self.probes = {
                    "fusion_model": model.fusion_model.final_fc.weight,
                    "text_extractor": model.text_extractor.bert.encoder
                    .layer[0].intermediate.dense.weight,
                    "video_extractor": model.video_extractor.swin.layers[0]
                    .blocks[0].attn.qkv.weight}
                self.before = {n: p.detach().clone()
                               for n, p in self.probes.items()}

            def dispatch(self, *batch, is_train):
                host = time.perf_counter()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                _reset_counts()
                start.record()
                out = super().dispatch(*batch, is_train=is_train)
                end.record()
                steps.append((is_train, _counts(), host, start, end))
                return out

        return Instrumented

    with tempfile.TemporaryDirectory(prefix="lrce_cli_") as root:
        data = os.path.join(root, "tgif")
        written = write_tgif_frameqa(data, 31, CLI_TRAIN_QUESTIONS,
                                     CLI_TEST_QUESTIONS)
        os.environ["LRCE_TPU_BERT_VOCAB"] = written["vocab"]
        try:
            argv = ["--dataset", "tgif-frameqa", "--dataset-dir", data]
            train_args = parse_arg_train(argv + [
                "--log-dir", os.path.join(root, "runs"), "--epoch", "1",
                "--async-checkpoint"])
            batch = train_args.batch_size

            # the data layer alone: native tokenizer, clips against the
            # frames written
            (dataset,) = cli_train.build_datasets(train_args, ("train",))
            require(isinstance(dataset.tokenizer._native,
                               native.NativeWordPiece),
                    "the tokenizer did not take the native WordPiece")
            sizes = {name: f.shape[1:] for name, (f, _) in
                     written["gifs"].items()}
            by_size = {}
            for i, row in enumerate(dataset.label_file):
                by_size.setdefault(sizes[row["gif_name"]] == (224, 224), i)
            require(set(by_size) == {True, False},
                    "the questions do not cover both GIF sizes")
            i = by_size[True]
            frames, palette = written["gifs"][dataset.label_file[i]["gif_name"]]
            idx = clip_indices(len(frames), dataset.frames_per_clip,
                               dataset.temporal_scale)
            clips = dataset[i][0]
            require(clips.dtype == np.uint8 and np.array_equal(
                clips, palette[frames[idx]]),
                "decoded clips differ from the frames written")
            other = dataset[by_size[False]][0]
            require(other.shape == (3, 5, 224, 224, 3)
                    and other.dtype == np.uint8,
                    f"the 320 x 240 GIF gave {other.shape} {other.dtype}")
            host_ms = _cli_host_ms(dataset)
            print(f"[cli] dataset: {len(written['gifs'])} GIFs, "
                  f"{CLI_TRAIN_QUESTIONS} train / {CLI_TEST_QUESTIONS} test "
                  f"questions; item {i}'s clips {clips.shape} equal the "
                  f"frames written at clip_indices; host ms per item "
                  f"{ {k: round(v, 3) for k, v in host_ms.items()} }",
                  flush=True)
            del dataset

            cli_train.agent_factory = factory
            cli_eval.agent_factory = factory
            cli_train.DataLoader = TimedLoader
            cli_eval.DataLoader = TimedLoader
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer = cli_train.main(train_args)
            torch.cuda.synchronize()
            train_wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            train_steps, train_waits = list(steps), list(waits)
            train_items = sorted(it[:2] for it in items
                                 if it[2] == CLI_TRAIN_QUESTIONS)
            require(math.isfinite(trainer.last_train_loss)
                    and math.isfinite(trainer.last_loss),
                    f"non-finite loss: train {trainer.last_train_loss}, "
                    f"validation {trainer.last_loss}")
            for name, p in trainer.probes.items():
                require(not torch.equal(trainer.before[name], p.detach()),
                        f"the train CLI left {name}'s parameters unchanged")
            files = sorted(os.listdir(trainer.args.ckpt_dir))
            require("best.pt" in files, f"no best.pt in {files}")
            require(os.path.isfile(os.path.join(trainer.args.log_dir,
                                                "config.json")),
                    "no config.json")
            best = os.path.join(trainer.args.ckpt_dir, "best.pt")
            train_loss = trainer.last_train_loss
            del trainer
            torch.cuda.empty_cache()

            steps.clear()
            t0 = time.perf_counter()
            evaluator = cli_eval.main(parse_arg_eval(argv + [
                "--model-path", best]))
            torch.cuda.synchronize()
            eval_wall = time.perf_counter() - t0
            require(math.isfinite(evaluator.last_loss)
                    and math.isfinite(evaluator.last_metric_val),
                    f"eval CLI: loss {evaluator.last_loss}, metric "
                    f"{evaluator.last_metric_val}")
            eval_loss, eval_metric = (evaluator.last_loss,
                                      evaluator.last_metric_val)
            eval_steps = list(steps)
            del evaluator
            torch.cuda.empty_cache()
        finally:
            cli_train.agent_factory = cli_eval.agent_factory = real_factory
            cli_train.DataLoader = cli_eval.DataLoader = real_loader
            if old_vocab is None:
                os.environ.pop("LRCE_TPU_BERT_VOCAB", None)
            else:
                os.environ["LRCE_TPU_BERT_VOCAB"] = old_vocab

    n_train = -(-CLI_TRAIN_QUESTIONS // batch)
    n_val = -(-CLI_TEST_QUESTIONS // batch)
    require([st[0] for st in train_steps] == [True] * n_train + [False] * n_val,
            f"the train CLI took {[st[0] for st in train_steps]} steps "
            f"(train True), expected {n_train} train then {n_val} validation")
    require(len(eval_steps) == n_val and not any(st[0] for st in eval_steps),
            f"the eval CLI took {len(eval_steps)} steps, expected {n_val}")
    totals = {k: 0 for k in train_step}
    for is_train, counts, *_ in train_steps + eval_steps:
        want = train_step if is_train else eval_step
        for k, n in want.items():
            require(counts[k] == n, f"{k} launched {counts[k]} times in a "
                    f"{'train' if is_train else 'eval'} step of the CLI, "
                    f"expected {n}")
            if is_train:
                totals[k] += counts[k]
    for k in ("K1", "K3", "K2", "K6", "K5", "K4"):
        require(totals[k] > 0, f"{k} never launched on the CLI's path")
    step_ms = [st[3].elapsed_time(st[4]) for st in train_steps[:n_train]]
    starts = [st[2] for st in train_steps[:n_train]]
    # loader waits between one train step's dispatch and the next, as a
    # share of that interval; the steps after the first CLI_LOOKAHEAD + 1
    # read the loader's rate, not its lookahead
    shares, intervals = [], []
    for a, b in zip(starts, starts[1:]):
        waited = sum(ms for at, ms in train_waits if a < at <= b)
        shares.append(waited / ((b - a) * 1e3))
        intervals.append((b - a) * 1e3)
    first_wait = sum(ms for at, ms in train_waits if at <= starts[0])
    steady = slice(CLI_LOOKAHEAD + 1, None)
    require(len(shares[steady]) >= 10,
            f"only {len(shares[steady])} steps after the loader's lookahead")
    steady_share = (sum(s * t for s, t in zip(shares[steady],
                                             intervals[steady]))
                    / sum(intervals[steady]))
    # the producer fetches one batch's items (in call order) before it
    # starts the next: each batch's busy span, beside the step interval
    require(len(train_items) == CLI_TRAIN_QUESTIONS,
            f"{len(train_items)} train items fetched, expected "
            f"{CLI_TRAIN_QUESTIONS}")
    busy = [(max(e for _, e in chunk) - chunk[0][0]) * 1e3
            for chunk in (train_items[j:j + batch]
                          for j in range(0, len(train_items), batch))]
    busy_ratio = (sum(busy[steady]) / len(busy[steady])
                  / (sum(intervals[steady]) / len(intervals[steady])))
    # the first step that starts after the producer's last item: the step
    # intervals after the lookahead with the loader at work and after it
    done = next((k for k, t in enumerate(starts)
                 if t > max(e for _, e in train_items)), n_train)
    loading = intervals[CLI_LOOKAHEAD + 1:max(done - 1, CLI_LOOKAHEAD + 1)]
    idle = intervals[done:]
    print(f"[cli] {card}; train CLI (tgif-frameqa, Swin-B + BERT-base, oe, "
          f"batch {batch}, {n_train} steps + {n_val} validation steps, "
          f"async checkpoints): {train_wall:.2f} s wall, train loss "
          f"{train_loss:.5f}, step ms on the device "
          f"{[round(t, 1) for t in step_ms]}, step intervals on the host ms "
          f"{[round(t, 1) for t in intervals]}, loader-wait share per step "
          f"{[round(x, 4) for x in shares]}, before steps "
          f"{CLI_LOOKAHEAD + 3}-{n_train} {steady_share:.4f}, first batches "
          f"{first_wait:.1f} ms; the loader's busy ms per batch "
          f"{[round(t, 1) for t in busy]}, batches "
          f"{CLI_LOOKAHEAD + 2}-{n_train} {busy_ratio:.4f} of a step "
          f"interval; the producer's last item ended before step "
          f"{done + 1}: mean step interval ms while it loads "
          f"{sum(loading) / max(len(loading), 1):.1f}, after "
          f"{sum(idle) / max(len(idle), 1):.1f}; "
          f"peak device memory {peak:.2f} GiB, launches per train step "
          f"{train_steps[0][1]}; eval CLI on best.pt: {eval_wall:.2f} s wall, "
          f"loss {eval_loss:.5f}, accuracy {eval_metric:.4f}, launches per "
          f"step {eval_steps[0][1]}; host ms per item "
          f"{ {k: round(v, 3) for k, v in host_ms.items()} }", flush=True)
    return {"launches": totals, "step_ms": step_ms, "wait_share": shares,
            "steady_wait_share": steady_share, "busy_ratio": busy_ratio,
            "host_ms": host_ms, "train_s": train_wall, "eval_s": eval_wall,
            "peak": peak}


# ---------------------------------------------------------------------------
# Across ranks: the train_ddp CLI over NCCL, two ranks sharing the card
# ---------------------------------------------------------------------------

# the train_ddp CLI's run: the legacy parser's temporal scale [1, 2, 3] (6
# clips a question), 8 questions a step (48 clips), 4 train and 2
# validation steps
DDP_CLI_BATCH = 8
DDP_CLI_QUESTIONS = (32, 16)
# two ranks on the card: 4 questions x 3 clips each, 2 steps, against one
# process on the 8 questions
DDP_QUESTIONS = 4
DDP_STEPS = 2
DDP_GROUPS = ("fusion_model", "text_extractor", "video_extractor")
# route parity's limits: the step's loss, each group's gradient and each
# group's update. AdamW's first update is lr sign(g) for most elements, so
# bf16 noise in a gradient near 0 flips its sign; the update is held where
# every step's one-process gradient so far is above DDP_DECIDED of its
# group's RMS, and the rest of it is the gradient's to hold
DDP_LOSS_REL = TRAIN_LOSS_REL
DDP_GRAD_REL = TRAIN_GRAD_REL_L2
DDP_UPDATE_REL = 1e-1
DDP_DECIDED = 0.1
# a collective that waits longer than this fails its rank (and the run)
DDP_TIMEOUT = datetime.timedelta(seconds=180)


def _ddp_cfg():
    """The flagship with dropout and drop-path 0 (the ranks draw their own
    masks; parity with one process needs none)."""
    from lrce_tpu_torch.models import bert as PB
    from lrce_tpu_torch.models import swin3d as PSw
    from lrce_tpu_torch.models.e2e import E2EConfig

    return E2EConfig(num_classes=1000, temporal_scale=(3,), text_seq_len=32,
                     drop_out_rate=0.0,
                     bert=PB.BERT_BASE._replace(hidden_dropout=0.0,
                                                attention_dropout=0.0),
                     swin=PSw.SWIN_BASE._replace(drop_path_rate=0.0))


def _ddp_batches(questions: int):
    """DDP_STEPS global batches of 2 x ``questions`` questions."""
    rng = np.random.default_rng(43)
    return [_train_batch(rng, 2 * questions) for _ in range(DDP_STEPS)]


def _group_flats(state: dict) -> dict:
    """{group: the group's tensors of ``state`` flattened in f32, in the
    state dict's order}."""
    return {g: torch.cat([t.detach().float().reshape(-1)
                          for k, t in state.items() if k.startswith(g + ".")])
            for g in DDP_GROUPS}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _decided(grads: list) -> torch.Tensor:
    """Where every gradient of ``grads`` (one group's, step by step) is
    above DDP_DECIDED of its RMS: there AdamW's update does not hang on the
    sign of bf16 noise."""
    mask = None
    for g in grads:
        g = g.float()
        m = g.abs() > DDP_DECIDED * g.square().mean().sqrt()
        mask = m if mask is None else mask & m
    return mask


def _ddp_rank(device, ref_path: str, questions: int) -> list:
    """Both ranks of the checks, mode by mode, each on a fresh flagship
    from the seed: "ddp" (data 2, DDP_STEPS steps), "model"
    (tensor-parallel 2) and "fsdp" (fsdp 2), one step each for the last
    two. Per step: the global loss and count, launches, host ms, the
    per-group gradient and update (where ``_decided``) against the
    one-process reference in ``ref_path``, and (ddp) whether rank 0's
    parameters equal this rank's bit for bit."""
    import torch.distributed as dist

    from lrce_tpu_torch.models.e2e import LRCEModel
    from lrce_tpu_torch.parallel import mesh as PM
    from lrce_tpu_torch.parallel import sharding as PS
    from lrce_tpu_torch.train.agent import AgentOE, default_args

    ref = torch.load(ref_path, weights_only=True)
    runs = {}
    for mode in ("ddp", "model", "fsdp"):
        fsdp, model_axis = {"ddp": (1, 1), "fsdp": (2, 1),
                            "model": (1, 2)}[mode]
        t0 = time.perf_counter()
        layout = PM.make_layout(fsdp, model_axis, "cuda")
        model = LRCEModel(_ddp_cfg(), dtype=torch.float32,
                          compute_dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0))
        before = _group_flats(model.state_dict())
        agent = AgentOE(model, default_args(), log_enabled=False,
                        layout=layout)
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for i, batch in enumerate(_ddp_batches(questions)[
                :DDP_STEPS if mode == "ddp" else 1]):
            # a tensor-parallel pair takes the whole batch, batch ranks
            # their half each
            part = [np.split(b, layout.n_batch)[layout.batch_rank]
                    for b in batch]
            torch.cuda.synchronize()
            dist.barrier()
            _reset_counts()
            t = time.perf_counter()
            loss, _, total = agent.step(*part, is_train=True)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            counts = _counts()
            grads = _group_flats(PS.full_grads(model, layout))
            state = (PS.full_state_dict(model, layout) if agent.sharded
                     else model.state_dict())
            after = _group_flats(state)
            del state
            same = None
            if mode == "ddp":
                # rank 0's parameters against this rank's, bit for bit
                same = True
                for g in DDP_GROUPS:
                    other = after[g].clone()
                    dist.broadcast(other, 0)
                    same = same and torch.equal(other, after[g])
                    del other
            update_rel, decided = {}, {}
            for g in DDP_GROUPS:
                mask = _decided([ref["grads"][j][g].cuda()
                                 for j in range(i + 1)])
                update_rel[g] = _rel((after[g] - before[g])[mask],
                                     ref["updates"][i][g].cuda()[mask])
                decided[g] = float(mask.float().mean())
                del mask
            steps.append({
                "loss": loss, "total": total, "ms": ms, "counts": counts,
                "grad_rel": {g: _rel(grads[g], ref["grads"][i][g].cuda())
                             for g in DDP_GROUPS},
                "update_rel": update_rel, "decided": decided, "same": same})
            before = after
            del grads
        comm_ms = None
        if mode == "ddp":
            # the gradient's bytes all-reduced alone over gloo (through
            # the host), beside the step: no NCCL figure
            flat = torch.zeros(sum(p.numel() for p in model.parameters()),
                               device=device)
            dist.all_reduce(flat)
            torch.cuda.synchronize()
            t = time.perf_counter()
            dist.all_reduce(flat)
            torch.cuda.synchronize()
            comm_ms = (time.perf_counter() - t) * 1e3
            del flat
        runs[mode] = {"steps": steps, "comm_ms": comm_ms,
                      "peak": torch.cuda.max_memory_allocated() / 2**30,
                      "wall_s": time.perf_counter() - t0}
        del agent, model, before, after
        torch.cuda.empty_cache()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {"rank": dist.get_rank(), "runs": runs})
    return every


def phase_ddp(card: str):
    """Training across ranks on the card, through the entry points a user
    calls: ``cli.train_ddp.main`` over NCCL at world size
    ``torch.cuda.device_count()`` (one card: a one-rank NCCL group, DDP
    around the full-width model) and ``cli.eval.main`` on its ``best.pt``,
    the launches of every step counted (in this process: one card); then
    ``phase_ddp_ranks``."""
    from lrce_tpu_torch.cli import eval as cli_eval
    from lrce_tpu_torch.cli import train as cli_train
    from lrce_tpu_torch.cli import train_ddp as cli_train_ddp
    from lrce_tpu_torch.config import parse_arg_eval
    from lrce_tpu_torch.parallel import mesh as PM
    from lrce_tpu_torch.tools.synth import write_tgif_frameqa

    train_step = {"K7": 0, "K8": 0,
                  **{k: sum(v) for k, v in {**CALLS_PER_FORWARD,
                                            **CALLS_PER_BACKWARD}.items()}}
    eval_step = {"K6": 0, "K5": 0, "K4": 0, "K7": 0, "K8": 0,
                 **{k: sum(v) for k, v in CALLS_PER_FORWARD.items()}}
    world = torch.cuda.device_count()
    steps = []
    real_factory = cli_train.agent_factory

    def factory(task_type):
        class Counted(real_factory(task_type)):
            def dispatch(self, *batch, is_train):
                torch.cuda.synchronize()
                _reset_counts()
                t = time.perf_counter()
                out = super().dispatch(*batch, is_train=is_train)
                torch.cuda.synchronize()
                steps.append((is_train, _counts(),
                              (time.perf_counter() - t) * 1e3))
                return out

        return Counted

    old_vocab = os.environ.get("LRCE_TPU_BERT_VOCAB")
    with tempfile.TemporaryDirectory(prefix="lrce_ddp_") as root:
        data = os.path.join(root, "tgif")
        written = write_tgif_frameqa(data, 41, *DDP_CLI_QUESTIONS)
        os.environ["LRCE_TPU_BERT_VOCAB"] = written["vocab"]
        try:
            argv = ["--dataset", "tgif-frameqa", "--dataset-dir", data,
                    "--batch-size", str(DDP_CLI_BATCH)]
            args = cli_train_ddp.parse_arg_train(argv + [
                "--log-dir", os.path.join(root, "runs"), "--epoch", "1"])
            require(args.temporal_scale == [1, 2, 3],
                    f"train_ddp's temporal scale {args.temporal_scale}")
            if world == 1:
                cli_train.agent_factory = factory
                cli_eval.agent_factory = factory
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = cli_train_ddp.main(args, world_size=world)
            train_wall = time.perf_counter() - t0
            cli_peak = torch.cuda.max_memory_allocated() / 2**30
            require(not PM.dist.is_initialized(),
                    "the CLI left its process group joined")
            ckpt_dir = (out.args if world == 1 else out).ckpt_dir
            require(math.isfinite(out.last_train_loss)
                    and math.isfinite(out.last_loss),
                    f"train_ddp: train loss {out.last_train_loss}, "
                    f"validation loss {out.last_loss}")
            files = sorted(os.listdir(ckpt_dir))
            require(files.count("best.pt") == 1, f"checkpoints {files}")
            train_steps = list(steps)
            steps.clear()
            del out
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ev = cli_eval.main(parse_arg_eval(argv + [
                "--model-path", os.path.join(ckpt_dir, "best.pt"),
                "--temporal-scale", "1", "2", "3"]), world_size=world)
            eval_wall = time.perf_counter() - t0
            require(math.isfinite(ev.last_loss)
                    and math.isfinite(ev.last_metric_val),
                    f"eval CLI: loss {ev.last_loss}, metric "
                    f"{ev.last_metric_val}")
            eval_steps = list(steps)
            del ev
        finally:
            cli_train.agent_factory = cli_eval.agent_factory = real_factory
            if old_vocab is None:
                os.environ.pop("LRCE_TPU_BERT_VOCAB", None)
            else:
                os.environ["LRCE_TPU_BERT_VOCAB"] = old_vocab
    torch.cuda.empty_cache()
    n_train = -(-DDP_CLI_QUESTIONS[0] // DDP_CLI_BATCH)
    n_val = -(-DDP_CLI_QUESTIONS[1] // DDP_CLI_BATCH)
    if world == 1:
        require([s[0] for s in train_steps]
                == [True] * n_train + [False] * n_val,
                f"train_ddp took {[s[0] for s in train_steps]} steps")
        require(len(eval_steps) == n_val, f"eval took {len(eval_steps)} "
                f"steps, expected {n_val}")
        for is_train, counts, _ in train_steps + eval_steps:
            want = train_step if is_train else eval_step
            for k, n in want.items():
                require(counts[k] == n, f"{k} launched {counts[k]} times in "
                        f"a {'train' if is_train else 'eval'} step of the "
                        f"NCCL run, expected {n}")
    cli_ms = [round(st[2], 1) for st in train_steps if st[0]]
    print(f"[ddp-cli] train_ddp over NCCL, {world} rank(s) (tgif-frameqa, "
          f"Swin-B + BERT-base, temporal scale [1, 2, 3], batch "
          f"{DDP_CLI_BATCH} a rank, {n_train} steps + {n_val} validation "
          f"steps): {train_wall:.2f} s wall, step ms (host, synchronized) "
          f"and peak "
          f"{f'{cli_ms}, {cli_peak:.2f} GiB' if world == 1 else 'not read across processes'}"
          f"; eval CLI {eval_wall:.2f} s wall", flush=True)

    return {"cli_train_s": train_wall, "cli_eval_s": eval_wall,
            "cli_step_ms": cli_ms, "cli_peak": cli_peak}


def phase_ddp_ranks(card: str, questions: int = DDP_QUESTIONS,
                    nccl: bool = False) -> dict:
    """Two ranks sharing the card over gloo (NCCL refuses two ranks on one
    card), or with ``nccl`` two cards over NCCL, ``questions`` questions x
    3 clips a rank: DDP_STEPS flagship steps from the same weights with
    bit-identical parameters on both ranks after each, against one process
    on the concatenated batch; then tensor parallelism (model 2) and FSDP
    (fsdp 2) one step each, against the same one-process step. Every step
    of every rank launches what the one-card step does."""
    from lrce_tpu_torch.models.e2e import LRCEModel
    from lrce_tpu_torch.parallel import mesh as PM
    from lrce_tpu_torch.train.agent import AgentOE, default_args

    train_step = {"K7": 0, "K8": 0,
                  **{k: sum(v) for k, v in {**CALLS_PER_FORWARD,
                                            **CALLS_PER_BACKWARD}.items()}}
    # the one-process reference first
    model = LRCEModel(_ddp_cfg(), dtype=torch.float32,
                      compute_dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    agent = AgentOE(model, default_args(), log_enabled=False)
    before = _group_flats(model.state_dict())
    ref = {"losses": [], "grads": [], "updates": []}
    for batch in _ddp_batches(questions):
        ref["losses"].append(agent.step(*batch, is_train=True)[0])
        after = _group_flats(model.state_dict())
        grads = _group_flats({n: p.grad if p.grad is not None
                              else torch.zeros_like(p)
                              for n, p in model.named_parameters()})
        # bf16 holds a gradient or an update to 2^-8 relative, far inside
        # the limits
        ref["grads"].append({g: grads[g].bfloat16().cpu()
                             for g in DDP_GROUPS})
        ref["updates"].append({g: (after[g] - before[g]).bfloat16().cpu()
                               for g in DDP_GROUPS})
        before = after
    del agent, model, before, after, grads
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="lrce_ddp_ref_") as tmp:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save(ref, ref_path)
        del ref["grads"], ref["updates"]
        t0 = time.perf_counter()
        every = PM.spawn(_ddp_rank, 2, (ref_path, questions),
                         device="cuda" if nccl else "cuda:0",
                         backend=None if nccl else "gloo",
                         timeout=DDP_TIMEOUT)
        spawn_wall = time.perf_counter() - t0
    report = {}
    for mode in every[0]["runs"]:
        runs = [r["runs"][mode] for r in every]
        report[mode] = {
            "wall_s": round(runs[0]["wall_s"], 2),
            "step_ms": [[round(st["ms"], 1) for st in run["steps"]]
                        for run in runs],
            "loss": [round(st["loss"], 5) for st in runs[0]["steps"]],
            "grad_rel": [{g: round(v, 5) for g, v in st["grad_rel"].items()}
                         for st in runs[0]["steps"]],
            "update_rel": [{g: round(v, 5) for g, v in
                            st["update_rel"].items()}
                           for st in runs[0]["steps"]],
            "decided": [{g: round(v, 4) for g, v in st["decided"].items()}
                        for st in runs[0]["steps"]],
            "peak_gib": [round(run["peak"], 2) for run in runs]}
        if mode == "ddp":
            comm = runs[0]["comm_ms"]
            report[mode]["all_reduce_ms"] = round(comm, 1)
            report[mode]["all_reduce_share"] = round(
                comm / runs[0]["steps"][-1]["ms"], 4)
    where = ("two cards over NCCL" if nccl else
             "two ranks sharing the card over gloo; the all-reduce goes "
             "through the host (no NCCL figure)")
    print(f"[ddp-ranks] {card}; {where} (flagship, "
          f"f32 parameters, bf16 compute, dropout 0, {questions} "
          f"questions x 3 clips a rank or, tensor-parallel, the pair's "
          f"{2 * questions}), "
          f"{spawn_wall:.1f} s for the spawn; one process's losses "
          f"{[round(x, 5) for x in ref['losses']]}; the update is compared "
          f"where the gradient is decided (the share in 'decided'); the "
          f"all-reduce's share "
          f"is the gradient's all-reduce alone over the second step, an "
          f"upper bound since DDP overlaps it with the backward: "
          f"{json.dumps(report)}", flush=True)
    require(set(every[0]["runs"]) == {"ddp", "model", "fsdp"},
            f"ran {sorted(every[0]['runs'])}")
    for mode in every[0]["runs"]:
        for r in every:
            for i, st in enumerate(r["runs"][mode]["steps"]):
                where = f"{mode} rank {r['rank']} step {i}"
                require(math.isfinite(st["loss"]) and abs(
                    st["loss"] - ref["losses"][i]) <= DDP_LOSS_REL * abs(
                    ref["losses"][i]), f"{where}: loss {st['loss']} against "
                    f"one process's {ref['losses'][i]}")
                require(st["total"] == 2 * questions,
                        f"{where}: the global batch counted {st['total']}")
                for g, rel in st["grad_rel"].items():
                    require(rel <= DDP_GRAD_REL, f"{where}: {g}'s gradient "
                            f"off by {rel:.4g} relative")
                for g, rel in st["update_rel"].items():
                    require(rel <= DDP_UPDATE_REL, f"{where}: {g}'s "
                            f"update off by {rel:.4g} relative where the "
                            f"gradient is decided")
                if mode == "ddp":
                    require(st["same"], f"{where}: the ranks' parameters "
                            "differ")
                for k, n in train_step.items():
                    require(st["counts"][k] == n, f"{where}: {k} launched "
                            f"{st['counts'][k]} times, expected {n}")
    return {"runs": report, "spawn_s": spawn_wall}


# ---------------------------------------------------------------------------
# The tools (lrce_tpu_torch/tools/) at full width
# ---------------------------------------------------------------------------

# the iteration counts the tools run with here, so that the phase stays
# within about three minutes
TOOLS_STAGE_ITERS = 5
TOOLS_TRAIN_ITERS = 3
TOOLS_EVAL_QUESTIONS = 64
TOOLS_SANITY_EPOCHS = 2
TOOLS_FEATURE_GIFS = 4
TOOLS_FLOPS_STEPS = 3


def _tool(name: str, fn, walls: dict):
    """Run one tool's entry point with its standard output captured, then
    print that output with a ``[tools:<name>]`` prefix; the host seconds
    from a synchronised start to a synchronised end go into ``walls``.
    Returns (its return value, its output)."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn()
    torch.cuda.synchronize()
    walls[name] = round(time.perf_counter() - t0, 2)
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"[tools:{name}] {line}", flush=True)
    return out, text


def _tools_forward(batch: int) -> dict:
    """The flagship forward at ``batch`` questions x 3 clips (bench.py's
    inputs, ``tools/common.bench_inputs``) on the kernel route, its launches
    counted, held to the plain route."""
    from lrce_tpu_torch.models.e2e import e2e_forward
    from lrce_tpu_torch.tools import common

    device = torch.device("cuda")
    model = common.flagship(device).eval()
    inputs = common.bench_inputs(batch, model.cfg, device)
    e2e_forward(model, *inputs)
    torch.cuda.synchronize()
    _reset_counts()
    out = e2e_forward(model, *inputs)
    torch.cuda.synchronize()
    counts = _counts()
    per = {k: sum(v) for k, v in CALLS_PER_FORWARD.items()}
    for k, n in counts.items():
        require(n == per.get(k, 0), f"{batch * 3}-clip forward: {k} launched "
                f"{n} times, expected {per.get(k, 0)}")
    model.video_extractor.swin.use_kernels = False
    ref = e2e_forward(model, *inputs)
    rel = _hold_to_plain(out, ref, (batch, 1000),
                         f"[tools] {batch * 3}-clip forward vs plain route")
    del model, out, ref
    torch.cuda.empty_cache()
    return {"clips": batch * 3, "rel_l2": rel, "launches": counts}


def _launched(name: str, kernels) -> dict:
    counts = _counts()
    for k in kernels:
        require(counts[k] > 0, f"{name}: {k} never launched")
    return counts


def phase_tools(card: str):
    """Each tool of ``lrce_tpu_torch/tools`` through its ``main`` at full
    width on the card (Swin-B, BERT-base, 12 fusion layers, oe, 1000
    classes), with iteration counts cut to fit the phase: preflight (the
    96-clip bench forward and a batch-16 train step), profile --latency
    (batch 1, 3 clips, 20 requests), stage_bench (48 clips, four stages),
    train_bench (batch 16, four regimes), e2e_eval_bench
    (64 questions, batch 32, 2 workers), sanity_curve (500 samples, 2
    epochs), parity_eval on the sanity run's weights (batch 32),
    extract_features video and text on 4 GIFs, flops (3
    doublings) and graft_entry's forward. Before them, the forward at 96
    clips and at 3 clips on the kernel route, launches counted, against the
    plain route. bench_ingest does not run here: it measures the host's
    .avi / .mp4 ingest of videos it writes with cv2, not the card. One
    ``[tools]`` line."""
    from lrce_tpu_torch.tools import (bench, common, e2e_eval_bench,
                                      extract_features, flops, graft_entry,
                                      parity_eval, preflight, profile,
                                      sanity_curve, stage_bench, synth,
                                      train_bench)
    from lrce_tpu_torch.utils.checkpoint import save_checkpoint

    forward_kernels = ("K1", "K3", "K2", "K7")
    train_kernels = forward_kernels + ("K6", "K5", "K4")
    walls, report = {}, {}
    report["forward96"] = _tools_forward(preflight.BENCH_BATCH)
    report["forward3"] = _tools_forward(1)

    _reset_counts()
    line, text = _tool("bench", lambda: bench.main([]), walls)
    _launched("bench", forward_kernels)
    require(text.strip().splitlines() == [json.dumps(line)]
            and line["metric"] == "clips_per_sec_per_gpu"
            and line["value"] > 0, f"bench: printed {text!r}")
    report["bench"] = line

    _reset_counts()
    rc, text = _tool("preflight", lambda: preflight.main([]), walls)
    pre = json.loads(text.strip().splitlines()[-1])
    require(rc == 0 and pre["preflight"] == "pass", f"preflight: {pre}")
    _launched("preflight", train_kernels)
    report["preflight_first_s"] = {k: v["compile_plus_first_s"]
                                   for k, v in pre["checks"].items()}

    _reset_counts()
    lat, _ = _tool("profile", lambda: profile.main(["--latency"]), walls)
    per = {k: sum(v) for k, v in CALLS_PER_FORWARD.items()}
    requests = 1 + len(lat["latency_ms"])
    counts = _counts()
    for k in forward_kernels:
        require(counts[k] == per[k] * requests, f"profile --latency: {k} "
                f"launched {counts[k]} times over {requests} requests")
    report["latency_ms"] = {"p50": lat["p50_ms"], "p90": lat["p90_ms"],
                            "requests": len(lat["latency_ms"])}

    _reset_counts()
    stages, _ = _tool("stage_bench", lambda: stage_bench.main(
        ["--clips", "48", "--iters", str(TOOLS_STAGE_ITERS)]), walls)
    _launched("stage_bench", forward_kernels)
    report["stage_ms"] = [(r["stage"], round(r["kernel_ms"], 3),
                           round(r["plain_ms"], 3)) for r in stages]

    _reset_counts()
    tb, _ = _tool("train_bench", lambda: train_bench.main(
        ["--batch", "16", "--iters", str(TOOLS_TRAIN_ITERS)]), walls)
    _launched("train_bench", train_kernels)
    require(math.isfinite(tb["loss"]), f"train_bench: loss {tb['loss']}")
    report["train_bench"] = {
        k: round(tb[k], 2) for k in tb if k.endswith(("_ms", "_clips_s"))}
    report["train_bench"]["peak_gib"] = round(tb["peak_gib"], 2)

    with tempfile.TemporaryDirectory(prefix="lrce_tools_") as root:
        _reset_counts()
        ev, _ = _tool("e2e_eval_bench", lambda: e2e_eval_bench.main(
            ["--samples", str(TOOLS_EVAL_QUESTIONS), "--batch-size", "32",
             "--workers", "2", "--keep-dir", os.path.join(root, "eval")]),
            walls)
        _launched("e2e_eval_bench", forward_kernels)
        require(math.isfinite(ev["loss"]), f"e2e_eval_bench: loss {ev}")
        report["eval_clips_s"] = {k: round(ev[k], 1)
                                  for k in e2e_eval_bench.PASSES}

        sanity_dir = os.path.join(root, "sanity")
        _reset_counts()
        sc, _ = _tool("sanity_curve", lambda: sanity_curve.main(
            ["--samples", "500", "--epochs", str(TOOLS_SANITY_EPOCHS),
             "--keep-dir", sanity_dir]), walls)
        _launched("sanity_curve", train_kernels)
        curve = [r["loss"] for r in sc["curve"]]
        acc = [r["acc_pct"] for r in sc["curve"]]
        require(len(curve) == TOOLS_SANITY_EPOCHS
                and all(math.isfinite(v) for v in curve),
                f"sanity_curve: losses {curve}")
        best = os.path.join(root, "best.pt")
        save_checkpoint(best, sc["trainer"].model.state_dict())
        del sc
        torch.cuda.empty_cache()
        report["sanity"] = {"loss": curve, "acc_pct": acc}
        print(f"[tools] sanity curve losses {curve}: the loss "
              f"{'fell' if curve[-1] < curve[0] else 'did not fall'}",
              flush=True)

        # batch 32: no forward of the phase goes past TOOLS_CLIPS' 96 clips
        argv = ["--dataset", "tgif-frameqa", "--dataset-dir", sanity_dir,
                "--batch-size", "32", "--num-workers", "4",
                "--model-path", best]
        _reset_counts()
        with common.bert_vocab(os.path.join(sanity_dir, "vocab.txt")):
            rc, text = _tool("parity_eval", lambda: parity_eval.main(argv),
                             walls)
        _launched("parity_eval", forward_kernels)
        par = json.loads(text.strip().splitlines()[-1])
        require(rc == 0 and math.isfinite(par["loss"])
                and math.isfinite(par["measured"]),
                f"parity_eval exited {rc}: {par}")
        report["parity_eval"] = {"accuracy_pct": par["measured"],
                                 "loss": par["loss"]}
        torch.cuda.empty_cache()

        feat = os.path.join(root, "features")
        os.makedirs(feat)
        written = synth.build_dataset(feat, TOOLS_FEATURE_GIFS,
                                      TOOLS_FEATURE_GIFS)
        _reset_counts()
        _tool("extract_features video", lambda: extract_features.main(
            ["video", "--videos-dir", os.path.join(feat, "gifs"),
             "--out-dir", os.path.join(feat, "video")]), walls)
        _launched("extract_features video", forward_kernels)
        with common.bert_vocab(os.path.join(feat, "vocab.txt")):
            _tool("extract_features text", lambda: extract_features.main(
                ["text", "--annotation", os.path.join(
                    feat, "annotations", "Test_frameqa_question.csv"),
                 "--out-dir", os.path.join(feat, "text"), "--tgif"]), walls)
        shapes = set()
        for sub, names in (("video", written), ("text", range(
                TOOLS_FEATURE_GIFS))):
            for n in names:
                with open(os.path.join(feat, sub, f"{n}.pkl"), "rb") as f:
                    a = pickle.load(f)
                require(a.dtype == np.float32 and np.isfinite(a).all(),
                        f"extract_features {sub}: {n} {a.dtype}")
                shapes.add((sub, a.shape))
        require(shapes == {("video", (6, 3, 49, 1024)), ("text", (30, 768))},
                f"extract_features: shapes {shapes}")

    rows, _ = _tool("flops", lambda: flops.main(
        ["--steps", str(TOOLS_FLOPS_STEPS)]), walls)
    for name, data in rows.items():
        require(all(math.isfinite(r["memory_mb"]) and r["mflops"] > 0
                    for r in data), f"flops: {name} {data}")
    report["flops_mflops"] = {n: [r["mflops"] for r in d]
                              for n, d in rows.items()}

    def graft():
        fn, args = graft_entry.entry()
        out = fn(*args)
        torch.cuda.synchronize()
        require(tuple(out.shape) == (2, 1000)
                and bool(torch.isfinite(out).all()),
                f"graft_entry: logits {tuple(out.shape)}")

    _reset_counts()
    _tool("graft_entry", graft, walls)
    _launched("graft_entry", forward_kernels)
    print("[tools] bench_ingest not run: it measures the host's .avi / .mp4 "
          "ingest of videos it writes with cv2, not the card (its CPU test "
          "runs it)", flush=True)
    report["wall_s"] = walls
    print(f"[tools] {card}; " + json.dumps(report, default=str), flush=True)
    return report


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
    attn_rows, ln_ms, attn_n392 = phase_attn_core()
    (results, results48, per_call, call_ms, back_half_ms,
     n392) = phase_kernels()
    swinl = phase_swinl()
    phase_by_piece(gemms, attn_rows, ln_ms, call_ms, back_half_ms)
    phase_function_grads()
    fwd_launches, lat_k, lat_p = phase_forward()
    train_launches, step_ms, peak = phase_train()
    run_launches, run_step_ms, run_wall, run_peak = phase_training_run()
    worst = phase_route_parity()
    frames16 = phase_frames16(card)
    cli = phase_cli(card)
    ddp = phase_ddp(card)
    ranks = phase_ddp_ranks(card)
    two_cards = (phase_ddp_ranks(card, nccl=True)
                 if torch.cuda.device_count() >= 2 else None)
    tools = phase_tools(card)
    print("[ddp] " + card + "; " + json.dumps({
        "train_ddp_nccl": {"ranks": torch.cuda.device_count(),
                           "train_wall_s": round(ddp["cli_train_s"], 2),
                           "eval_wall_s": round(ddp["cli_eval_s"], 2),
                           "step_ms_host": ddp["cli_step_ms"] or None,
                           "peak_gib": (round(ddp["cli_peak"], 2)
                                        if ddp["cli_step_ms"] else None)},
        "gloo_one_card": {m: {k: r[k] for k in ("step_ms", "peak_gib")
                              if k in r} for m, r in ranks["runs"].items()},
        "all_reduce_share_gloo_host": ranks["runs"]["ddp"][
            "all_reduce_share"],
        "all_reduce_ms_gloo_host": ranks["runs"]["ddp"]["all_reduce_ms"],
        "nccl_two_cards": ({m: {k: r[k] for k in ("step_ms", "peak_gib",
                                                  "all_reduce_ms") if k in r}
                            for m, r in two_cards["runs"].items()}
                           if two_cards else "not run: one card")}),
          flush=True)
    # the forward kernels from the serving requests, K8 from its own entry
    # point, the backward kernels from the training run; every kernel of
    # the run's path must have launched there
    for k in ("K1", "K3", "K2", "K7", "K6", "K5", "K4"):
        require(run_launches[k] > 0 and train_launches[k] > 0,
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
        if k == "K4":
            # the same sums at the 16-frame window, N = 392 (the pair), and
            # at Swin-L's, N = 432
            for clips, key in ((N_CLIPS, "clips6_n392"),
                               (TRAIN_CLIPS, "clips48_n392")):
                kernels[-1][key] = n392[clips]
            for clips in N432.clips:
                kernels[-1][f"clips{clips}_n432"] = swinl["K4"][clips]
        elif k in n392["forward"]:
            # the 48-clip sums at the 16-frame window, N = 392
            kernels[-1]["clips48_n392"] = n392["forward"][k]
        if k in ("K2", "K7", "K5"):
            # Swin-L's stages 2-3 (C = 768, 1536) at a step of its cell
            kernels[-1][f"clips{SWINL_CLIPS}_n432"] = {
                x: swinl[k][x] for x in ("ms", "plain_ms", "bound_ms")}
        if k == "K6":
            # the attention-forward CTA that K1 / K3 / K2 / K6 share at the
            # 16-frame window (attn_fwd_big_kernel), alone: the 46 calls of
            # a step at 6 and 48 clips, and its launches in a 16-frame step
            for clips, key in ((N_CLIPS, "attn_core_clips6_n392"),
                               (TRAIN_CLIPS, "attn_core_clips48_n392")):
                kernels[-1][key] = {
                    **{x: attn_n392[clips][x]
                       for x in ("ms", "plain_ms", "bound_ms", "library_ms")},
                    "launches_per_16_frame_step":
                        frames16["attn_ctas"]["attn_fwd_big_kernel"]}
            for clips in N432.clips:
                kernels[-1][f"attn_core_clips{clips}_n432"] = {
                    x: swinl["core"][clips][x]
                    for x in ("ms", "plain_ms", "bound_ms", "library_ms")}
    print(f"[summary] {card}; build {lib.build_seconds:.1f} s; request "
          f"latency ms kernel route {lat_k}, plain route {lat_p}; train "
          f"step ms {step_ms} at "
          f"{TRAIN_CLIPS} clips, peak {peak:.2f} GiB; training run "
          f"{run_wall:.2f} s, step ms {run_step_ms}, peak {run_peak:.2f} GiB; "
          f"route parity worst gradient rel L2 {worst:.4g}; 16 frames: "
          f"step ms {[round(t, 1) for t in frames16['step_ms']]} at "
          f"{FRAMES16_BATCH * 3} clips, peak {frames16['peak_gib']:.2f} GiB, "
          f"K4 at N = 392 {n392[TRAIN_CLIPS]['ms']:.2f} ms a step (bound "
          f"{n392[TRAIN_CLIPS]['bound_ms']:.2f}), the forward attention CTA "
          f"at N = 392 {attn_n392[TRAIN_CLIPS]['ms']:.2f} ms a step (bound "
          f"{attn_n392[TRAIN_CLIPS]['bound_ms']:.2f}, library "
          f"{attn_n392[TRAIN_CLIPS]['library_ms']:.2f}); Swin-L, N = 432, "
          f"a {SWINL_CLIPS}-clip step: K4 "
          f"{swinl['K4'][SWINL_CLIPS]['ms']:.2f} ms (bound "
          f"{swinl['K4'][SWINL_CLIPS]['bound_ms']:.2f}), the forward CTA "
          f"{swinl['core'][SWINL_CLIPS]['ms']:.2f} ms (bound "
          f"{swinl['core'][SWINL_CLIPS]['bound_ms']:.2f}), K2 "
          f"{swinl['K2']['ms']:.2f} ms (bound "
          f"{swinl['K2']['bound_ms']:.2f}), K7 {swinl['K7']['ms']:.2f} ms "
          f"(bound {swinl['K7']['bound_ms']:.2f}), K5 "
          f"{swinl['K5']['ms']:.2f} ms (bound "
          f"{swinl['K5']['bound_ms']:.2f}); bench "
          f"{tools['bench']['value']} clips/s; CLIs: train "
          f"{cli['train_s']:.2f} s, eval {cli['eval_s']:.2f} s, step ms "
          f"{[round(t, 1) for t in cli['step_ms']]}, loader-wait share "
          f"after the lookahead {cli['steady_wait_share']:.4f}, loader busy "
          f"{cli['busy_ratio']:.4f} of a step, peak "
          f"{cli['peak']:.2f} GiB; tools: 96-clip forward rel L2 "
          f"{tools['forward96']['rel_l2']:.4g}, 3-clip "
          f"{tools['forward3']['rel_l2']:.4g}, latency p50 / p90 "
          f"{tools['latency_ms']['p50']:.2f} / "
          f"{tools['latency_ms']['p90']:.2f} ms, walls s {tools['wall_s']}"
          f"; per call "
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
