#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lrce_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):
  1. device: requires CUDA; prints the card's name and power limit as
     nvidia-smi gives them; turns TF32 off for the f32 references;
  2. build: compiles lrce_tpu_torch/csrc for sm_90a (one nvcc per source,
     all at once) and prints the time;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     flagship shapes (bf16, 6 clips): K1, K3, K2 (forward); K6 with and
     without the mask at stages 0-2, K4 at stages 0-3, K5 at stages 0-2
     (every output: dy / dz, each dW, db and drel); then K6, K4 and K5
     again at the train step's 48 clips, stages 0-3. Max-abs and
     relative-L2 error against the stated tolerance, and kernel vs plain
     time (CUDA events, after warm-up). Then the K1, K3 and K2
     autograd.Functions' gradients against torch autograd through their
     plain versions, one block per stage, at 6 and at 48 clips;
  4. forward: the flagship LRCEModel (Video Swin-B, BERT-base, 12-layer
     fusion, open-ended head, random weights from a seed) on the card in
     bf16 answers 3 requests of 2 questions x 3 clips x 5 x 224 x 224 uint8
     frames with 32 tokens. Logits must be finite, (2, 1000), agree with
     the same model run on the plain route, and each request must launch
     K1 11 times, K3 11 times and K2 twice;
  5. train: the flagship with f32 parameters and bf16 compute, AgentOE with
     lrce_tpu's config defaults (lr 5e-6 for all three groups, reg 0.001),
     dropout 0.1 and drop-path 0.2 from a seeded generator, takes a warm-up
     step and 4 steps at 16 questions x 3 clips (48 clips) of uint8 frames.
     Every step: a finite loss, parameters of all three groups changed, and
     the launches K1 11, K3 11, K2 2 (forward), K6 22, K5 22, K4 24
     (backward). Prints the step ms and the peak device memory;
  6. route parity: one forward + backward at 2 questions, dropout and
     drop-path off, the same weights and batch, on the kernel route and on
     the plain route: loss and per-group gradient relative L2 (each Swin
     stage, BERT, the fusion) against the stated limit;
  7. a JSON line of kernels, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
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
                     "K2": (0, 0, 0, 2)}
# backward of one train step: K6 and K5 once per K1/K3 block, K4 once per
# block of every stage (K2's backward included); K6 and K4 run half their
# calls with the mask (the shifted blocks)
CALLS_PER_BACKWARD = {"K6": (2, 2, 18, 0), "K5": (2, 2, 18, 0),
                      "K4": (2, 2, 18, 2)}
TRAIN_BATCH = 16                # questions per step (tools/train_bench.py)
TRAIN_CLIPS = TRAIN_BATCH * 3   # the Swin batch of a train step
TRAIN_STEPS = 4
KERNEL_ORDER = ("K1", "K3", "K2", "K6", "K5", "K4")


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


def _seeded(shape, gen, scale=1.0):
    return (scale * torch.randn(shape, generator=gen)).cuda().bfloat16()


def phase_kernels():
    from lrce_tpu_torch.models.swin3d import compute_shift_mask
    from lrce_tpu_torch.ops import swin_block as SB
    from lrce_tpu_torch.ops import window_attn as WA

    gen = torch.Generator().manual_seed(1234)
    n = WINDOW[0] * WINDOW[1] * WINDOW[2]
    results = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
               for k in KERNEL_ORDER}
    per_call = []

    def record(kernel, calls, label, run_k, run_p, timed=None):
        """Compare every output; time when ``timed`` (default: when the
        6-clip step makes ``calls`` > 0 calls, which go into the totals)."""
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
        p1, k1, k2, p2 = (_cuda_time_ms(f) for f in (run_p, run_k, run_k, run_p))
        tk, tp = (k1 + k2) / 2, (p1 + p2) / 2
        results[kernel]["ms"] += calls * tk
        results[kernel]["plain_ms"] += calls * tp
        per_call.append((kernel, label, tk, tp, calls))
        where = (f"{calls} call(s) per forward or backward of a 6-clip step"
                 if calls else "outside the 6-clip totals")
        print(f"[kernels] {kernel} {label}: kernel {tk:.4f} ms, plain "
              f"{tp:.4f} ms per call; {where}", flush=True)

    # 6 clips (one request): every kernel, timed per 6-clip step. Then the
    # train step's own shape, 48 clips (T = 451,584 tokens at stage 0), for
    # the kernels only the train path runs: K6 and K4 with and without the
    # mask, K5 with dp2, each held to its plain version and timed per call.
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
            per_step = 0 if train_shape else 1     # into the 6-clip totals
            if stage == 3:
                args = (x, *attn, None, WINDOW, heads)
                if not train_shape:
                    record("K2", CALLS_PER_FORWARD["K2"][stage], label,
                           lambda: WA.fused_window_attention_hsplit(*args),
                           lambda: WA.window_attention_plain(*args))
                k4 = (x, g, *bwd, None, WINDOW, heads, 1e-5, NO_SHIFT)
                record("K4", per_step * CALLS_PER_BACKWARD["K4"][stage],
                       label, lambda: WA.window_attention_bwd(*k4),
                       lambda: WA.window_attention_bwd_plain(*k4), timed=True)
                del x, g
                continue
            mask = torch.from_numpy(compute_shift_mask((d, h, w), WINDOW,
                                                       SHIFT))
            mask = mask.reshape(*nwin, n, n).cuda()
            half = CALLS_PER_FORWARD["K1"][stage]     # blocks of each kind
            k1 = (x, *attn, None, *(p[k] for k in MLP_KEYS), None, None,
                  WINDOW, heads)
            if not train_shape:
                record("K1", half, label, lambda: SB.fused_swin_block(*k1),
                       lambda: SB.swin_block_plain(*k1))
                q = _block_weights(c, heads, n, gen, 1)
                k3 = (x, *(q[k] for k in ATTN_KEYS), mask,
                      *(q[k] for k in MLP_KEYS), None, None, WINDOW, heads,
                      (SHIFT,))
                record("K3", half, label + " k=1",
                       lambda: SB.fused_swin_pair(*k3),
                       lambda: SB.swin_pair_plain(*k3))
            for masked in (False, True):
                m, s = (mask, SHIFT) if masked else (None, NO_SHIFT)
                tag = label + (" masked, shift (0,3,3)" if masked
                               else " unmasked")
                k6 = (x, *attn, m, WINDOW, heads, 1e-5, s)
                record("K6", per_step * half, tag,
                       lambda: WA.fused_window_attention(*k6),
                       lambda: WA.window_attention_plain(*k6), timed=True)
                k4 = (x, g, *bwd, m, WINDOW, heads, 1e-5, s)
                record("K4", per_step * half, tag,
                       lambda: WA.window_attention_bwd(*k4),
                       lambda: WA.window_attention_bwd_plain(*k4), timed=True)
            dp = (torch.rand((clips,), generator=gen) < 0.8).float().cuda() / 0.8
            for with_dp in ((True,) if train_shape else (False, True)):
                k5 = (x, g, *(p[k] for k in ("ln2s", "ln2b", "w1", "b1",
                                              "w2")),
                      dp if with_dp else None, 1e-5)
                record("K5", per_step * 2 * half if with_dp else 0,
                       label + (" dp2" if with_dp else " no dp2"),
                       lambda: SB.mlp_bwd(*k5), lambda: SB.mlp_bwd_plain(*k5),
                       timed=with_dp)
            if stage == 0 and not train_shape:
                # the rest of the contract, off the eval path: K1 with a mask
                # and drop-path multipliers, K3 with k = 2
                dpv = ((torch.rand((N_CLIPS, 1), generator=gen) < 0.8)
                       .float().cuda() / 0.8)
                k1m = k1[:8] + (mask,) + k1[9:15] + (dpv, 2.0 - dpv) + k1[17:]
                record("K1", 0, label + " mask+dp",
                       lambda: SB.fused_swin_block(*k1m),
                       lambda: SB.swin_block_plain(*k1m))
                r = _block_weights(c, heads, n, gen, 2)
                dp2 = ((torch.rand((2, N_CLIPS), generator=gen) < 0.8)
                       .float().cuda() / 0.8)
                k3p = (x, *(r[k] for k in ATTN_KEYS), mask,
                       *(r[k] for k in MLP_KEYS), dp2, dp2.flip(0), WINDOW,
                       heads, ((0, 0, 0), SHIFT))
                record("K3", 0, label + " k=2 +dp",
                       lambda: SB.fused_swin_pair(*k3p),
                       lambda: SB.swin_pair_plain(*k3p))
            del x, g
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return results, per_call


def _grads(fn, x, leaves, g):
    x = x.detach().requires_grad_()
    ws = [t.detach().requires_grad_() for t in leaves]
    fn(x, ws).backward(g)
    return [x.grad] + [t.grad for t in ws]


def phase_function_grads():
    """K1 / K3 / K2 autograd.Functions (backward K6 + K5 + K4, or K4) vs
    torch autograd through their plain versions, one block per stage, at 6
    clips and at the train step's 48."""
    from lrce_tpu_torch.models.swin3d import compute_shift_mask
    from lrce_tpu_torch.ops import swin_block as SB
    from lrce_tpu_torch.ops import window_attn as WA

    gen = torch.Generator().manual_seed(4321)
    n = WINDOW[0] * WINDOW[1] * WINDOW[2]
    names = ("x",) + ATTN_KEYS + MLP_KEYS
    for clips, (stage, (d, h, w, c, heads)) in itertools.product(
            (N_CLIPS, TRAIN_CLIPS), enumerate(STAGES)):
        x = _seeded((clips, d, h, w, c), gen)
        g = _seeded((clips, d, h, w, c), gen)
        label = f"stage {stage}, {clips} clips"
        if stage == 3:
            p = _block_weights(c, heads, n, gen, None)
            leaves = [p[k] for k in ATTN_KEYS]
            cases = [("K2", lambda f: lambda x_, ws: f(x_, *ws, None, WINDOW,
                                                       heads),
                      WA.fused_window_attention_hsplit,
                      WA.window_attention_plain, leaves)]
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
                 [p[k] for k in ATTN_KEYS + MLP_KEYS]),
                ("K3", lambda f: lambda x_, ws: f(x_, *ws[:7], mask, *ws[7:],
                                                  dp[:1], dp[1:], WINDOW,
                                                  heads, (SHIFT,)),
                 SB.fused_swin_pair, SB.swin_pair_plain,
                 [q[k] for k in ATTN_KEYS + MLP_KEYS])]
        for kernel, wrap, fn_k, fn_p, leaves in cases:
            got = _grads(wrap(fn_k), x, leaves, g)
            want = _grads(wrap(fn_p), x, leaves, g)
            for name, a, b in zip(names, got, want):
                _compare(f"{kernel} autograd {label} d{name}", a, b,
                         GRAD_REL_L2, GRAD_MAX_ABS_REL)
        del x, g
        torch.cuda.empty_cache()


def _wrappers():
    from lrce_tpu_torch.ops import swin_block as SB
    from lrce_tpu_torch.ops import window_attn as WA

    return {"K1": SB.fused_swin_block, "K3": SB.fused_swin_pair,
            "K2": WA.fused_window_attention_hsplit,
            "K6": WA.fused_window_attention, "K5": SB.mlp_bwd,
            "K4": WA.window_attention_bwd}


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
    _reset_counts()
    outs, lat_kernels = serve("kernel route")
    counts = _counts()
    launches = {k: counts[k] for k in per_forward}
    print(f"[forward] launches over {len(requests)} requests: {counts}")
    for k, n in launches.items():
        require(n == per_forward[k] * len(requests),
                f"{k} launched {n} times, expected {per_forward[k]} per request")
    require(all(counts[k] == 0 for k in ("K6", "K5", "K4")),
            "the eval forward launched a backward kernel")

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
    del model
    torch.cuda.empty_cache()
    return launches, lat_kernels, lat_plain


def _train_batch(rng, questions: int):
    clips = rng.integers(0, 256, (questions, 3, 5, 224, 224, 3), dtype=np.uint8)
    ids = rng.integers(1000, 30000, (questions, 32))
    mask = np.ones((questions, 32), np.int64)
    mask[::2, 24:] = 0
    types = np.zeros((questions, 32), np.int64)
    gt = rng.integers(0, 1000, (questions,))
    return clips, ids, mask, types, gt


def _flagship_train_model():
    from lrce_tpu_torch.models.e2e import E2EConfig, LRCEModel

    cfg = E2EConfig(num_classes=1000, temporal_scale=(3,), text_seq_len=32)
    return LRCEModel(cfg, device="cuda", dtype=torch.float32,
                     compute_dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0))


def phase_train():
    from lrce_tpu_torch.train.agent import AgentOE, default_args

    per_step = {k: sum(v) for k, v in {**CALLS_PER_FORWARD,
                                       **CALLS_PER_BACKWARD}.items()}
    model = _flagship_train_model()
    agent = AgentOE(model, default_args(), seed=0)
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


def phase_route_parity():
    """One forward + backward, kernel route vs plain route, dropout and
    drop-path off (training=False, grad enabled), the task loss's
    gradients per group."""
    from lrce_tpu_torch.models.e2e import e2e_apply
    from lrce_tpu_torch.train import losses as L

    model = _flagship_train_model()
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
    results, per_call = phase_kernels()
    phase_function_grads()
    fwd_launches, lat_k, lat_p = phase_forward()
    train_launches, step_ms, peak = phase_train()
    worst = phase_route_parity()
    launches = {**{k: fwd_launches[k] for k in ("K1", "K3", "K2")},
                **{k: train_launches[k] for k in ("K6", "K5", "K4")}}
    kernels = [{"name": SOURCES[k][0], "route": "cuda", "source": SOURCES[k][1],
                "replaces": SOURCES[k][2], "launches": launches[k],
                "max_abs_err": results[k]["max_abs_err"],
                "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"]}
               for k in KERNEL_ORDER]
    print(f"[summary] {card}; build {lib.build_seconds:.1f} s; request "
          f"latency ms kernel route {lat_k}, plain route {lat_p}; train step "
          f"ms {step_ms} at {TRAIN_CLIPS} clips, peak {peak:.2f} GiB; "
          f"route parity worst gradient rel L2 {worst:.4g}; per call "
          f"(kernel ms, plain ms, calls) "
          f"{[(k, l, round(a, 4), round(b, 4), c) for k, l, a, b, c in per_call]}"
          f"; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
