"""The Swin tower's window attention in a training step, read by
``window_attn_ms.train`` and ``window_attn_roofline.train``.

The first reader of a ``--trace 1`` run builds the cell's program again
from the seed in a process spawned by ``harness.spawn`` (as ``spans.py``
does, and for the same reason: no profiler has run there), runs one step,
and then profiles as many steps as the mode's profiled sub-window with the
program's tracer on and its counters of work by shape asked for
(``trace.enable(detail=True)``). It reads:

- the device seconds a step of the window-attention kernels, the forward
  CTAs (``attn_fwd_kernel``, ``attn_fwd_big_kernel``, the WMMA
  ``window_attn_kernel``) and K4's (``attn_bwd_kernel``, the rows / columns
  pair), launched inside one of the program's stage spans ``swin.s<i>`` or
  by a backward node answering an operation of one: the forward of every
  block, K6's recompute of it in K1 / K3's backward, and K4;
- the counters ``attn.window_heads`` and ``attn.window_heads_big`` (the
  window x head pairs of the forward attention, all of them and those of
  more than 400 tokens), which it holds to the configuration's shapes: a
  count that differs raises, as ``spans.host`` holds ``clips`` to the
  traffic.

A program without those counters or spans (one that predates them) gives
no result, and both metrics read None. So does a cell of more than one
card.
"""

from __future__ import annotations

import gc
import json
import math
import re
from collections import defaultdict
from typing import Dict, Optional

import torch

from portbench import harness, spans, trace

WARMUP_STEPS = 1
BIG_TOKENS = 400    # ``attn.window_heads_big``: windows of more than this
FORWARD_CTAS = ("attn_fwd_kernel", "attn_fwd_big_kernel", "window_attn_kernel")
BACKWARD_CTAS = ("attn_bwd_kernel", "attn_bwd_rows_kernel",
                 "attn_bwd_cols_kernel")
KERNEL = re.compile(r"\b(" + "|".join(FORWARD_CTAS + BACKWARD_CTAS) + r")\b")
STAGE = re.compile(r"swin\.s(\d+)")


def stages(config: dict):
    """(stage, depth, windows a clip, tokens a window, heads, head_dim) of
    each Swin stage of a clip, from the configuration's shapes: the window
    clamped to the map where the map is smaller, as Video Swin does."""
    sw = config["swin"]
    pd, ph, pw = sw["patch_size"]
    dims = (-(-config["frame_sample_size"] // pd),
            -(-config["frame_size"] // ph), -(-config["frame_size"] // pw))
    c = sw["embed_dim"]
    out = []
    for i, depth in enumerate(sw["depths"]):
        window = tuple(min(v, wv) for v, wv in zip(dims, sw["window_size"]))
        nwin = math.prod(-(-v // wv) for v, wv in zip(dims, window))
        heads = sw["num_heads"][i]
        out.append((i, depth, nwin, math.prod(window), heads, c // heads))
        dims = (dims[0], -(-dims[1] // 2), -(-dims[2] // 2))
        c *= 2
    return out


def expected_counters(config: dict, clips: int) -> Dict[str, int]:
    """The counters a forward over ``clips`` clips gives, from shapes."""
    out = {"attn.window_heads": 0, "attn.window_heads_big": 0}
    for _, depth, nwin, n, heads, _ in stages(config):
        wh = depth * clips * nwin * heads
        out["attn.window_heads"] += wh
        if n > BIG_TOKENS:
            out["attn.window_heads_big"] += wh
    return out


def supported(tracer) -> bool:
    return tracer is not None and hasattr(tracer, "count_detail")


def reduce(events, units: int) -> dict:
    """Kineto events -> device seconds of the window-attention kernels a
    unit, forward and backward CTAs apart and by stage, counting only those
    launched inside a ``swin.s<i>`` span or by a backward node answering an
    operation of one (the labels of ``spans.reduce``)."""
    by_thread = defaultdict(list)
    cpu_ops, gpu, launch = [], [], {}
    window = None
    for kind, e in trace._kinds(events):
        name = e.name()
        if kind in trace.GPU_KINDS:
            if KERNEL.search(name):
                gpu.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            KERNEL.search(name).group(1), e.correlation_id()))
        elif kind in trace.LAUNCH_KINDS:
            launch[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        elif kind in ("user_annotation", "cpu_op") and name == trace.WINDOW:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif kind in ("user_annotation", "cpu_op") \
                and name.startswith(spans.PROGRAM):
            by_thread[e.start_thread_id()].append(
                (e.start_ns(), e.start_ns() + e.duration_ns(),
                 name[len(spans.PROGRAM):]))
        elif kind == "cpu_op":
            cpu_ops.append(e)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    lo, hi = window
    lines = {th: spans._Timeline(s) for th, s in by_thread.items()}

    def path_at(th, t) -> tuple:
        return lines[th].at(t) if th in lines else ()

    seq_path = {}
    for e in cpu_ops:
        if e.sequence_nr() >= 0 and not e.name().startswith(trace.BACKWARD):
            path = path_at(e.start_thread_id(), e.start_ns())
            if path:
                seq_path[(e.start_thread_id(), e.sequence_nr())] = path
    back = defaultdict(trace._Intervals)
    for e in cpu_ops:
        if e.name().startswith(trace.BACKWARD):
            path = seq_path.get((e.fwd_thread_id(), e.sequence_nr()), ())
            back[e.start_thread_id()].add(
                e.start_ns(), e.start_ns() + e.duration_ns(), "/".join(path))
    for iv in back.values():
        iv.freeze()

    out = {"units": units, "forward_s": 0.0, "backward_s": 0.0,
           "launches": 0, "outside": 0,
           "by_stage_s": defaultdict(float), "by_kernel_s": defaultdict(float)}
    for s, t, name, corr in gpu:
        if t <= lo or s >= hi:
            continue
        s, t = max(s, lo), min(t, hi)
        where = launch.get(corr)
        label = ""
        if where is not None:
            lt, th = where
            label = (back[th].find(lt) if th in back else None) \
                or "/".join(path_at(th, lt))
        stage = STAGE.search(label or "")
        if stage is None:
            out["outside"] += 1
            continue
        sec = (t - s) * 1e-9
        out["launches"] += 1
        out["forward_s" if name in FORWARD_CTAS else "backward_s"] += sec
        out["by_stage_s"][f"s{stage.group(1)}"] += sec
        out["by_kernel_s"][name] += sec
    out["by_stage_s"] = dict(out["by_stage_s"])
    out["by_kernel_s"] = dict(out["by_kernel_s"])
    return out


def _train(spec, device) -> dict:
    mode = spec.registry.mode(spec.cell["mode"])
    net, shapes, _ = mode.build(spec, device)
    agent, batches = mode.make_agent(spec, net, shapes, device, 0, None)
    steps = mode.TRACE_STEPS

    def run(k):
        return lambda: mode._loop(agent, batches, spec.fault, device,
                                  lambda n, s: n >= k, spans=False)

    run(WARMUP_STEPS)()
    t = spans.tracer()
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    t.drain()
    t.enable(detail=True)
    try:
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                run(steps)()
    finally:
        t.disable()
        _, counters = t.drain()
    out = reduce(prof.profiler.kineto_results.events(), steps)
    clips = len(batches[0][0]) * sum(spec.config["temporal_scale"])
    want = expected_counters(spec.config, clips)
    out["counters"] = {**dict.fromkeys(want, 0.0),     # a counter never hit
                       **{k: v / steps for k, v in counters.items()
                          if k.startswith("attn.")}}
    if out["counters"] != want:
        raise RuntimeError(f"the program counted {out['counters']} a step; "
                           f"the configuration's shapes give {want}")
    return out


def _rebuilt(device, rank: int, world: int, *spec_args) -> dict:
    return _train(harness.make_spec(*spec_args), device)


def _measure(r: dict) -> Optional[dict]:
    """The sub-window, in one process spawned by ``harness.spawn``."""
    if (r["mode"] != "train" or r["chips"] != 1
            or not supported(spans.tracer())):
        return None
    spec, device = r["spec"], r["device"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return harness.spawn(1, device.type, _rebuilt, (
        spec.cell["name"], spec.seed, spec.seconds, spec.trace,
        spec.registry.root, spec.benchmark, spec.fault))[0]


def readings(r: dict) -> Optional[dict]:
    """This run's window-attention reading, measured by the first reader
    and printed on one ``window_attn`` line."""
    if "window_attn" not in r:
        r["window_attn"] = _measure(r)
        if r["window_attn"] is not None:
            print("window_attn " + json.dumps(r["window_attn"]), flush=True)
    return r["window_attn"]


def device_ms(r: dict) -> Optional[float]:
    """Device ms a step of the window-attention kernels; None where there
    is no reading or no such kernel ran."""
    out = readings(r)
    if out is None or out["launches"] == 0:
        return None
    return 1e3 * (out["forward_s"] + out["backward_s"]) / out["units"]


def bound_s(config: dict, clips: int, peaks: dict) -> float:
    """The least time a training step's window attention takes on one card
    by its peaks, from the configuration's shapes: for every stage, the
    forward (q k^T and P v, 2 N^2 head_dim multiply-adds, and the bias add,
    N^2, a window x head; q, k, v read and ctx written once in bf16, and
    the f32 bias read once a head a block) and its backward, twice the
    forward's products (dq, dk, dv, dP) and the bias add's gradient; q, k,
    v, dctx read, dq, dk, dv written in bf16, the bias read and its
    gradient written in f32 once a head a block. Nothing that the kernels
    recompute (S, P, K6's forward) is counted. Each of the two is bound by
    the larger of its operations over the bf16 peak and its bytes over the
    bandwidth."""
    total = 0.0
    for _, depth, nwin, n, heads, hd in stages(config):
        wh = depth * clips * nwin * heads
        fwd_flops = wh * (4.0 * n * n * hd + n * n)
        fwd_bytes = wh * 8.0 * n * hd + depth * heads * 4.0 * n * n
        bwd_flops = 2.0 * fwd_flops
        bwd_bytes = wh * 14.0 * n * hd + depth * heads * 8.0 * n * n
        for flops, nbytes in ((fwd_flops, fwd_bytes), (bwd_flops, bwd_bytes)):
            total += max(flops / peaks["bf16_flops"],
                         nbytes / peaks["hbm_bytes"])
    return total
