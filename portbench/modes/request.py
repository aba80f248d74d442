"""Request cells: a closed loop of clients that each send one question and
wait for its answer before sending the next.

Set-up builds the kernels, the model as ``cli.train.build_model`` builds
it (float32 parameters, bfloat16 compute) and the weights from the seed,
and warms the request's one shape up. In the window each request's clips
and tokens, new from the seed, are in host memory when it is sent; the
request copies them to the card, runs ``models.e2e.e2e_forward`` and ends
when its logits are on the host. Every request of the window is kept and,
after the window, held against the reference's logits for the same inputs.
"""

from __future__ import annotations

import gc
import statistics
import time
from contextlib import nullcontext

import numpy as np
import torch

from portbench import check, inputs, trace
from portbench.reference import lrce as R
from portbench.reference import train as RT

WARMUP = 10         # requests that warm the request's one shape up
TRACE_REQUESTS = 30     # requests of the profiled sub-window


def feed(spec, device):
    return inputs.Feed(spec.config, spec.traffic, spec.traffic["questions"],
                       spec.seed, 5, device)


def _serve(program, net, batch, device, fault, span):
    with span("request"):
        t = time.perf_counter()
        x = [torch.as_tensor(b).to(device, non_blocking=True)
             for b in batch[:4]]
        out = program.e2e_forward(net, *x)
        enq = time.perf_counter() - t
        if fault == "answer_altered":     # another class's scores
            out = out.roll(1, dims=-1)
        with span("read"):
            logits = out.float().cpu()
    return logits, enq


def loop(program, net, f, device, fault, until, spans: bool):
    span = trace.span if spans else (lambda _n: nullcontext())
    lat, enq, answers = [], [], []
    start = time.perf_counter()
    while not until(len(lat), time.perf_counter() - start):
        batch = f.next()
        t = time.perf_counter()
        logits, e = _serve(program, net, batch, device, fault, span)
        lat.append(time.perf_counter() - t)
        enq.append(e)
        answers.append(logits)
    return {"latency_s": lat, "enqueue_s": enq, "answers": answers,
            "seconds": time.perf_counter() - start}


def run_rank(spec, device, rank: int, world: int) -> dict:
    from portbench import program

    if world != 1:
        raise ValueError("a request cell runs on one rank")
    # a request's host work is one thread's launches: no pool of CPU
    # threads spinning beside it
    torch.set_num_threads(1)
    setup = {}
    t = time.perf_counter()
    setup["nvcc_s"] = program.build_kernels() if device.type == "cuda" \
        else 0.0
    setup["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    net = program.model(spec.config, device)
    setup["model_s"] = time.perf_counter() - t
    t = time.perf_counter()
    shapes = [(k, tuple(v.shape)) for k, v in net.named_parameters()]
    net.load_state_dict(inputs.make_weights(shapes, spec.seed, device))
    setup["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    f = feed(spec, device)
    loop(program, net, f, device, spec.fault, lambda n, s: n >= WARMUP,
          False)
    setup["warmup_s"] = time.perf_counter() - t
    gc.collect()
    gc.freeze()     # the model's objects stay out of the window's collections
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    start_wall = time.time()
    seconds = spec.seconds
    win = loop(program, net, f, device, spec.fault,
                lambda n, s: s >= seconds, False)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    summary = None
    if spec.trace:
        k = TRACE_REQUESTS
        summary = trace.capture(
            lambda: loop(program, net, f, device, spec.fault,
                          lambda n, s: n >= k, True),
            {"swin": net.video_extractor.swin,
             "bert": net.text_extractor.bert, "fusion": net.fusion_model}, k)
    gc.unfreeze()
    del net, f
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"setup": setup, "window": win, "start_wall": start_wall,
            "peak_bytes": peak, "trace": summary, "shapes": shapes}


def reference_logits(spec, shapes, device, count: int, numerics):
    """The reference's logits of the window's ``count`` requests (after the
    warm-up's), ``reference_block`` requests at a time."""
    f = feed(spec, device)
    for _ in range(WARMUP):
        f.next()
    P = inputs.make_weights(shapes, spec.seed, device)
    block = spec.cell["reference_block"]
    rows = []
    for q0 in range(0, count, block):
        reqs = [f.next() for _ in range(min(block, count - q0))]
        batch = tuple(np.concatenate([r[i] for r in reqs]) for i in range(5))
        rows.append(RT.logits(numerics, spec.config, P, [batch], block))
    return torch.cat(rows)


def finish(spec, outs, device, t0: float):
    out = outs[0]
    win = out["window"]
    lat = sorted(win["latency_s"])
    n = len(lat)
    p95 = float(np.percentile(np.array(lat), 95)) * 1e3
    p50 = statistics.median(lat) * 1e3
    setup_s = out["start_wall"] - t0
    e2e = {"request_p95_ms": p95,
           "peak_gib": out["peak_bytes"] / 2**30, "setup_s": setup_s}
    print("setup " + " ".join(f"{k} {v!r}" for k, v in
                              {**out["setup"], "setup_s": setup_s}.items()),
          flush=True)
    print(f"requests {n} p50_ms {p50!r} p95_ms {p95!r} "
          f"seconds {win['seconds']!r}", flush=True)
    t = time.perf_counter()
    ref = reference_logits(spec, out["shapes"], device, n, R.Numerics())
    print(f"reference_s {time.perf_counter() - t!r}", flush=True)
    if out["trace"] is not None:
        tr = out["trace"]
        print("trace " + " ".join(f"{k} {tr[k]!r}" for k in
                                  ("units", "launches", "unlaunched",
                                   "part_s")), flush=True)
    answers = torch.cat(win["answers"]).to(device)
    gaps = [check.rel_l2(a, r) for a, r in zip(answers, ref)]
    failed = sum(not torch.isfinite(a).all().item() for a in answers)
    readings = {"mode": "request", "spec": spec, "e2e": e2e, "window": win,
                "trace": out["trace"], "chips": 1, "device": device,
                "enqueue_ms": 1e3 * statistics.median(win["enqueue_s"])}
    return e2e, readings, {"logits_gap": max(gaps)}, n, failed
