"""Training cells: the train CLI's loop without its loader.

Set-up builds the kernels, the model (``cli.train.build_model``), the
weights from the seed and the agent (``AgentOE``), and drives that agent
through its first steps on batches that all differ, reading what the
comparison needs: each step's loss and logits, the first gradient from
AdamW's state after one step, and each parameter's change after the last.
The window then runs the same agent: each step is ``AgentOE.dispatch(...,
is_train=True)`` on a batch in host memory, which the step copies to the
card, and step i's vector is read after step i+1 is enqueued, as
``AgentBase.process_data`` reads it. The window ends with the read of its
last step. Across ranks every rank runs this loop under DDP; rank 0 decides
when the window ends and tells the others over a gloo group.

After the window, and after the program's state is freed, the reference
follows the first steps from the same weights, batches and draws.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from contextlib import nullcontext

import torch

from portbench import check, inputs, trace
from portbench.reference import lrce as R
from portbench.reference import train as RT

BATCHES = 8         # host batches the window cycles through
CHECK_STEPS = 3     # set-up's first steps, which the reference follows
TRACE_STEPS = 3     # steps of the profiled sub-window


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _send(agent, batch, fault):
    if fault == "half_batch":     # half of the batch left out
        batch = tuple(b[:len(b) // 2] for b in batch)
    return agent.dispatch(*batch, is_train=True)


class _Stop:
    """Rank 0's decision to end the window, shared over a gloo group."""

    def __init__(self, world: int):
        self.group = None
        if world > 1:
            self.group = torch.distributed.new_group(backend="gloo")

    def __call__(self, stop: bool) -> bool:
        if self.group is None:
            return stop
        flag = torch.tensor([int(stop)], dtype=torch.int32)
        torch.distributed.broadcast(flag, 0, group=self.group)
        return bool(flag.item())


def _loop(agent, batches, fault, device, until, spans: bool):
    """Steps with the lagged read until ``until(steps, seconds)``."""
    span = trace.span if spans else (lambda _n: nullcontext())
    enqueue, losses = [], []
    pending, n = None, 0
    start = time.perf_counter()
    while not until(n, time.perf_counter() - start):
        t = time.perf_counter()
        with span("dispatch"):
            out = _send(agent, batches[n % len(batches)], fault)
        enqueue.append(time.perf_counter() - t)
        n += 1
        if pending is not None:
            with span("read"):
                losses.append(pending.tolist()[0])
        pending = out
    if pending is not None:
        with span("read"):
            losses.append(pending.tolist()[0])
    _sync(device)
    return {"steps": n, "seconds": time.perf_counter() - start,
            "enqueue_s": enqueue, "losses": losses}


def _adam_grad_norms(agent, net, beta1: float) -> dict:
    """Each parameter's first gradient, as AdamW holds it after one step:
    exp_avg = (1 - beta1) g."""
    out = {}
    for name, p in net.named_parameters():
        st = agent.optimizer.state.get(p)
        out[name] = (float(st["exp_avg"].norm()) / (1 - beta1)
                     if st and "exp_avg" in st else 0.0)
    return out


def feed(spec, rank: int, device):
    questions = spec.traffic["questions"]
    return inputs.Feed(spec.config, spec.traffic, questions, spec.seed,
                       10 + rank, device)


def build(spec, device):
    """The kernels and the model; (model, parameter shapes, set-up
    seconds by part)."""
    from portbench import program

    setup = {}
    t = time.perf_counter()
    setup["nvcc_s"] = program.build_kernels() if device.type == "cuda" \
        else 0.0
    setup["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    net = program.model(spec.config, device)
    setup["model_s"] = time.perf_counter() - t
    return net, [(k, tuple(v.shape)) for k, v in net.named_parameters()], \
        setup


def layout(world: int, device):
    """This rank's place in a DDP mesh of ``world`` ranks; None for one."""
    from portbench import program

    return program.PM.make_layout(1, 1, device.type) if world > 1 else None


def make_agent(spec, net, shapes, device, rank: int, place, setup=None):
    """The seed's weights in the model, and a fresh agent over it at
    ``place`` (``layout``); (agent, the host batches of this rank). Seconds
    by part go into ``setup``."""
    from portbench import program

    setup = {} if setup is None else setup
    t = time.perf_counter()
    net.load_state_dict(inputs.make_weights(shapes, spec.seed, device))
    _sync(device)
    setup["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    agent = program.agent(net, spec.config, inputs.sub_seed(spec.seed, 4),
                          place)
    if spec.fault == "state_unchanged":
        agent.optimizer.step = lambda *a, **k: None
    if spec.fault == "no_exchange":     # DDP's gradient all-reduce left out
        agent.net.require_backward_grad_sync = False
    setup["agent_s"] = time.perf_counter() - t
    t = time.perf_counter()
    f = feed(spec, rank, device)
    batches = [f.next() for _ in range(BATCHES)]
    setup["feed_s"] = time.perf_counter() - t
    return agent, batches


def first_steps(spec, agent, net, shapes, batches, device) -> dict:
    """The first steps through the window's call and feed, and what the
    comparison reads of them."""
    logits = []
    hook = net.fusion_model.register_forward_hook(
        lambda _m, _a, out: logits.append(out.detach().float().cpu()))
    losses, grads = [], {}
    try:
        for i in range(CHECK_STEPS):
            losses.append(float(_send(agent, batches[i], spec.fault)[0]))
            if i == 0:
                grads = _adam_grad_norms(agent, net,
                                         spec.config["train"]["betas"][0])
    finally:
        hook.remove()
    with torch.no_grad():
        p0 = inputs.make_weights(shapes, spec.seed, device)
        change = {k: float((p.detach() - p0[k]).norm())
                  for k, p in net.named_parameters()}
    return {"losses": losses, "logits": logits, "grad_norms": grads,
            "change_norms": change}


def run_rank(spec, device, rank: int, world: int) -> dict:
    cell = spec.cell
    net, shapes, setup = build(spec, device)
    agent, batches = make_agent(spec, net, shapes, device, rank,
                                layout(world, device), setup)
    t = time.perf_counter()
    first = first_steps(spec, agent, net, shapes, batches, device)
    setup["check_s"] = time.perf_counter() - t
    k = CHECK_STEPS
    batches = batches[k:] + batches[:k]

    stop = _Stop(world)
    seconds = spec.seconds
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    start_wall = time.time()
    win = _loop(agent, batches, spec.fault, device,
                lambda n, s: stop(s >= seconds), spans=False)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    summary = None
    if spec.trace:
        steps = TRACE_STEPS
        modules = {"swin": net.video_extractor.swin,
                   "bert": net.text_extractor.bert,
                   "fusion": net.fusion_model}

        def traced():
            _loop(agent, batches, spec.fault, device,
                  lambda n, s: n >= steps, spans=True)

        if rank == 0:
            summary = trace.capture(traced, modules, steps)
        else:
            traced()
    del agent, net, batches
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"setup": setup, "window": win, "start_wall": start_wall,
            "peak_bytes": peak, "trace": summary, "shapes": shapes,
            "check": first}


def reference_steps(spec, shapes, device, numerics: R.Numerics):
    """The reference's first steps of every rank, from the seed."""
    cell = spec.cell
    steps = [[] for _ in range(CHECK_STEPS)]
    for r in range(cell["ranks"]):
        f = feed(spec, r, device)
        for i in range(CHECK_STEPS):
            steps[i].append(f.next())
        del f
    P0 = inputs.make_weights(shapes, spec.seed, device)
    return RT.train_steps(numerics, spec.config, P0, steps,
                          inputs.sub_seed(spec.seed, 4),
                          cell["reference_block"])


def finish(spec, outs, device, t0: float):
    """(end-to-end values, readings for the per-layer metrics, numbers
    compared, steps attempted, steps failed)."""
    n_clips = sum(spec.config["temporal_scale"])
    clips_step = spec.traffic["questions"] * n_clips * len(outs)
    win = outs[0]["window"]
    setup_s = max(o["start_wall"] for o in outs) - t0
    e2e = {"clips_per_s": win["steps"] * clips_step / win["seconds"],
           "peak_gib": max(o["peak_bytes"] for o in outs) / 2**30,
           "setup_s": setup_s}
    print("setup " + " ".join(f"{k} {v!r}" for k, v in
                              {**outs[0]["setup"], "setup_s": setup_s}
                              .items()), flush=True)
    print(f"window steps {win['steps']} seconds {win['seconds']!r} "
          f"clips_per_step {clips_step}", flush=True)

    t = time.perf_counter()
    ref = reference_steps(spec, outs[0]["shapes"], device, R.Numerics())
    print(f"reference_s {time.perf_counter() - t!r}", flush=True)
    if outs[0]["trace"] is not None:
        tr = outs[0]["trace"]
        print("trace " + " ".join(f"{k} {tr[k]!r}" for k in
                                  ("units", "launches", "unlaunched",
                                   "part_s", "nccl_s")), flush=True)
    prog = {"losses": outs[0]["check"]["losses"],
            "logits": [[o["check"]["logits"][i].to(device) for o in outs]
                       for i in range(CHECK_STEPS)],
            "grad_norms": [o["check"]["grad_norms"] for o in outs],
            "change_norms": [o["check"]["change_norms"] for o in outs]}
    numbers = check.training_numbers(prog, ref)
    failed = sum(not math.isfinite(v) for o in outs
                 for v in o["window"]["losses"])
    readings = {"mode": "train", "spec": spec, "e2e": e2e, "window": win,
                "trace": outs[0]["trace"], "clips_per_step": clips_step,
                "questions_per_step": spec.traffic["questions"] * len(outs),
                "chips": len(outs), "device": device,
                "enqueue_ms": 1e3 * statistics.median(win["enqueue_s"])}
    return e2e, readings, numbers, win["steps"], failed
