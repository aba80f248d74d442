"""The program's own spans and counters (``lrce_tpu_torch/utils/trace.py``),
read by the per-layer metrics that name a span of the program.

The modes free the program's state before the metrics are read, so the
first such reader of a ``--trace 1`` run builds the cell's program again
from the seed, as the mode's set-up does (kernels, model, weights, agent or
warm-up requests), in a spawned process of its own, in which no profiler
has run, and runs two sub-windows there:

- ``host``: steps or requests with the program's tracer on and no
  profiler: each span's median inclusive host milliseconds a unit, and the
  counters a unit. The units are the program's own top-level spans
  (``step`` in training, ``forward`` for a request).
- ``capture``: as many steps or requests as the mode's profiled
  sub-window, under the profiler (host and device) with the tracer on. The
  tracer then opens a ``record_function`` range named ``lrce.<span>``
  beside each span, on the clock of the device trace; each device
  operation goes to the innermost program span open at its launch on the
  launching thread, or else on the main thread (the one holding the
  program's spans), and an operation launched by a backward node goes to
  ``<span>.backward`` of the span that ran the node's forward operation
  (the profiler's sequence numbers link the two, as in ``trace.reduce``).

The other readers read the same result, kept in the run's readings under
``program``, and the run prints it on one ``spans`` line. A program without
the tracer gives no result and every reader of this module None.
"""

from __future__ import annotations

import bisect
import gc
import inspect
import json
import pickle
import time
from collections import defaultdict
from queue import Empty
from typing import Callable, Dict, List, Optional

import torch

from portbench import harness, trace

PROGRAM = "lrce."
WARMUP_STEPS = 1    # train steps after the rebuild, before the sub-windows
HOST_STEPS = 5
HOST_REQUESTS = 30
CHILD_TIMEOUT_S = 900


def tracer():
    """The program's tracer: the ``trace`` module that the module of its
    entry point ``e2e_forward`` (reached through ``program``) opens its
    spans with; None where the program has none."""
    from portbench import program

    return getattr(inspect.getmodule(program.e2e_forward), "trace", None)


def host(run: Callable[[], None], units: int, unit: str,
         expect: Dict[str, float]) -> dict:
    """Run ``run`` with the program's tracer on and no profiler; each
    span's median inclusive and self host ms a unit and the counters a
    unit. Raises unless the top-level spans are ``units`` spans named
    ``unit`` and the counters a unit are ``expect`` (the work the
    sub-window was given)."""
    t = tracer()
    t.drain()
    t.enable()
    try:
        run()
    finally:
        t.disable()
    spans, counters = t.drain()
    tops = [s.name for s in spans if s.parent < 0]
    if tops != [unit] * units:
        raise RuntimeError(f"expected {units} top-level {unit!r} spans; the "
                           f"program recorded {len(tops)}: "
                           f"{sorted(set(tops))}")
    per_unit = {k: v / units for k, v in sorted(counters.items())}
    if per_unit != expect:
        raise RuntimeError(f"the program counted {per_unit} a {unit}; the "
                           f"sub-window gave it {expect}")
    names = sorted({s.name for s in spans})
    return {"units": units,
            "host_ms": {n: t.host_ms(spans, n) for n in names},
            "self_ms": {n: t.self_ms(spans, n) for n in names},
            "counters": per_unit}


def capture(run: Callable[[], None], units: int) -> dict:
    """Profile ``run`` (which ends in a synchronisation) with the program's
    tracer on, and reduce the trace against the program's spans."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    t = tracer()
    t.drain()
    t.enable()
    try:
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                run()
    finally:
        t.disable()
        t.drain()
    return reduce(prof.profiler.kineto_results.events(), units)


class _Timeline:
    """The program spans open on one thread, as a step function of time:
    the path of names from the outermost span in."""

    def __init__(self, spans: List[tuple]):
        self.times: List[int] = []
        self.paths: List[tuple] = []
        stack: List[tuple] = []     # (name, end)

        def close(until):
            while stack and stack[-1][1] <= until:
                end = stack.pop()[1]
                self._mark(end, stack)

        for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
            close(s)
            stack.append((name, e))
            self._mark(s, stack)
        close(float("inf"))

    def _mark(self, t, stack):
        path = tuple(n for n, _ in stack)
        if self.times and self.times[-1] == t:
            self.paths[-1] = path
        else:
            self.times.append(t)
            self.paths.append(path)

    def at(self, t) -> tuple:
        i = bisect.bisect_right(self.times, t) - 1
        return self.paths[i] if i >= 0 else ()


def reduce(events, units: int) -> dict:
    """Kineto events -> device seconds, launches and the idle seconds before
    the operations of each label: the path of program spans that launched
    an operation (``step/forward/fusion/fusion.clip``), its last name with
    ``.backward`` for a backward node's; None for no span."""
    by_thread: Dict[int, List[tuple]] = defaultdict(list)
    cpu_ops, gpu, launch = [], [], {}
    window = None
    for kind, e in trace._kinds(events):
        name = e.name()
        if kind in trace.GPU_KINDS:
            gpu.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                        e.correlation_id()))
        elif kind in trace.LAUNCH_KINDS:
            launch[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        elif kind in ("user_annotation", "cpu_op") and name == trace.WINDOW:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif kind in ("user_annotation", "cpu_op") \
                and name.startswith(PROGRAM):
            by_thread[e.start_thread_id()].append(
                (e.start_ns(), e.start_ns() + e.duration_ns(),
                 name[len(PROGRAM):]))
        elif kind == "cpu_op":
            cpu_ops.append(e)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    lo, hi = window
    lines = {th: _Timeline(s) for th, s in by_thread.items()}
    main = max(by_thread, key=lambda th: len(by_thread[th]), default=None)

    def path_at(th, t) -> tuple:
        path = lines[th].at(t) if th in lines else ()
        if not path and main is not None and th != main:
            path = lines[main].at(t)
        return path

    # forward operations -> the program spans around them -> their
    # backward nodes
    seq_path = {}
    for e in cpu_ops:
        if e.sequence_nr() >= 0 and not e.name().startswith(trace.BACKWARD):
            path = path_at(e.start_thread_id(), e.start_ns())
            if path:
                seq_path[(e.start_thread_id(), e.sequence_nr())] = path
    back: Dict[int, trace._Intervals] = defaultdict(trace._Intervals)
    for e in cpu_ops:
        if e.name().startswith(trace.BACKWARD):
            path = seq_path.get((e.fwd_thread_id(), e.sequence_nr()), ())
            back[e.start_thread_id()].add(
                e.start_ns(), e.start_ns() + e.duration_ns(), "/".join(path))
    for iv in back.values():
        iv.freeze()

    gpu.sort()
    per: Dict[Optional[str], Dict[str, float]] = defaultdict(
        lambda: {"device_s": 0.0, "launches": 0, "idle_s": 0.0})
    inside, labels, label = [], [], None
    for s, t, name, corr in gpu:
        if t <= lo or s >= hi:
            continue
        s, t = max(s, lo), min(t, hi)
        inside.append((s, t))
        where = launch.get(corr)
        if where is not None:       # else the label of the op before it
            lt, th = where
            fwd = back[th].find(lt) if th in back else None
            if fwd:
                label = fwd + ".backward"
            else:
                label = "/".join(path_at(th, lt)) or None
        labels.append((s, label))
        per[label]["launches"] += 1
        if "nccl" not in name.lower():
            per[label]["device_s"] += (t - s) * 1e-9

    segments = trace._union(inside, lo, hi)
    starts = [s for s, _ in labels]
    cursor, idle = lo, 0.0
    for s, e in segments:
        if s > cursor:
            i = bisect.bisect_left(starts, s)
            per[labels[i][1]]["idle_s"] += (s - cursor) * 1e-9
            idle += (s - cursor) * 1e-9
        cursor = e
    return {"units": units, "launches": len(inside), "idle_s": idle,
            "unattributed_idle_s": per[None]["idle_s"] if None in per
            else 0.0,
            "labels": {k: v for k, v in per.items() if k is not None}}


def _names(label: str) -> List[str]:
    names = label.split("/")
    if names[-1].endswith(".backward"):
        names[-1] = names[-1][:-len(".backward")]
    return names


def inclusive(summary: dict, name: str, key: str) -> float:
    """``key`` summed over the operations launched inside spans named
    ``name`` and the spans inside them, and by their backward nodes."""
    return sum(v[key] for label, v in summary["labels"].items()
               if name in _names(label))


def innermost(summary: dict, key: str) -> Dict[str, float]:
    """``key`` by the innermost span's name (``.backward`` kept)."""
    out: Dict[str, float] = defaultdict(float)
    for label, v in summary["labels"].items():
        out[label.rsplit("/", 1)[-1]] += v[key]
    return dict(out)


# ------------------------------------------------ the rebuild of the cell

def _train(spec, device) -> dict:
    mode = spec.registry.mode(spec.cell["mode"])
    net, shapes, _ = mode.build(spec, device)
    agent, batches = mode.make_agent(spec, net, shapes, device, 0, None)

    def steps(k):
        return lambda: mode._loop(agent, batches, spec.fault, device,
                                  lambda n, s: n >= k, spans=False)

    q = len(batches[0][0])
    expect = {"clips": q * sum(spec.config["temporal_scale"]),
              "h2d_bytes": sum(a.nbytes for a in batches[0]),
              "questions": q, "steps": 1}
    steps(WARMUP_STEPS)()
    return {"host": host(steps(HOST_STEPS), HOST_STEPS, "step", expect),
            "capture": capture(steps(mode.TRACE_STEPS), mode.TRACE_STEPS)}


def _request(spec, device) -> dict:
    from portbench import inputs, program

    mode = spec.registry.mode(spec.cell["mode"])
    torch.set_num_threads(1)    # as the mode's run_rank
    net = program.model(spec.config, device)
    shapes = [(k, tuple(v.shape)) for k, v in net.named_parameters()]
    net.load_state_dict(inputs.make_weights(shapes, spec.seed, device))
    f = mode.feed(spec, device)

    def requests(k):
        return lambda: mode.loop(program, net, f, device, spec.fault,
                                 lambda n, s: n >= k, False)

    requests(mode.WARMUP)()
    gc.collect()
    gc.freeze()     # as in the window
    expect = {"clips": sum(spec.config["temporal_scale"]),
              "questions": spec.traffic["questions"]}
    return {"host": host(requests(HOST_REQUESTS), HOST_REQUESTS, "forward",
                         expect),
            "capture": capture(requests(mode.TRACE_REQUESTS),
                               mode.TRACE_REQUESTS)}


def _child(queue, device_type: str, spec_args: tuple) -> None:
    """The rebuilt cell in a process of its own: the sub-windows' result,
    pickled, or the error, on ``queue``."""
    try:
        spec = harness.make_spec(*spec_args)
        device = torch.device("cpu")
        if device_type == "cuda":
            torch.cuda.set_device(0)
            device = torch.device("cuda", 0)
        run = _train if spec.cell["mode"] == "train" else _request
        queue.put((None, pickle.dumps(run(spec, device))))
    except BaseException as e:  # noqa: BLE001 - reported by the parent
        queue.put((f"{type(e).__name__}: {e}", None))
        raise


def _measure(r: dict) -> Optional[dict]:
    """The sub-windows, run in a spawned process: one in which no profiler
    has run, since a profiler that has traced the card can leave each later
    launch slower in its process (the run's own profiled sub-window comes
    before the readers)."""
    import multiprocessing as mp

    if tracer() is None or r["chips"] != 1:
        return None
    spec, device = r["spec"], r["device"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=_child, args=(queue, device.type, (
        spec.cell["name"], spec.seed, spec.seconds, spec.trace,
        spec.registry.root, spec.benchmark, spec.fault)))
    proc.start()
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        while True:     # drain, then join
            try:
                error, out = queue.get(timeout=5)
                break
            except Empty:
                if not proc.is_alive() or time.monotonic() > deadline:
                    raise RuntimeError(
                        "the program's sub-windows ended without a result "
                        f"(exit code {proc.exitcode})") from None
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
            proc.join()
    if error is not None:
        raise RuntimeError(f"the program's sub-windows: {error}")
    return pickle.loads(out)


def _print(r: dict, out: dict) -> None:
    cap, units = out["capture"], out["capture"]["units"]
    parts = ("swin", "bert", "fusion")
    line = {
        "units": out["host"]["units"],
        "host_ms": out["host"]["host_ms"],
        "self_ms": out["host"]["self_ms"],
        "counters": out["host"]["counters"],
        "capture_units": units,
        "device_ms": {p: 1e3 * inclusive(cap, p, "device_s") / units
                      for p in parts},
        "launches": {p: inclusive(cap, p, "launches") / units
                     for p in parts},
        "idle_s": cap["idle_s"],
        "unattributed_idle_share": (cap["unattributed_idle_s"] / cap["idle_s"]
                                    if cap["idle_s"] > 0 else None),
        "idle_by_span_s": dict(sorted(innermost(cap, "idle_s").items(),
                                      key=lambda kv: -kv[1])[:trace.TOP]),
    }
    tr = r.get("trace")
    if tr is not None:      # the profiled sub-window's parts, beside them
        line["part_ms"] = {p: 1e3 * tr["part_s"].get(p, 0.0) / tr["units"]
                           for p in parts}
    print("spans " + json.dumps(line), flush=True)


def readings(r: dict) -> Optional[dict]:
    """The program's spans of this run, measured by the first reader."""
    if "program" not in r:
        r["program"] = _measure(r)
        if r["program"] is not None:
            _print(r, r["program"])
    return r["program"]


def host_ms(r: dict, mode: str, name: str) -> Optional[float]:
    """The median host ms a unit inside the program's spans named
    ``name``, from the sub-window without a profiler."""
    out = readings(r) if r["mode"] == mode else None
    if out is None:
        return None
    return out["host"]["host_ms"].get(name)


def launches(r: dict, mode: str, name: str) -> Optional[float]:
    """Device operations a unit launched inside the program's spans named
    ``name`` (and their backward), from the profiled sub-window."""
    out = readings(r) if r["mode"] == mode else None
    if out is None or out["capture"]["launches"] == 0:
        return None
    cap = out["capture"]
    return inclusive(cap, name, "launches") / cap["units"]
