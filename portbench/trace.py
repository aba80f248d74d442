"""The traced sub-window: benchmark spans on the host, the profiler's device
trace, and their reduction to a small summary that the per-layer metrics
read.

Spans are ``record_function`` ranges named ``portbench.<name>``: the loop's
own (``dispatch``, ``read``, ``request``) and one per model part, opened and
closed by forward hooks that the benchmark installs on the program's
modules (``ModuleSpans``). A device operation (kernel, copy or set) belongs
to a part when the host launched it inside that part's forward span, or
inside a backward node that answers a forward operation of that span (the
profiler's sequence numbers link the two). An operation whose launch the
trace does not show takes the part of the operation before it.

Nothing is written to disk: the events are read from the profiler in
memory.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import torch

PREFIX = "portbench."
WINDOW = PREFIX + "window"
GPU_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
BACKWARD = "autograd::engine::evaluate_function"
LAUNCH_NAME = re.compile(r"cu(da)?(Launch|Memcpy|Memset|GraphLaunch)")
TOP = 10
NAME_CHARS = 160    # of a device operation's name in the breakdown


def span(name: str):
    return torch.profiler.record_function(PREFIX + name)


class ModuleSpans:
    """Forward hooks that open a span when a module's forward starts and
    close it when it returns."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.handles = []
        for name, mod in modules.items():
            stack: List = []

            def pre(_m, _a, _stack=stack, _name=name):
                rf = span(_name)
                rf.__enter__()
                _stack.append(rf)

            def post(_m, _a, _o, _stack=stack):
                _stack.pop().__exit__(None, None, None)

            self.handles.append(mod.register_forward_pre_hook(pre))
            self.handles.append(mod.register_forward_hook(post))

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []


@contextmanager
def module_spans(modules: Dict[str, torch.nn.Module]):
    spans = ModuleSpans(modules)
    try:
        yield
    finally:
        spans.remove()


def capture(run: Callable[[], None], modules: Dict[str, torch.nn.Module],
            units: int) -> dict:
    """Profile ``run`` (which ends in a synchronisation) with the module
    spans installed and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with module_spans(modules), profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            run()
    return reduce(prof.profiler.kineto_results.events(), units,
                  list(modules))


class _Intervals:
    """Labelled host intervals of one thread, searched by time."""

    def __init__(self):
        self.items: List[tuple] = []     # (start, end, label)
        self.starts: List[int] = []

    def add(self, start, end, label):
        self.items.append((start, end, label))

    def freeze(self):
        self.items.sort()
        self.starts = [s for s, _, _ in self.items]

    def find(self, t) -> Optional[str]:
        """The label of the latest-starting interval that holds t (spans
        of one thread nest only a few deep)."""
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - 8, -1), -1):
            if self.items[j][1] >= t:
                return self.items[j][2]
        return None


def _union(intervals, lo, hi):
    """Merged [start, end) segments of ``intervals`` clipped to [lo, hi]."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _kinds(events):
    """Each event with its kind: the profiler's activity type where its
    events carry one; else the device events whose names are no host
    event's are device operations (a device-side copy of a host range
    shares its name), host events named as runtime launches are launches,
    and host events of the benchmark's prefix are its spans."""
    events = list(events)
    if not events or hasattr(events[0], "activity_type"):
        return [(e.activity_type(), e) for e in events]
    cpu = torch.autograd.DeviceType.CPU
    host_names = {e.name() for e in events if e.device_type() == cpu}
    out = []
    for e in events:
        name = e.name()
        if e.device_type() != cpu:
            kind = "gpu_user_annotation" if name in host_names else "kernel"
        elif name.startswith(PREFIX):
            kind = "user_annotation"
        elif LAUNCH_NAME.match(name):
            kind = "cuda_runtime"
        else:
            kind = "cpu_op"
        out.append((kind, e))
    return out


def reduce(events, units: int, parts: List[str]) -> dict:
    """Kineto events -> the summary: the window, the device's busy time,
    launches, device seconds by model part, NCCL seconds, the top device
    operations and the idle time by what the host was doing: the model part
    (``swin``, ``swin.backward``, ...) or loop span that launched the
    operation ending each gap."""
    cpu_ops, spans, gpu, launch = [], [], [], {}
    window = None
    for kind, e in _kinds(events):
        if kind in GPU_KINDS:
            gpu.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name(), e.correlation_id()))
        elif kind in LAUNCH_KINDS:
            launch[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        elif kind == "user_annotation" and e.name().startswith(PREFIX):
            s, t = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.name() == WINDOW:
                window = (s, t)
            else:
                spans.append((s, t, e.name()[len(PREFIX):],
                              e.start_thread_id()))
        elif kind == "cpu_op":
            cpu_ops.append(e)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    lo, hi = window

    # forward spans of the parts, and the loop's spans, by thread
    part_spans: Dict[int, _Intervals] = defaultdict(_Intervals)
    loop_spans: Dict[int, _Intervals] = defaultdict(_Intervals)
    for s, t, name, th in spans:
        (part_spans if name in parts else loop_spans)[th].add(s, t, name)
    for group in (part_spans, loop_spans):
        for iv in group.values():
            iv.freeze()

    # forward operations of each part -> its backward nodes
    seq_part = {}
    for e in cpu_ops:
        if e.sequence_nr() >= 0 and not e.name().startswith(BACKWARD):
            th = e.start_thread_id()
            part = part_spans[th].find(e.start_ns()) if th in part_spans \
                else None
            if part is not None:
                seq_part[(th, e.sequence_nr())] = part
    back: Dict[int, _Intervals] = defaultdict(_Intervals)
    for e in cpu_ops:
        if e.name().startswith(BACKWARD):
            part = seq_part.get((e.fwd_thread_id(), e.sequence_nr()))
            back[e.start_thread_id()].add(
                e.start_ns(), e.start_ns() + e.duration_ns(),
                "backward" if part is None else part)
    for iv in back.values():
        iv.freeze()

    gpu.sort()
    part_s: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    labels, inside, unlaunched = [], [], 0
    prev = (None, "host")
    for s, t, name, corr in gpu:
        if t <= lo or s >= hi:
            continue
        s, t = max(s, lo), min(t, hi)
        inside.append((s, t))
        by_name[name[:NAME_CHARS]] += (t - s) * 1e-9
        where = launch.get(corr)
        if where is None:
            unlaunched += 1
            part, host = prev
        else:
            lt, th = where
            fwd = part_spans[th].find(lt) if th in part_spans else None
            in_back = back[th].find(lt) if th in back else None
            if fwd is not None:
                part = host = fwd
            elif in_back is not None:
                part = None if in_back == "backward" else in_back
                host = "backward" if part is None else part + ".backward"
            else:
                part = None
                host = (loop_spans[th].find(lt) if th in loop_spans
                        else None) or "host"
        prev = (part, host)
        labels.append((s, host))
        if part is not None and "nccl" not in name.lower():
            part_s[part] += (t - s) * 1e-9

    segments = _union(inside, lo, hi)
    busy = sum(e - s for s, e in segments) * 1e-9
    idle: Dict[str, float] = defaultdict(float)
    starts = [s for s, _ in labels]
    cursor = lo
    for s, e in segments:
        if s > cursor:
            i = bisect.bisect_left(starts, s)
            host = labels[i][1] if i < len(labels) else "host"
            idle[host] += (s - cursor) * 1e-9
        cursor = e
    if hi > cursor:
        idle["window end"] += (hi - cursor) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "units": units,
        "window_s": (hi - lo) * 1e-9,
        "busy_s": busy,
        "launches": len(inside),
        "unlaunched": unlaunched,
        "part_s": dict(part_s),
        "nccl_s": sum(v for k, v in by_name.items() if "nccl" in k.lower()),
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": [[k, v] for k, v in gaps],
    }
