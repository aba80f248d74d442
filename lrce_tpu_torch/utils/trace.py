"""In-memory spans and counters at the port's layer boundaries.

    from lrce_tpu_torch.utils import trace

    trace.enable()
    agent.dispatch(*batch, is_train=True)
    spans, counters = trace.drain()
    trace.disable()
    trace.host_ms(spans, "fusion")      # median host ms a unit

Tracing is off by default, and then ``span`` returns one shared null
context and ``count`` does nothing. ``count_detail`` counts work by shape
(``attn.window_heads``: the window x head pairs of the Swin tower's forward
attention) only where the reader asks for it, ``enable(detail=True)``: the
counters of a plain ``enable()`` stay the per-unit ones (``steps``,
``questions``, ``clips``, ``h2d_bytes``) that readers hold to their inputs.
While tracing is on, each span records
``(name, start_ns, end_ns, parent, step)``: its host interval on
``time.time_ns()``, the clock the profiler stamps its events with; the
index of the span that was open around it on the same thread (-1 for
none); and the unit it belongs to, the number of the top-level span around
it (a train or eval step, a request's forward). While a profiler is also
listening, each span enters ``record_function("lrce." + name)`` as well, so
that the device trace holds it beside the operations it launched.

Nothing is written to disk: callers ``drain`` what was recorded. Spans are
recorded from the thread that opens them; one opened on a thread with no
span open, while the thread that opened the current unit has one open,
goes under that thread's innermost span (the autograd engine runs a CUDA
backward node on a thread of its own while the thread that called
``backward`` waits inside its span). ``drain`` is called with no span open.
"""

from __future__ import annotations

import statistics
import threading
import time
from collections import defaultdict
from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Tuple

import torch

PREFIX = "lrce."


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int     # index of the enclosing span in the drained list, or -1
    step: int       # the number of the top-level span around it


class _State:
    def __init__(self):
        self.on = False
        self.detail = False
        self.spans: List = []
        self.counters: Dict[str, int] = defaultdict(int)
        self.units = 0
        self.unit = []      # the span stack of the thread of the last unit
        self.local = threading.local()


_STATE = _State()
_NULL = nullcontext()


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "store", "index", "parent", "step", "start", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _STATE
        stack = getattr(st.local, "stack", None)
        if stack is None:
            stack = st.local.stack = []
        outer = stack or st.unit
        if outer:
            self.parent, self.step = outer[-1].index, outer[-1].step
        else:
            self.parent, self.step = -1, st.units
            st.units += 1
            st.unit = stack
        self.store = st.spans
        self.index = len(self.store)
        self.store.append(None)
        stack.append(self)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.start = time.time_ns()     # inside the range: without its cost
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _STATE.local.stack.pop()
        self.store[self.index] = Span(self.name, self.start, end,
                                      self.parent, self.step)
        return False


def span(name: str):
    """A context manager that records a span named ``name`` while tracing
    is on; the shared null context while it is off."""
    if not _STATE.on:
        return _NULL
    return _Open(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _STATE.on:
        _STATE.counters[name] += n


def count_detail(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on with
    ``detail``."""
    if _STATE.on and _STATE.detail:
        _STATE.counters[name] += n


def enable(detail: bool = False) -> None:
    """Start recording; ``detail``: ``count_detail``'s counters too."""
    _STATE.on = True
    _STATE.detail = detail


def disable() -> None:
    _STATE.on = False
    _STATE.detail = False


def enabled() -> bool:
    return _STATE.on


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """The spans and counters recorded since the last drain, which are
    cleared; the next span starts unit 0."""
    st = _STATE
    if any(s is None for s in st.spans):
        raise RuntimeError("trace.drain() called inside an open span")
    spans, counters = st.spans, dict(st.counters)
    st.spans, st.counters, st.units = [], defaultdict(int), 0
    return spans, counters


def _per_unit(spans: List[Span], name: str, self_time: bool) -> float:
    units = {s.step for s in spans}
    if not units:
        return 0.0
    covered: Dict[int, int] = defaultdict(int)
    if self_time:
        for s in spans:
            if s.parent >= 0:
                covered[s.parent] += s.end_ns - s.start_ns
    total: Dict[int, int] = defaultdict(int)
    for i, s in enumerate(spans):
        if s.name != name:
            continue
        if not self_time and _inside(spans, s, name):
            continue    # counted with the span of the same name around it
        total[s.step] += s.end_ns - s.start_ns - covered[i]
    return statistics.median(total[u] for u in units) * 1e-6


def _inside(spans: List[Span], s: Span, name: str) -> bool:
    p = s.parent
    while p >= 0:
        if spans[p].name == name:
            return True
        p = spans[p].parent
    return False


def host_ms(spans: List[Span], name: str) -> float:
    """The median over units of the host milliseconds inside spans named
    ``name`` within each unit (0 for a unit without one)."""
    return _per_unit(spans, name, self_time=False)


def self_ms(spans: List[Span], name: str) -> float:
    """As ``host_ms``, less the part of each span that its child spans
    cover: the span's own host time."""
    return _per_unit(spans, name, self_time=True)
