"""A module's no-grad forward replayed from CUDA graphs.

    class BertModel(nn.Module):
        def __init__(self, ...):
            ...
            self.graphs = GraphCache("bert")

        def forward(self, ids, mask=None, types=None, training=False,
                    generator=None):
            return self.graphs(self, self._forward, (ids, mask, types),
                               training, generator)

A call runs ``body(*inputs, training, generator)`` eagerly unless every one
of these holds (``why_eager`` names the first that does not):

- no gradient is wanted and ``training`` is false, so the body draws no
  random numbers and builds no autograd graph;
- no TorchFunctionMode or TorchDispatchMode is active (a FLOP counter must
  see every operation), and the current stream is not already capturing;
- every input is a contiguous CUDA tensor or None;
- no global module hook is set, and no layer below the module has a forward
  hook (tensor parallelism's, ``parallel/tensor_parallel.py``) or a
  parameter of a tensor subclass (FSDP's), whose collectives and Python a
  graph would not run.

Such a call is keyed by its inputs' shapes, dtypes and device, which of
them are None, and the addresses of the module's parameters and buffers.
The first call with a key runs eagerly (and so warms cuBLAS up); the second
captures ``body`` on a side stream into a CUDA graph and replays it; later
calls copy their inputs into the graph's static buffers, replay it and
return a clone of its static output, so that an answer kept across calls is
never overwritten. A graph
reads the parameters where they lie: an in-place update (AdamW's step,
``load_state_dict``'s copy) is replayed as it is, and a replaced parameter
changes the key, so a stale or freed weight is never read. The graph
launches the eager body's kernels on the same operands: its output equals
the eager output bit for bit.

A replay opens one span, ``<name>.graph``, and a capture ``<name>.capture``
(``utils/trace.py``); the spans of the body are recorded only when it runs
eagerly or is captured. ``eager``, ``captures`` and ``replays`` count the
calls of each route. The graphs of one cache share one memory pool and one
capture stream; a cache keeps the ``KEEP`` keys used last and drops the
oldest. One thread calls a module at a time.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from lrce_tpu_torch.utils import trace

KEEP = 4    # graphs kept per module, and keys seen once
PLAIN = (nn.Parameter, torch.Tensor)


def scan(module: nn.Module) -> Optional[tuple]:
    """The addresses of ``module``'s parameters and buffers, or None when a
    layer below it has a forward hook, or a parameter is of a tensor
    subclass (FSDP's DTensor)."""
    # the attributes are read from __dict__: this runs on every call
    ptrs = []
    stack = [module]
    while stack:
        m = stack.pop()
        if m is None:
            continue
        d = m.__dict__
        if m is not module and (d["_forward_hooks"]
                                or d["_forward_pre_hooks"]):
            return None
        for t in (*d["_parameters"].values(), *d["_buffers"].values()):
            if t is not None:
                if t.__class__ not in PLAIN:
                    return None
                ptrs.append(t.data_ptr())
        stack.extend(d["_modules"].values())
    return tuple(ptrs)


def why_eager(inputs: Sequence[Optional[torch.Tensor]],
              training: bool) -> Optional[str]:
    """Why a call with ``inputs`` runs eagerly, from what it can observe
    (the module's own layers aside: ``scan``); None when it may replay."""
    if torch.is_grad_enabled():
        return "grad"
    if training:
        return "training"
    if (torch._C._is_torch_function_mode_enabled()
            or torch._C._len_torch_dispatch_stack() > 0):
        return "mode"
    if nn.modules.module._global_forward_hooks \
            or nn.modules.module._global_forward_pre_hooks:
        return "hook"
    for x in inputs:
        if x is not None and not (x.is_cuda and x.is_contiguous()):
            return "device"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    return None


class _Graph:
    """One captured call: its graph and static buffers."""

    def __init__(self, body: Callable, inputs, pool, stream):
        self.inputs = tuple(None if x is None else x.clone() for x in inputs)
        self.graph = torch.cuda.CUDAGraph()
        here = torch.cuda.current_stream()
        stream.wait_stream(here)
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
            try:
                self.output = body(*self.inputs)
            finally:
                self.graph.capture_end()
        here.wait_stream(stream)
        # cuBLAS keeps a workspace per stream; the capture stream's came
        # from the pool while capturing. Dropped, it stays in the pool as
        # the graph's scratch, like its other intermediates, instead of
        # adding 32 MiB to the memory allocated for good (the next eager
        # product takes its own stream's back from the cache). Scratch may
        # be shared by the graphs of a pool: they replay one at a time, and
        # each replay's output is cloned before the next replay
        torch._C._cuda_clearCublasWorkspaces()

    def __call__(self, inputs) -> torch.Tensor:
        for s, x in zip(self.inputs, inputs):
            if s is not None:
                s.copy_(x)
        self.graph.replay()
        return self.output.clone()


class GraphCache:
    """The CUDA graphs of one module's forward, by key (module docstring)."""

    def __init__(self, name: str):
        self.name = name
        self.eager = self.captures = self.replays = 0
        self._graphs: OrderedDict = OrderedDict()
        self._seen: OrderedDict = OrderedDict()
        self._pools = {}        # device -> (memory pool, capture stream)

    def __deepcopy__(self, memo):
        return GraphCache(self.name)    # a copy's parameters lie elsewhere

    def __reduce__(self):
        return GraphCache, (self.name,)

    def __call__(self, module: nn.Module, body: Callable,
                 inputs: Sequence[Optional[torch.Tensor]], training: bool,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        key = None if why_eager(inputs, training) else self._key(module,
                                                                 inputs)
        if key is None:
            self.eager += 1
            return body(*inputs, training, generator)
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
            self.replays += 1
            with trace.span(self.name + ".graph"):
                return graph(inputs)
        if key not in self._seen:
            _remember(self._seen, key, True)
            self.eager += 1
            return body(*inputs, training, generator)
        del self._seen[key]
        self.captures += 1
        device = next(x.device for x in inputs if x is not None)
        with trace.span(self.name + ".capture"), torch.cuda.device(device):
            if device not in self._pools:
                self._pools[device] = (torch.cuda.graph_pool_handle(),
                                       torch.cuda.Stream())
            graph = _Graph(body, inputs, *self._pools[device])
            _remember(self._graphs, key, graph)
            return graph(inputs)

    @staticmethod
    def _key(module: nn.Module, inputs) -> Optional[tuple]:
        ptrs = scan(module)
        if ptrs is None:
            return None
        return (tuple(None if x is None else (x.shape, x.dtype, x.device)
                      for x in inputs), ptrs)


def _remember(cache: OrderedDict, key, value) -> None:
    cache[key] = value
    if len(cache) > KEEP:
        cache.popitem(last=False)
