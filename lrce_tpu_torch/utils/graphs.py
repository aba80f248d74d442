"""A module's no-grad forward, and the fusion's training call, replayed
from CUDA graphs.

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
  random numbers and builds no autograd graph; or, in a cache made with
  ``train=True`` (the fusion's), a gradient is wanted, ``training`` is true
  and the body draws from a CUDA generator;
- no TorchFunctionMode or TorchDispatchMode is active (a FLOP counter must
  see every operation), and the current stream is not already capturing;
- every input is a contiguous CUDA tensor or None;
- no global module hook is set, and no layer below the module has a forward
  hook (tensor parallelism's, ``parallel/tensor_parallel.py``) or a
  parameter of a tensor subclass (FSDP's), whose collectives and Python a
  graph would not run.

Such a call is keyed by its inputs' shapes, dtypes and device, which of
them are None, and the addresses of the module's parameters and buffers; a
training call also by which inputs want a gradient, the generator, and the
parameters that want one. A graph reads the parameters where they lie: an
in-place update (AdamW's step, ``load_state_dict``'s copy) is replayed as
it is, and a replaced parameter changes the key, so a stale or freed
weight is never read. The graph launches the eager body's kernels on the
same operands: its output equals the eager output bit for bit.

Both routes: the first call with a key runs eagerly (and so warms cuBLAS
up); the second captures and replays; later calls replay. The no-grad
route captures ``body`` on a side stream into a CUDA graph; a replay copies
its inputs into the graph's static buffers, replays it and returns a clone
of its static output, so that an answer kept across calls is never
overwritten.

The training route (``_TrainGraph``, built as
``torch.cuda.make_graphed_callables`` builds its graphs) warms the forward
and its backward up on static copies of the inputs, then captures the
forward, and ``torch.autograd.grad`` of its output towards the inputs and
parameters that want a gradient from a static cotangent, into two graphs of
a memory pool of their own: no other replay overwrites the activations that
a forward leaves for its backward. A replay runs the forward through an
autograd ``Function`` whose output hangs on the real inputs and parameters;
its backward copies the cotangent in, replays the backward graph and hands
the static gradients to autograd, which takes a parameter's as its
``.grad``. Where autograd adds it to another term's gradient (the l2
term's) in that term's buffer instead, a hook on the parameter moves the
sum into the static buffer: one buffer holds a parameter's gradient, as in
the eager call. The graph owns its static buffers. A second backward before the
optimizer's step first moves such a ``.grad`` to a buffer of its own. A
training call whose key's graph holds a forward still awaiting its
backward runs eagerly; a second backward of one replay raises. Dropout
draws through PyTorch's graph-safe RNG: the generator is registered with
the forward graph, and a replay advances it by what the eager body draws;
neither the warm-up (the generator is put back) nor the capture advances
it, so every call draws what the eager body would have.

A replay opens one span, ``<name>.graph``, a backward replay
``<name>.graph_bwd`` (on the autograd engine's thread, recorded under the
caller's open span), and a capture ``<name>.capture``
(``utils/trace.py``); the spans of the body are recorded only when it runs
eagerly or is captured. ``eager``, ``captures``, ``replays`` and
``backward_replays`` count the calls of each route. The no-grad graphs of
one cache share one memory pool, and all its graphs one capture stream; a
cache keeps the ``KEEP`` keys used last and drops the oldest. One thread
calls a module at a time.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from contextlib import contextmanager
from functools import partial
from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.autograd.function import once_differentiable

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


def why_eager(inputs: Sequence[Optional[torch.Tensor]], training: bool,
              generator: Optional[torch.Generator] = None,
              train: bool = False) -> Optional[str]:
    """Why a call with ``inputs`` runs eagerly, from what it can observe
    (the module's own layers aside: ``scan``); None when it may replay.
    ``train``: the cache offers the training route."""
    grad = torch.is_grad_enabled()
    if grad and not (train and training):
        return "grad"
    if training and not grad:
        return "training"
    if training and (generator is None or generator.device.type != "cuda"):
        return "generator"
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
    """One captured no-grad call: its graph and static buffers."""

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


class _TrainGraph:
    """One captured training call: the forward and backward graphs, in a
    memory pool of their own, and their static buffers (module
    docstring)."""

    def __init__(self, name: str, module: nn.Module, body: Callable, inputs,
                 params, generator: torch.Generator, stream):
        self.name = name
        self.generator = generator      # its id is in the key: keep it
        self.inputs = tuple(
            None if x is None
            else x.detach().clone().requires_grad_(x.requires_grad)
            for x in inputs)
        wrt = [x for x in self.inputs if x is not None and x.requires_grad]
        self.slots, n = [], 0   # each non-None input's place in ``grads``
        for x in self.inputs:
            if x is not None:
                self.slots.append(n if x.requires_grad else None)
                n += x.requires_grad
        self.first_param = len(wrt)
        wrt += list(params)
        self.pending = None     # the replayed forward awaiting its backward
        self.unsettled = set()  # parameters whose gradient ``_settle`` moves
        # the warm-up, on the caller's stream: the backward's first
        # launches (cuBLAS's handle on the autograd engine's thread) happen
        # outside the capture, and its memory goes back to the eager cache
        state = generator.get_state()
        out = body(*self.inputs, True, generator)
        torch.autograd.grad(out, wrt, torch.zeros_like(out),
                            allow_unused=True)
        del out
        generator.set_state(state)
        # the capture differentiates fresh leaves over the same memory: the
        # parameters' own AccumulateGrad nodes, which the eager call's graph
        # or DDP may keep alive, belong to the caller's stream, and a
        # capture may not make that stream wait on it
        leaves = {id(t): t.detach().requires_grad_() for t in wrt}
        self.pool = torch.cuda.graph_pool_handle()
        here = torch.cuda.current_stream()
        stream.wait_stream(here)
        with torch.cuda.stream(stream), _swapped(module, leaves):
            self.forward = torch.cuda.CUDAGraph()
            self.forward.register_generator_state(generator)
            self.forward.capture_begin(pool=self.pool,
                                       capture_error_mode="thread_local")
            try:
                output = body(*(None if x is None else leaves.get(id(x), x)
                                for x in self.inputs), True, generator)
            finally:
                self.forward.capture_end()
            self.grad_output = torch.zeros_like(output)
            self.backward = torch.cuda.CUDAGraph()
            self.backward.capture_begin(pool=self.pool,
                                        capture_error_mode="thread_local")
            try:
                self.grads = torch.autograd.grad(
                    output, [leaves[id(t)] for t in wrt], self.grad_output,
                    allow_unused=True)
            finally:
                self.backward.capture_end()
        here.wait_stream(stream)
        self.output = output.detach()
        # as in ``_Graph``: the capture's cuBLAS workspaces stay in the pool
        torch._C._cuda_clearCublasWorkspaces()
        me = weakref.ref(self)
        hooks = [p.register_post_accumulate_grad_hook(partial(_settle, me, i))
                 for i, (p, g) in enumerate(zip(params,
                                                self.grads[self.first_param:]))
                 if g is not None]
        weakref.finalize(self, _unhook, hooks)

    def busy(self) -> bool:
        """A replayed forward still awaits its backward."""
        return self.pending is not None and self.pending() is not None

    def release(self, params) -> None:
        """Move each parameter's ``.grad`` that is still a static buffer of
        this graph to a buffer of its own. The gradients may lie where the
        forward keeps activations, so a replay of either graph would
        overwrite such a ``.grad`` (a second backward before the
        optimizer's step; the usual step consumes it first)."""
        for p, g in zip(params, self.grads[self.first_param:]):
            if g is not None and p.grad is not None \
                    and p.grad.data_ptr() == g.data_ptr():
                p.grad = p.grad.clone()

    def replay_forward(self, inputs, params) -> object:
        """Replay the forward; returns the token that its backward shows
        (``pending`` holds it weakly: the autograd graph keeps it alive)."""
        self.release(params)
        self.unsettled = set()
        for s, x in zip(self.inputs, inputs):
            if s is not None:
                s.copy_(x)
        self.forward.replay()
        token = _Token()
        self.pending = weakref.ref(token)
        return token

    def replay_backward(self, grad: torch.Tensor, token, params,
                        leaves) -> tuple:
        """The gradients of one backward: each non-None input's (None where
        it wants none), then each parameter's."""
        if not self.busy() or self.pending() is not token:
            raise RuntimeError(
                f"{self.name}: the graphed forward's activations were "
                "overwritten (a later replay, or this forward's own "
                "backward) before this backward")
        self.pending = None
        self.release(params)
        self.grad_output.copy_(grad)
        self.backward.replay()
        grads, out = self.grads, []
        for slot, leaf in zip(self.slots, leaves):
            g = None if slot is None else grads[slot]
            # a leaf input keeps its gradient as .grad: give it its own
            out.append(None if g is None else
                       g.clone() if leaf else g.detach())
        out.extend(None if g is None else g.detach()
                   for g in grads[self.first_param:])
        self.unsettled = set(range(len(params)))
        return tuple(out)


class _Token:
    """Held by a replay's autograd node: alive while its backward may run."""


def _settle(graph_ref, i: int, p: torch.Tensor) -> None:
    """After a backward replay, once autograd has accumulated ``p``'s
    gradient: where it added the graph's static gradient into another
    buffer (the l2 term's gradient, which reaches ``p`` first), copy the
    sum into the static buffer and free that buffer, so that ``p`` keeps one
    gradient buffer as the eager call does, not two."""
    graph = graph_ref()
    if graph is None or i not in graph.unsettled:
        return
    graph.unsettled.discard(i)
    g = graph.grads[graph.first_param + i]
    if p.grad is not None and p.grad.data_ptr() != g.data_ptr():
        g.copy_(p.grad)
        p.grad = g.detach()


def _unhook(hooks) -> None:
    for h in hooks:
        h.remove()


class _Replay(torch.autograd.Function):
    """A training call replayed: the forward graph now, the backward graph
    when autograd reaches the output."""

    @staticmethod
    def forward(ctx, graph: _TrainGraph, cache: "GraphCache", n: int,
                *tensors):
        ctx.graph, ctx.cache = graph, cache
        ctx.params = tensors[n:]
        ctx.leaves = tuple(x.is_leaf and x.requires_grad
                           for x in tensors[:n])
        ctx.token = graph.replay_forward(tensors[:n], ctx.params)
        return graph.output.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        cache = ctx.cache
        with trace.span(cache.name + ".graph_bwd"):
            grads = ctx.graph.replay_backward(grad, ctx.token, ctx.params,
                                              ctx.leaves)
        cache.backward_replays += 1
        return (None, None, None) + grads


class GraphCache:
    """The CUDA graphs of one module's forward, by key (module docstring);
    ``train``: the training route too."""

    def __init__(self, name: str, train: bool = False):
        self.name = name
        self.train = train
        self.eager = self.captures = self.replays = 0
        self.backward_replays = 0
        self._graphs: OrderedDict = OrderedDict()
        self._seen: OrderedDict = OrderedDict()
        self._pools = {}        # device -> (memory pool, capture stream)

    def __deepcopy__(self, memo):
        # a copy's parameters lie elsewhere
        return GraphCache(self.name, self.train)

    def __reduce__(self):
        return GraphCache, (self.name, self.train)

    def __call__(self, module: nn.Module, body: Callable,
                 inputs: Sequence[Optional[torch.Tensor]], training: bool,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        key = params = None
        if why_eager(inputs, training, generator, self.train) is None:
            key, params = self._key(module, inputs, training, generator)
        graph = None if key is None else self._graphs.get(key)
        if graph is not None and not (training and graph.busy()):
            self._graphs.move_to_end(key)
            self.replays += 1
            with trace.span(self.name + ".graph"):
                return self._replay(graph, inputs, params)
        if graph is None and key in self._seen:
            del self._seen[key]
            self.captures += 1
            device = next(x.device for x in inputs if x is not None)
            with trace.span(self.name + ".capture"), \
                    torch.cuda.device(device):
                pool, stream = self._pool(device)
                graph = (_TrainGraph(self.name, module, body, inputs, params,
                                     generator, stream) if training
                         else _Graph(body, inputs, pool, stream))
                _remember(self._graphs, key, graph)
                return self._replay(graph, inputs, params)
        if graph is None and key is not None:
            _remember(self._seen, key, True)
        self.eager += 1
        return body(*inputs, training, generator)

    def _replay(self, graph, inputs, params) -> torch.Tensor:
        if params is None:
            return graph(inputs)
        tensors = [x for x in inputs if x is not None]
        return _Replay.apply(graph, self, len(tensors), *tensors, *params)

    def _pool(self, device):
        if device not in self._pools:
            self._pools[device] = (torch.cuda.graph_pool_handle(),
                                   torch.cuda.Stream())
        return self._pools[device]

    @staticmethod
    def _key(module, inputs, training, generator):
        """(the key of a call, the parameters that want a gradient in a
        training call); (None, None) where it runs eagerly whatever it
        observes: ``scan`` refuses the module, or a training call wants no
        gradient."""
        ptrs = scan(module)
        if ptrs is None:
            return None, None
        key = (tuple(None if x is None else (x.shape, x.dtype, x.device)
                     for x in inputs), ptrs)
        if not training:
            return key, None
        params = tuple(p for p in module.parameters() if p.requires_grad)
        wants = tuple(x is not None and x.requires_grad for x in inputs)
        if not (params or any(wants)):
            return None, None
        return key + ("train", wants, id(generator),
                      tuple(map(id, params))), params


@contextmanager
def _swapped(module: nn.Module, leaves: dict):
    """``module``'s parameters replaced, wherever they are registered, by
    the tensors that ``leaves`` maps their ids to."""
    undo = []
    for m in module.modules():
        d = m._parameters
        for k, v in d.items():
            if v is not None and id(v) in leaves:
                undo.append((d, k, v))
                d[k] = leaves[id(v)]
    try:
        yield
    finally:
        for d, k, v in undo:
            d[k] = v


def _remember(cache: OrderedDict, key, value) -> None:
    cache[key] = value
    if len(cache) > KEEP:
        cache.popitem(last=False)
