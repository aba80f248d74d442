"""CUDA graphs of the text tower's and the fusion's no-grad forward, and of
the fusion's training call (``lrce_tpu_torch/utils/graphs.py``).

On the CPU: every call runs the eager body and returns what it
returns, and the rule that sends a call to the eager body refuses a
gradient, ``training``, an active FLOP counter, a global hook, CPU inputs,
a model made tensor-parallel, a hook on an inner layer and a parameter of
a tensor subclass; the fusion's cache offers the training route (a gradient
and ``training`` with a CUDA generator) and BERT's does not; a training
call's key follows the route, the generator and which inputs and
parameters want a gradient; the key follows a replaced parameter and not
an in-place update; a traced request and a traced train step keep their
span trees and their counters.

On the card (marker ``cuda``; no JAX imported, so it runs with
``python -m pytest --noconftest tests/test_torch_graphs.py -m cuda``): at
BERT-base and the fusion's full widths, bf16 compute, the graph's output
equals the eager body's bit for bit (``torch.equal``) at batch 1 and 4, for
BERT and the oe head at the 5- and 16-frame memory and the mc and count
heads; the first call runs eagerly, the second captures, later ones replay;
new inputs, an in-place parameter update and replaced parameters are all
seen; gradients without ``training``, ``training`` without gradients and a
FLOP counter keep the eager body, and BERT's training call too; a traced
replay records one ``<name>.graph`` span and no counter; a replay allocates
no more than the eager call beyond the graph's own buffers. The fusion's
training route: every head's logits, input and parameter gradients,
parameters after AdamW and generator offset equal the eager steps' bit for
bit, with a no-grad call between a forward and its backward, two backwards
before a step, a new batch size, and two forwards before their backwards
(the second eager); an ``AgentOE`` over a small model at reg 0 (bit for bit) and
0.001 (to f32 rounding, every fusion gradient left in the graph's static
buffer), alone and under DDP on two gloo ranks of one card; a traced step
records ``fusion.graph`` and ``fusion.graph_bwd`` under ``backward``; a
replayed step's allocation plus the graph's pool stays within the eager
step's peak.
"""

import copy
import pickle

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from lrce_tpu_torch.models import bert as PB
from lrce_tpu_torch.models import e2e as PE
from lrce_tpu_torch.models import fusion as PF
from lrce_tpu_torch.models import swin3d as PS
from lrce_tpu_torch.tools.common import count_flops
from lrce_tpu_torch.utils import graphs, trace
from lrce_tpu_torch.utils.graphs import GraphCache

TINY_BERT = PB.BertConfig(vocab_size=50, hidden_size=24, num_layers=2,
                          num_heads=4, intermediate_size=32,
                          max_position_embeddings=40)
TINY = dict(dim=24, classes=7, res=(2, 2), dv=32, text=8)
FULL = dict(dim=768, classes=1000, res=(7, 7), dv=1024, text=32)
# module under test: (kind, frames); kind "bert" or a head's task type
MODULES = {"bert": ("bert", 5), "oe": ("oe", 5), "oe16": ("oe", 16),
           "mc": ("mc", 5), "count": ("count", 5)}
MC_CHOICES = 5


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def build(name, widths, device, compute=torch.float32):
    kind, frames = MODULES[name]
    gen = torch.Generator().manual_seed(0)
    if kind == "bert":
        cfg = TINY_BERT if widths is TINY else PB.BERT_BASE
        mod = PB.BertModel(cfg, generator=gen, compute_dtype=compute)
    else:
        classes = 1 if kind == "mc" else widths["classes"]
        mod = PF.LRCEHead(kind, widths["dim"], classes,
                          widths["res"], widths["dv"], frames, (3,),
                          widths["text"], torch.float32, gen)
    return mod.to(device)


def inputs(name, widths, device, batch, seed=0, compute=torch.float32,
           masks=True):
    """The positional inputs of the module's forward."""
    kind, frames = MODULES[name]
    g = torch.Generator().manual_seed(seed)
    n = widths["text"]
    if kind == "bert":
        vocab = 50 if widths is TINY else PB.BERT_BASE.vocab_size
        ids = torch.randint(0, vocab, (batch, n), generator=g)
        if not masks:
            return (ids.to(device), None, None)
        mask = torch.ones((batch, n), dtype=torch.int64)
        mask[:, n - 3:] = 0
        types = torch.zeros((batch, n), dtype=torch.int64)
        return tuple(t.to(device) for t in (ids, mask, types))
    hw = widths["res"][0] * widths["res"][1]
    video = torch.randn((batch, 3, (frames + 1) // 2, hw, widths["dv"]),
                        generator=g)
    text_shape = (batch, n, widths["dim"]) if kind != "mc" \
        else (batch, MC_CHOICES, n, widths["dim"])
    text = torch.randn(text_shape, generator=g)
    return (video.to(device, compute), text.to(device, compute), None)


def eager(mod, args):
    """The eager body alone, as the graph route's reference."""
    if isinstance(mod, PB.BertModel):
        return mod._forward(*args)
    return mod._forward(args[0], args[1])


def counts(mod):
    g = mod.graphs
    return (g.eager, g.captures, g.replays)


# ------------------------------------------------------------- the CPU

@pytest.mark.parametrize("name", list(MODULES))
def test_cpu_calls_run_the_eager_body(name):
    mod = build(name, TINY, "cpu")
    args = inputs(name, TINY, "cpu", batch=2)
    with torch.no_grad():
        want = eager(mod, args)
        outs = [mod(*args) for _ in range(3)]
    assert all(torch.equal(o, want) for o in outs)
    assert counts(mod) == (3, 0, 0)


@pytest.mark.parametrize("case", ["grad", "training", "mode", "hook",
                                  "device"])
def test_why_eager_names_the_refusal(case):
    mod = build("bert", TINY, "cpu")
    args = inputs("bert", TINY, "cpu", batch=1)
    training = case == "training"
    handle = None
    if case == "hook":
        handle = torch.nn.modules.module.register_module_forward_hook(
            lambda *_: None)
    try:
        with torch.set_grad_enabled(case == "grad"):
            if case == "mode":
                with FlopCounterMode(display=False):
                    got = graphs.why_eager(args, training)
            else:
                got = graphs.why_eager(args, training)
            out = mod(*args, training=training,
                      generator=torch.Generator().manual_seed(1))
    finally:
        if handle is not None:
            handle.remove()
    assert got == case
    assert out.shape == (1, TINY["text"], TINY_BERT.hidden_size)
    assert counts(mod) == (1, 0, 0)


@pytest.mark.parametrize("where", ["tensor_parallel_oe",
                                   "tensor_parallel_bert", "inner_hook",
                                   "subclass"])
def test_scan_refuses_tensor_parallel_groups_and_inner_hooks(where):
    """A model after ``shard_tensor_parallel`` (one rank, a stand-in group)
    is refused by the hooks that tensor parallelism puts on its layers."""
    from lrce_tpu_torch.parallel.tensor_parallel import shard_tensor_parallel

    mod = build("bert" if where.endswith("bert") else "oe", TINY, "cpu")
    n = len(list(mod.parameters())) + len(list(mod.buffers()))
    assert len(graphs.scan(mod)) == n
    mod.register_forward_hook(lambda *_: None)     # the root's own: allowed
    assert len(graphs.scan(mod)) == n
    if where.startswith("tensor_parallel"):
        shard_tensor_parallel(mod, 0, 1, object())
    else:
        layer = mod.fusion_transformer.transformer.layers[3]
        if where == "inner_hook":
            layer.norm2.register_forward_pre_hook(lambda *_: None)
        else:
            layer.norm3.weight = torch.nn.Parameter(
                layer.norm3.weight.detach().as_subclass(_Sub))
    assert graphs.scan(mod) is None


class _Sub(torch.Tensor):
    """A tensor subclass, as FSDP's DTensor parameters are."""


def test_scan_follows_replaced_parameters_not_inplace_updates():
    mod = build("bert", TINY, "cpu")
    before = graphs.scan(mod)
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(0.5)
    assert graphs.scan(mod) == before
    sd = {k: v.clone() for k, v in mod.state_dict().items()}
    mod.load_state_dict(sd, assign=True)
    replaced = graphs.scan(mod)
    assert replaced != before and len(replaced) == len(before)
    mod.double()
    assert graphs.scan(mod) != replaced


def test_cache_copies_and_pickles_empty():
    mod = build("oe", TINY, "cpu")
    args = inputs("oe", TINY, "cpu", batch=1)
    with torch.no_grad():
        mod(*args)
    twin = copy.deepcopy(mod)
    assert twin.graphs is not mod.graphs and counts(twin) == (0, 0, 0)
    again = pickle.loads(pickle.dumps(mod.graphs))
    assert again.name == "fusion" and again.eager == 0


def test_cpu_traced_request_keeps_its_spans_and_counters():
    cfg = PE.E2EConfig(
        feature_dim=24, num_classes=10, video_feature_res=(4, 4),
        video_feature_dim=16, frame_sample_size=5, temporal_scale=(3,),
        text_seq_len=8, task_type="oe",
        bert=TINY_BERT,
        swin=PS.SwinConfig(embed_dim=8, depths=(2, 2), num_heads=(1, 2),
                           window_size=(2, 4, 4), drop_path_rate=0.2))
    model = PE.LRCEModel(cfg, device="cpu")
    rng = np.random.default_rng(0)
    clips = torch.from_numpy(rng.integers(0, 256, (1, 3, 5, 32, 32, 3),
                                          dtype=np.uint8))
    ids = torch.from_numpy(rng.integers(0, 50, (1, 8)))
    mask = torch.ones((1, 8), dtype=torch.int64)
    types = torch.zeros((1, 8), dtype=torch.int64)
    want = PE.e2e_forward(model, clips, ids, mask, types)
    trace.enable()
    for _ in range(3):
        got = PE.e2e_forward(model, clips, ids, mask, types)
    trace.disable()
    spans, counters = trace.drain()
    assert torch.equal(got, want)
    assert counters == {"questions": 3, "clips": 9}
    names = [s.name for s in spans]
    assert names.count("fusion.clip") == 9 and names.count("bert") == 3
    assert not [n for n in names if n.endswith((".graph", ".capture"))]


class _CudaLike:
    """A stand-in for what ``why_eager`` reads of a CUDA generator or input
    (this CPU build makes neither)."""

    device = torch.device("cuda")
    is_cuda = True

    @staticmethod
    def is_contiguous():
        return True


TRAIN_CASES = {   # case: (grad, training, generator, cache's route, want)
    "grad": (True, False, _CudaLike(), True, "grad"),
    "training": (False, True, _CudaLike(), True, "training"),
    "bert_cache": (True, True, _CudaLike(), False, "grad"),
    "no_generator": (True, True, None, True, "generator"),
    "cpu_generator": (True, True, torch.Generator(), True, "generator"),
    "mode": (True, True, _CudaLike(), True, "mode"),
    "hook": (True, True, _CudaLike(), True, "hook"),
    "device": (True, True, _CudaLike(), True, "device"),
    "accepted": (True, True, _CudaLike(), True, None),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_why_eager_in_the_training_route(monkeypatch, case):
    """A cache with the training route takes a call that wants a gradient
    in training with a CUDA generator, and refuses the rest as a cache
    without it does."""
    grad, training, gen, train, want = TRAIN_CASES[case]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)      # this CPU build raises
    args = (torch.zeros(2) if case == "device" else _CudaLike(), None)
    handle = None
    if case == "hook":
        handle = torch.nn.modules.module.register_module_forward_hook(
            lambda *_: None)
    try:
        with torch.set_grad_enabled(grad):
            if case == "mode":
                with FlopCounterMode(display=False):
                    got = graphs.why_eager(args, training, gen, train)
            else:
                got = graphs.why_eager(args, training, gen, train)
    finally:
        if handle is not None:
            handle.remove()
    assert got == want


@pytest.mark.parametrize("name", list(MODULES))
def test_the_fusion_offers_the_training_route_and_bert_does_not(name):
    mod = build(name, TINY, "cpu")
    want = MODULES[name][0] != "bert"
    assert mod.graphs.train is want
    assert copy.deepcopy(mod).graphs.train is want
    assert pickle.loads(pickle.dumps(mod.graphs)).train is want


KEY_CHANGES = ["same", "no_grad", "generator", "input_grad", "frozen"]


@pytest.mark.parametrize("change", KEY_CHANGES)
def test_training_key_follows_route_generator_and_requires_grad(change):
    mod = build("oe", TINY, "cpu")
    video, text, _ = inputs("oe", TINY, "cpu", batch=2)
    video.requires_grad_()
    gen = torch.Generator()
    key = lambda *a: GraphCache._key(*a)[0]  # noqa: E731
    want = key(mod, (video, text), True, gen)
    assert want is not None and hash(want) is not None
    if change == "no_grad":
        got = key(mod, (video, text), False, None)
    elif change == "generator":
        got = key(mod, (video, text), True, torch.Generator())
    elif change == "input_grad":
        text.requires_grad_()
        got = key(mod, (video, text), True, gen)
    elif change == "frozen":
        mod.final_fc.bias.requires_grad_(False)
        got = key(mod, (video, text), True, gen)
    else:
        got = key(mod, (video.detach().clone().requires_grad_(),
                        text.clone()), True, gen)
    assert (got == want) is (change == "same")


def test_cpu_traced_train_step_keeps_its_spans_and_counters():
    """On the CPU the fusion's training call runs its eager body: the span
    tree and the counters of a traced step are the eager ones, and a plain
    ``enable()`` counts nothing new."""
    from lrce_tpu_torch.parallel.dryrun import TINY as CFG, dryrun_batch
    from lrce_tpu_torch.train.agent import AgentOE, default_args

    model = PE.LRCEModel(CFG, device="cpu")
    agent = AgentOE(model, default_args(lr=[1e-4] * 3), log_enabled=False,
                    seed=1)
    batch = dryrun_batch(2)
    trace.enable()
    for _ in range(3):
        agent.dispatch(*batch, is_train=True)
    trace.disable()
    spans, counters = trace.drain()
    assert counters == {"steps": 3, "questions": 6, "clips": 18,
                        "h2d_bytes": 3 * sum(a.nbytes for a in batch)}
    names = [s.name for s in spans]
    assert names.count("fusion.clip") == 9 and names.count("backward") == 3
    assert not [n for n in names if ".graph" in n or n.endswith(".capture")]
    assert [s.name for s in spans if s.parent < 0] == ["step"] * 3
    g = model.fusion_model.graphs
    assert (g.eager, g.captures, g.replays, g.backward_replays) == \
        (3, 0, 0, 0)


# ------------------------------------------------------------- the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


_BUILT = {}


def full(name, dev):
    """The module at full width on the card, bf16 compute, with an empty
    graph cache (built once per module and process)."""
    if name not in _BUILT:
        _BUILT[name] = build(name, FULL, dev, torch.bfloat16)
    mod = _BUILT[name]
    mod.graphs = GraphCache(mod.graphs.name, mod.graphs.train)
    return mod


def full_inputs(name, dev, batch, seed=0, masks=True):
    return inputs(name, FULL, dev, batch, seed, torch.bfloat16, masks)


CARD_CASES = [(n, b) for n in MODULES for b in (1, 4)] + [("bert-nomask", 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch", CARD_CASES,
                         ids=[f"{n}-b{b}" for n, b in CARD_CASES])
def test_graph_equals_eager_bit_for_bit(dev, name, batch):
    masks = name != "bert-nomask"
    name = name.split("-")[0]
    mod = full(name, dev)
    x1 = full_inputs(name, dev, batch, seed=1, masks=masks)
    x2 = full_inputs(name, dev, batch, seed=2, masks=masks)
    with torch.no_grad():
        want1, want2 = eager(mod, x1), eager(mod, x2)
        outs = []
        for i, expect in enumerate([(1, 0, 0), (1, 1, 0), (1, 1, 1),
                                    (1, 1, 2)]):
            outs.append(mod(*x1))
            assert counts(mod) == expect, i
        new = mod(*x2)
    torch.cuda.synchronize()
    for o in outs:
        assert torch.equal(o, want1)
    assert torch.equal(new, want2)      # new inputs between replays
    assert torch.equal(outs[-1], want1)     # a kept answer stays as it was
    assert counts(mod) == (1, 1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bert", "oe"])
def test_replay_reads_inplace_updates_and_recaptures_replaced_weights(dev,
                                                                      name):
    mod = full(name, dev)
    x = full_inputs(name, dev, 2)
    with torch.no_grad():
        for _ in range(3):
            mod(*x)
        assert counts(mod) == (1, 1, 1)
        for p in mod.parameters():      # as AdamW's step writes them
            p.mul_(1.01)
        updated = eager(mod, x)
        assert torch.equal(mod(*x), updated)
        assert counts(mod) == (1, 1, 2)
        mod.load_state_dict({k: v * 0.99 for k, v in
                             mod.state_dict().items()}, assign=True)
        replaced = eager(mod, x)
        outs = [mod(*x) for _ in range(3)]
    assert not torch.equal(replaced, updated)
    assert all(torch.equal(o, replaced) for o in outs)
    assert counts(mod) == (2, 2, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bert", "oe"])
def test_gradients_and_training_never_capture(dev, name):
    """Gradients without ``training`` and ``training`` without gradients
    run the eager body; with both, BERT's call stays eager and the
    fusion's takes the training route (eager, captured, then
    replayed)."""
    mod = full(name, dev)
    x = full_inputs(name, dev, 2)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(3):
        mod(*x).float().sum().backward()
    with torch.no_grad():
        for _ in range(3):
            mod(*x, training=True, generator=gen)
    assert counts(mod) == (6, 0, 0)
    for _ in range(3):
        mod(*x, training=True, generator=gen).float().sum().backward()
    assert counts(mod) == ((9, 0, 0) if name == "bert" else (7, 1, 1))
    assert mod.graphs.backward_replays == (0 if name == "bert" else 2)
    mod.zero_grad(set_to_none=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bert", "oe"])
def test_flop_counter_sees_the_eager_body(dev, name):
    mod = full(name, dev)
    x = full_inputs(name, dev, 2)
    with torch.no_grad():
        want = count_flops(lambda: eager(mod, x), mod)
        for _ in range(3):
            mod(*x)
        before = counts(mod)
        got = count_flops(lambda: mod(*x), mod)
    assert got == want > 0
    assert counts(mod) == (before[0] + 1, 1, before[2])


@pytest.mark.cuda
def test_traced_replay_records_one_graph_span_and_no_counter(dev):
    mod = full("oe", dev)
    x = full_inputs("oe", dev, 1)
    with torch.no_grad():
        trace.enable()
        mod(*x)
        first, _ = trace.drain()
        mod(*x)
        second, _ = trace.drain()
        mod(*x)
        third, counters = trace.drain()
        trace.disable()
    names = [s.name for s in first]
    assert names[0] == "fusion.embed" and names.count("fusion.clip") == 3
    assert second[0].name == "fusion.capture" and second[0].parent == -1
    assert [s.name for s in third] == ["fusion.graph"]
    assert counters == {}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bert", "oe"])
def test_replay_allocates_no_more_than_eager_beyond_its_buffers(dev, name):
    mod = full(name, dev)
    x = full_inputs(name, dev, 4)
    with torch.no_grad():
        out = mod(*x)       # eager
        torch.cuda.synchronize()
        after_eager = torch.cuda.memory_allocated(dev)
        reserved = torch.cuda.memory_reserved(dev)
        del out
        out = mod(*x)       # capture
        del out
        out = mod(*x)       # replay
        torch.cuda.synchronize()
        after_replay = torch.cuda.memory_allocated(dev)
        graph = next(iter(mod.graphs._graphs.values()))
        static = sum(t.nbytes for t in graph.inputs if t is not None) \
            + graph.output.nbytes
    print(f"{name}: allocated after eager {after_eager}, after replay "
          f"{after_replay}, static {static}; reserved {reserved} -> "
          f"{torch.cuda.memory_reserved(dev)}")
    assert after_replay <= after_eager + static


# ------------------------------------------- the fusion's training route

LR = 5e-5
HEAD_RATE = 0.5     # the benchmark's cells' fusion dropout
VARIANTS = [("oe", "plain"), ("oe16", "plain"), ("mc", "plain"),
            ("count", "plain"), ("oe", "eval_between"),
            ("oe", "two_backwards"), ("oe", "new_batch")]


def counts4(mod):
    g = mod.graphs
    return (g.eager, g.captures, g.replays, g.backward_replays)


def head_loss(name, logits, seed):
    g = torch.Generator().manual_seed(seed)
    b = logits.shape[0]
    if MODULES[name][0] == "count":
        gt = torch.randint(0, 5, (b,), generator=g).float()
        return ((logits.float() - gt.to(logits.device)) ** 2).mean()
    gt = torch.randint(0, logits.shape[1], (b,), generator=g)
    return torch.nn.functional.cross_entropy(logits.float(),
                                             gt.to(logits.device))


def head_run(mod, name, variant, dev):
    """Steps of AdamW over the head alone, on leaf inputs that want a
    gradient: what each step computed, read right after it."""
    gen = torch.Generator(device=dev).manual_seed(7)
    opt = torch.optim.AdamW(mod.parameters(), lr=LR, weight_decay=0.01)
    sizes = [4, 4, 2, 4, 2, 4] if variant == "new_batch" else [4] * 4
    seen = []
    for i, b in enumerate(sizes):
        opt.zero_grad(set_to_none=True)
        rec = {"logits": [], "loss": [], "input_grads": [], "eval": []}
        for j in range(2 if variant == "two_backwards" else 1):
            video, text, _ = full_inputs(name, dev, b, seed=10 * i + j)
            video.requires_grad_()
            text.requires_grad_()
            logits = mod(video, text, training=True, generator=gen)
            if variant == "eval_between":
                with torch.no_grad():
                    rec["eval"] += [mod(video, text) for _ in range(3)]
            loss = head_loss(name, logits, 10 * i + j)
            loss.backward()
            rec["logits"].append(logits.detach().clone())
            rec["loss"].append(loss.detach().clone())
            rec["input_grads"] += [video.grad.clone(), text.grad.clone()]
        rec["grads"] = [p.grad.clone() for p in mod.parameters()]
        opt.step()
        rec["params"] = [p.detach().clone() for p in mod.parameters()]
        rec["offset"] = gen.get_offset()
        rec["counts"] = counts4(mod)
        seen.append(rec)
    return seen


def assert_same_steps(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["offset"] == w["offset"], i
        for k in ("logits", "loss", "input_grads", "eval", "grads",
                  "params"):
            assert len(g[k]) == len(w[k]), (i, k)
            for n, (a, b) in enumerate(zip(g[k], w[k])):
                assert torch.equal(a, b), (i, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("name,variant", VARIANTS,
                         ids=[f"{n}-{v}" for n, v in VARIANTS])
def test_training_route_equals_the_eager_steps(dev, name, variant):
    """The head alone at full width: logits, loss, the inputs' and every
    parameter's gradients, the parameters after AdamW and the generator's
    offset equal the eager twin's bit for bit, step by step; the first call
    of a key runs eagerly, the second captures, and every call from the
    second replays one forward and one backward."""
    mod = build(name, FULL, dev)
    mod.dropout_rate = HEAD_RATE
    twin = copy.deepcopy(mod)
    twin.graphs = GraphCache("fusion")      # without the training route
    got = head_run(mod, name, variant, dev)
    want = head_run(twin, name, variant, dev)
    torch.cuda.synchronize()
    assert_same_steps(got, want)
    calls = 2 if variant == "two_backwards" else 1
    if variant == "new_batch":      # batch 4, 4, 2, 4, 2, 4
        assert [r["counts"] for r in got] == [
            (1, 0, 0, 0), (1, 1, 0, 1), (2, 1, 0, 1), (2, 1, 1, 2),
            (2, 2, 1, 3), (2, 2, 2, 4)]
    elif variant == "eval_between":     # + 3 no-grad calls a step
        assert [r["counts"] for r in got] == [
            (2, 1, 1, 0), (2, 2, 4, 1), (2, 2, 8, 2), (2, 2, 12, 3)]
    elif calls == 1:
        assert [r["counts"] for r in got] == [(1, 0, 0, 0)] + [
            (1, 1, i - 1, i) for i in range(1, len(got))]
    else:   # the second call of the first step captures
        assert [r["counts"] for r in got] == [
            (1, 1, calls * i - 2, calls * i - 1)
            for i in range(1, len(got) + 1)]
    assert want[-1]["counts"][1] == (variant == "eval_between")
    assert want[-1]["counts"][3] == 0
    mod.zero_grad(set_to_none=True)


@pytest.mark.cuda
def test_a_second_forward_before_the_backward_raises(dev):
    """Two training forwards of one key before their backwards (two
    micro-batches of one shape): the second runs eagerly, since the first
    one's activations await its backward, and logits, gradients and the
    generator's offset equal the eager twin's bit for bit. A second
    backward of one replay (``retain_graph``) raises: the first backward
    replay overwrote the activations it would read."""
    mod = build("oe", FULL, dev)
    mod.dropout_rate = HEAD_RATE
    twin = copy.deepcopy(mod)
    twin.graphs = GraphCache("fusion")
    x = full_inputs("oe", dev, 2)[:2]
    seen, gens = [], []
    for m in (mod, twin):
        gen = torch.Generator(device=dev).manual_seed(0)
        gens.append(gen)
        for _ in range(2):      # eager, then captured and replayed
            m(*x, training=True, generator=gen).float().sum().backward()
        m.zero_grad(set_to_none=True)
        first = m(*x, training=True, generator=gen)
        second = m(*x, training=True, generator=gen)
        second.float().sum().backward()
        first.float().sum().backward()
        seen.append({"logits": [first.detach(), second.detach()],
                     "grads": [p.grad.clone() for p in m.parameters()],
                     "offset": gen.get_offset()})
    torch.cuda.synchronize()
    got, want = seen
    assert got["offset"] == want["offset"]
    for k in ("logits", "grads"):
        for n, (a, b) in enumerate(zip(got[k], want[k])):
            assert torch.equal(a, b), (k, n)
    assert counts4(mod) == (2, 1, 1, 2)
    third = mod(*x, training=True, generator=gens[0])
    third.float().sum().backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="overwritten"):
        third.float().sum().backward()
    mod.zero_grad(set_to_none=True)


@pytest.mark.cuda
def test_a_dropped_graph_leaves_its_gradients_intact(dev):
    """A parameter's ``.grad`` that is a graph's static buffer keeps that
    buffer alive: dropping the cache (as ``KEEP`` drops a graph) and
    filling the freed memory leaves the gradients as they were."""
    import gc

    mod = build("oe", FULL, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = full_inputs("oe", dev, 2)[:2]
    for _ in range(3):      # eager, captured, replayed
        mod.zero_grad(set_to_none=True)
        mod(*x, training=True, generator=gen).float().sum().backward()
    assert in_static(mod)[0] > 0
    want = [p.grad.clone() for p in mod.parameters()]
    mod.graphs = GraphCache("fusion", train=True)
    gc.collect()
    torch.cuda.empty_cache()
    junk = [torch.full((1 << 24,), float("nan"), device=dev)
            for _ in range(64)]
    torch.cuda.synchronize()
    for n, (p, w) in enumerate(zip(mod.parameters(), want)):
        assert torch.equal(p.grad, w), n
    del junk


def agent_run(dev, reg, graphed, batches):
    """AgentOE steps over a small model (bf16 compute, dropout and
    drop-path on), read right after each step."""
    from lrce_tpu_torch.parallel.dryrun import TINY as CFG
    from lrce_tpu_torch.train.agent import AgentOE, default_args

    model = PE.LRCEModel(CFG, device=dev, compute_dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(3))
    if not graphed:
        model.fusion_model.graphs = GraphCache("fusion")
    agent = AgentOE(model, default_args(lr=[LR] * 3, reg_strength=reg),
                    log_enabled=False, seed=5)
    logits = []
    model.fusion_model.register_forward_hook(
        lambda _m, _a, out: logits.append(out.detach().clone()))
    seen = []
    for batch in batches:
        loss = agent.step(*batch, is_train=True)
        seen.append({
            "loss": loss, "logits": logits[-1],
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "offset": agent.generator.get_offset(),
            "counts": counts4(model.fusion_model),
            "settled": in_static(model.fusion_model)})
    return seen


def in_static(mod):
    """(the parameters whose ``.grad`` lies in a graph's static gradient
    buffers, the static parameter gradients of the graphs)."""
    static = [g for graph in mod.graphs._graphs.values()
              for g in graph.grads[graph.first_param:] if g is not None]
    ptrs = {g.data_ptr() for g in static}
    return (sum(p.grad is not None and p.grad.data_ptr() in ptrs
                for p in mod.parameters()), len(static))


def agent_batches(n, questions=4):
    from lrce_tpu_torch.parallel.dryrun import dryrun_batch

    out = []
    for i in range(n):
        rng = np.random.RandomState(100 + i)
        clips, ids, mask, types, gt = dryrun_batch(questions)
        out.append((rng.rand(*clips.shape).astype(np.float32),
                    rng.randint(1, 64, ids.shape), mask, types,
                    rng.randint(0, 11, gt.shape)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("reg", [0.0, 0.001])
def test_agent_steps_with_the_training_route_equal_eager(dev, reg):
    """Four AgentOE steps (the first eager, the second captured, three
    replayed) against the same steps eager from the same seeds. At reg 0
    the loss, the fusion's logits, every parameter's gradient, the
    parameters after AdamW and the generator's offset are equal bit for
    bit. At reg 0.001 the l2 term's gradient joins the graph's sum from
    outside it (one f32 addition grouped otherwise): equal to f32
    rounding. After each replayed step every fusion parameter's ``.grad``
    lies in the graph's static buffer, the l2 term's included: one
    gradient buffer a parameter, as eagerly."""
    batches = agent_batches(4)
    got = agent_run(dev, reg, True, batches)
    want = agent_run(dev, reg, False, batches)
    torch.cuda.synchronize()
    assert [r["counts"] for r in got] == [(1, 0, 0, 0), (1, 1, 0, 1),
                                          (1, 1, 1, 2), (1, 1, 2, 3)]
    assert [r["counts"] for r in want] == [(i, 0, 0, 0) for i in (1, 2, 3, 4)]
    assert got[0]["settled"] == (0, 0)
    n = got[1]["settled"][1]
    assert n > 0 and [r["settled"] for r in got[1:]] == [(n, n)] * 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["offset"] == w["offset"], i
        assert g["grads"].keys() == w["grads"].keys()
        if reg == 0.0 or i == 0:
            assert g["loss"] == w["loss"], i
            assert torch.equal(g["logits"], w["logits"]), i
            for k in w["grads"]:
                assert torch.equal(g["grads"][k], w["grads"][k]), (i, k)
            for k in w["params"]:
                assert torch.equal(g["params"][k], w["params"][k]), (i, k)
            continue
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        torch.testing.assert_close(g["logits"], w["logits"])
        worst = {}
        for k, wg in w["grads"].items():
            scale = float(wg.abs().max())
            d = float((g["grads"][k] - wg).abs().max())
            worst[k] = d / max(scale, 1e-30)
            assert d <= 1e-5 * scale, (i, k, d, scale)
        dp = max(float((g["params"][k] - w["params"][k]).abs().max())
                 for k in w["params"])
        print(f"step {i}: worst relative gradient gap "
              f"{max(worst.values()):.3g}, largest parameter gap {dp:.3g}")
        assert dp <= 2 * LR * (i + 1), (i, dp)


@pytest.mark.cuda
def test_traced_training_step_records_graph_spans_under_backward(dev):
    batches = agent_batches(4)
    from lrce_tpu_torch.parallel.dryrun import TINY as CFG
    from lrce_tpu_torch.train.agent import AgentOE, default_args

    model = PE.LRCEModel(CFG, device=dev, compute_dtype=torch.bfloat16)
    agent = AgentOE(model, default_args(lr=[LR] * 3), log_enabled=False)
    for b in batches[:2]:       # eager, then captured
        agent.step(*b, is_train=True)
    trace.enable()
    for b in batches[2:]:
        agent.step(*b, is_train=True)
    trace.disable()
    spans, counters = trace.drain()
    assert [s.name for s in spans if s.parent < 0] == ["step"] * 2
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    assert len(by_name["fusion.graph"]) == len(by_name["fusion"]) == 2
    assert len(by_name["fusion.graph_bwd"]) == 2
    assert "fusion.capture" not in by_name and "fusion.clip" not in by_name
    for s in by_name["fusion.graph_bwd"]:
        assert spans[s.parent].name == "backward"
    assert set(counters) == {"steps", "questions", "clips", "h2d_bytes"}


@pytest.mark.cuda
@pytest.mark.parametrize("reg", [0.0, 0.001])
def test_training_route_under_ddp_equals_eager(dev, reg):
    """Two gloo ranks on one card run three DDP steps with the fusion's
    training route and then the same steps eagerly, from the same state:
    DDP's hooks take the graph's gradients when autograd accumulates them
    (at reg 0.001 after ``_settle`` has moved the l2 term's sum into the
    static buffer), and the losses, the parameters and AdamW's moments are
    equal bit for bit at reg 0, to f32 rounding at 0.001."""
    from lrce_tpu_torch.parallel import mesh as PM
    from lrce_tpu_torch.parallel import rank_checks as RC
    from lrce_tpu_torch.parallel.dryrun import TINY as CFG
    from lrce_tpu_torch.train.agent import default_args

    model = PE.LRCEModel(CFG, device="cpu")
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    batches = agent_batches(3)
    args = default_args(lr=[LR] * 3, reg_strength=reg)
    plan = [("train", 0), ("train", 1), ("train", 2), ("graphs",),
            ("snapshot",), ("fresh",), ("eager",), ("train", 0),
            ("train", 1), ("train", 2), ("graphs",)]
    out = PM.spawn(RC.agent_run, 2, (CFG, state, batches, 1, 1, args, plan),
                   device=f"cuda:{dev.index or 0}", backend="gloo")
    assert out["net"] == "DistributedDataParallel"

    def same(a, b, bound):
        if reg == 0.0:
            return np.array_equal(a, b)
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return a.shape == b.shape and bool(np.abs(a - b).max(initial=0)
                                           <= bound(b))

    for rank in out["seen"]:
        assert rank[3] == (1, 1, 1, 2) and rank[7] == (3, 0, 0, 0)
        for a, b in zip(rank[:3], rank[4:7]):
            assert same(a, b, lambda w: 1e-5 * np.abs(w).max(initial=0))
    graphed = out["snapshots"][0]
    for k, v in out["state"].items():
        assert same(graphed["state"][k], v, lambda w: 2 * LR * 3), k
    for i, st in out["optimizer"].items():
        for k, v in st.items():
            assert same(graphed["optimizer"][i][k], v,
                        lambda w: 1e-5 * np.abs(w).max(initial=0)), (i, k)


@pytest.mark.cuda
def test_training_replay_allocates_no_more_than_eager(dev):
    """A graphed training step holds no more device memory than the eager
    step: the peak allocated outside what it held before, plus the whole of
    the graph's pool (whose free blocks serve no other allocation, and in
    which the replay's activations and gradients lie unseen by
    ``max_memory_allocated``), is within a quarter of the eager step's
    peak. A graph that held its gradients twice, or a second copy of its
    activations, would add about as much again."""
    def step(mod, gen):
        video, text, _ = full_inputs("oe", dev, 4, seed=1)
        video.requires_grad_()
        mod(video, text, training=True, generator=gen).float().sum() \
            .backward()
        mod.zero_grad(set_to_none=True)

    def peak_above_base(mod, gen):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        step(mod, gen)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) - base

    eager = build("oe", FULL, dev)
    eager.graphs = GraphCache("fusion")
    gen = torch.Generator(device=dev).manual_seed(0)
    eager_peak = peak_above_base(eager, gen)
    del eager
    mod = build("oe", FULL, dev)
    peaks = [peak_above_base(mod, gen) for _ in range(4)]  # eager, capture
    assert counts4(mod) == (1, 1, 2, 3)
    graph = next(iter(mod.graphs._graphs.values()))
    pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(graph.pool))
    print(f"training step: eager peak {eager_peak}; graphed peaks {peaks}, "
          f"pool {pool}; reserved {torch.cuda.memory_reserved(dev)}")
    assert pool > 0
    assert peaks[-1] + pool <= 1.25 * eager_peak
