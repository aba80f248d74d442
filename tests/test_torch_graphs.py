"""CUDA graphs of the text tower's and the fusion's no-grad forward
(``lrce_tpu_torch/utils/graphs.py``).

On the CPU: every call runs the eager body and returns what it
returns, and the rule that sends a call to the eager body refuses a
gradient, ``training``, an active FLOP counter, a global hook, CPU inputs,
a model made tensor-parallel, a hook on an inner layer and a parameter of
a tensor subclass; the key follows a replaced parameter and not an in-place
update; a traced request keeps its span tree and its counters.

On the card (marker ``cuda``; no JAX imported, so it runs with
``python -m pytest --noconftest tests/test_torch_graphs.py -m cuda``): at
BERT-base and the fusion's full widths, bf16 compute, the graph's output
equals the eager body's bit for bit (``torch.equal``) at batch 1 and 4, for
BERT and the oe head at the 5- and 16-frame memory and the mc and count
heads; the first call runs eagerly, the second captures, later ones replay;
new inputs, an in-place parameter update and replaced parameters are all
seen; gradients, ``training`` and a FLOP counter keep the eager body; a
traced replay records one ``<name>.graph`` span and no counter; a replay
allocates no more than the eager call beyond the graph's own buffers.
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
    mod.graphs = GraphCache(mod.graphs.name)
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
    mod = full(name, dev)
    x = full_inputs(name, dev, 2)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(3):
        mod(*x).float().sum().backward()
    with torch.no_grad():
        for _ in range(3):
            mod(*x, training=True, generator=gen)
    assert counts(mod) == (6, 0, 0)
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
