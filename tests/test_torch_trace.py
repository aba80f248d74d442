"""The port's tracer (``lrce_tpu_torch/utils/trace.py``) and its spans at
the layer boundaries of the train step and the request, on the CPU: off, it
records nothing and opens no profiler range; on, it records the span tree
of a step with its counters, on the clock of the profiler's events, and
changes no number the step computes."""

import statistics
import time

import numpy as np
import pytest
import torch

from lrce_tpu_torch.models import bert as PB
from lrce_tpu_torch.models import e2e as PE
from lrce_tpu_torch.models import swin3d as PS
from lrce_tpu_torch.train.agent import AgentOE, default_args
from lrce_tpu_torch.utils import trace

B = 2   # questions of the tiny batch
FUSION = ("fusion", [("fusion.embed", []), ("fusion.clip", []),
                     ("fusion.clip", []), ("fusion.clip", []),
                     ("fusion.head", [])])
SWIN = ("swin", [("swin.s0", []), ("swin.s1", [])])
FORWARD = ("forward", [SWIN, ("bert", []), FUSION])
TRAIN_TREE = ("step", [("h2d", []), ("optimizer", []), FORWARD, ("loss", []),
                       ("backward", []), ("optimizer", []), ("metrics", [])])
EVAL_TREE = ("step", [("h2d", []), FORWARD, ("loss", []), ("metrics", [])])


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def tiny_model():
    cfg = PE.E2EConfig(
        feature_dim=24, num_classes=10, video_feature_res=(4, 4),
        video_feature_dim=16, frame_sample_size=5, temporal_scale=(3,),
        text_seq_len=8, task_type="oe", drop_out_rate=0.5,
        bert=PB.BertConfig(vocab_size=200, hidden_size=24, num_layers=2,
                           num_heads=2, intermediate_size=48,
                           max_position_embeddings=40),
        swin=PS.SwinConfig(embed_dim=8, depths=(2, 2), num_heads=(1, 2),
                           window_size=(2, 4, 4), drop_path_rate=0.2))
    return PE.LRCEModel(cfg, device="cpu")


def tiny_batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 256, (B, 3, 5, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(103, 200, (B, 8))
    mask = np.ones((B, 8), np.int64)
    mask[:, 6:] = 0
    types = np.zeros((B, 8), np.int64)
    gt = rng.integers(0, 10, (B,))
    return clips, ids, mask, types, gt


def tiny_agent():
    return AgentOE(tiny_model(), default_args(lr=[1e-3] * 3),
                   log_enabled=False, seed=3)


def tree(spans, parent=-1):
    return [(s.name, tree(spans, i)) for i, s in enumerate(spans)
            if s.parent == parent]


def test_off_a_span_is_one_shared_null_and_records_nothing():
    assert not trace.enabled()
    assert trace.span("step") is trace.span("fusion")
    with trace.span("step"):
        trace.count("steps")
    assert trace.drain() == ([], {})


def test_off_a_profiled_step_holds_no_program_range():
    from torch.profiler import ProfilerActivity, profile

    agent = tiny_agent()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        agent.dispatch(*tiny_batch(), is_train=True)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert names and not any(n.startswith(trace.PREFIX) for n in names)
    assert trace.drain() == ([], {})


def test_on_parents_steps_self_time_counters_and_drain():
    trace.enable()
    for _ in range(2):
        with trace.span("step"):
            trace.count("steps")
            with trace.span("forward"):
                time.sleep(0.004)
                with trace.span("fusion"):
                    trace.count("clips", 3)
                    time.sleep(0.006)
    spans, counters = trace.drain()
    assert [(s.name, s.parent, s.step) for s in spans] == [
        ("step", -1, 0), ("forward", 0, 0), ("fusion", 1, 0),
        ("step", -1, 1), ("forward", 3, 1), ("fusion", 4, 1)]
    assert counters == {"steps": 2, "clips": 6}
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert trace.host_ms(spans, "forward") >= 10.0
    assert 4.0 <= trace.self_ms(spans, "forward") < \
        trace.host_ms(spans, "forward") - 5.0
    assert trace.drain() == ([], {})
    with trace.span("step"):    # units count from 0 again after a drain
        pass
    assert trace.drain()[0][0].step == 0


def test_a_span_on_another_thread_goes_under_the_open_unit():
    """The autograd engine runs a CUDA backward node on a thread of its own
    while the caller waits inside its span: a span opened on a thread with
    none open goes under the innermost span of the thread that holds the
    unit, and starts a unit of its own when no unit is open."""
    import threading

    def on_a_thread(name):
        t = threading.Thread(target=lambda: trace.span(name).__enter__()
                             .__exit__(None, None, None))
        t.start()
        t.join()

    trace.enable()
    with trace.span("step"):
        with trace.span("backward"):
            on_a_thread("fusion.graph_bwd")
        with trace.span("optimizer"):
            pass
    on_a_thread("alone")
    spans, _ = trace.drain()
    assert [(s.name, s.parent, s.step) for s in spans] == [
        ("step", -1, 0), ("backward", 0, 0), ("fusion.graph_bwd", 1, 0),
        ("optimizer", 0, 0), ("alone", -1, 1)]


def test_host_and_self_ms_are_medians_over_units():
    S = trace.Span
    ms = 1_000_000
    spans = [S("step", 0, 10 * ms, -1, 0), S("fusion", 0, 4 * ms, 0, 0),
             S("fusion.clip", 0, 1 * ms, 1, 0),
             S("fusion", 5 * ms, 7 * ms, 0, 0),
             S("step", 20 * ms, 30 * ms, -1, 1),
             S("fusion", 20 * ms, 23 * ms, 4, 1),
             S("step", 40 * ms, 50 * ms, -1, 2)]
    assert trace.host_ms(spans, "fusion") == 3.0    # median of 6, 3, 0
    assert trace.self_ms(spans, "fusion") == 3.0    # of 5, 3, 0
    assert trace.self_ms(spans, "step") == 7.0      # of 4, 7, 10
    assert trace.host_ms(spans, "backward") == 0.0


def test_spans_lie_within_a_millisecond_of_their_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile

    agent = tiny_agent()
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        agent.dispatch(*tiny_batch(), is_train=True)
    spans, _ = trace.drain()
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                     e.name()[len(trace.PREFIX):])
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(trace.PREFIX))
    assert len(ranges) == len(spans) == 18
    ms = 1_000_000
    for s, (start, end, name) in zip(sorted(spans, key=lambda s: s.start_ns),
                                     ranges):
        # each span is timed inside its range, on the same clock
        assert s.name == name
        assert start - ms < s.start_ns <= s.end_ns < end + ms
    starts = sorted(s.start_ns for s in spans)
    assert statistics.median(a - r[0] for a, r in zip(starts, ranges)) < ms


@pytest.mark.parametrize("is_train,want", [(True, TRAIN_TREE),
                                           (False, EVAL_TREE)])
def test_a_dispatch_records_the_span_tree_and_counters(is_train, want):
    agent = tiny_agent()
    batch = tiny_batch()
    trace.enable()
    agent.dispatch(*batch, is_train=is_train)
    spans, counters = trace.drain()
    assert tree(spans) == [want]
    assert {s.step for s in spans} == {0}
    assert counters == {"steps": 1, "questions": B, "clips": 3 * B,
                        "h2d_bytes": sum(a.nbytes for a in batch)}


def test_a_request_records_forward_over_swin_bert_and_fusion():
    model = tiny_model()
    x = [torch.from_numpy(a) for a in tiny_batch()[:4]]
    trace.enable()
    PE.e2e_forward(model, *x)
    spans, counters = trace.drain()
    assert tree(spans) == [FORWARD]
    assert counters == {"questions": B, "clips": 3 * B}


@pytest.mark.parametrize("detail", [False, True])
def test_work_counters_only_where_asked(detail):
    """``enable(detail=True)`` adds the window x head pairs of every Swin
    block's forward attention: stage 0, 8 windows a clip (a (3, 8, 8) map
    padded to (4, 8, 8) in (2, 4, 4) windows) x 1 head, stage 1 2 windows
    x 2 heads, two blocks each, over 6 clips; no window has more than 400
    tokens. A plain ``enable()`` counts what it counted before."""
    model = tiny_model()
    x = [torch.from_numpy(a) for a in tiny_batch()[:4]]
    trace.enable(detail=detail)
    PE.e2e_forward(model, *x)
    _, counters = trace.drain()
    want = {"questions": B, "clips": 3 * B}
    if detail:
        want["attn.window_heads"] = 3 * B * (2 * 8 * 1 + 2 * 2 * 2)
    assert counters == want


@pytest.mark.parametrize("grad", [False, True], ids=["nograd", "grad"])
def test_wide_mlp_counters(monkeypatch, grad):
    """``enable(detail=True)`` counts the blocks on the K2 route (C >
    ``BLOCK_KERNEL_MAX_C``, cut to 16 here so that every stage takes it)
    whose LN2 + MLP ran ``fused_ln_mlp`` (all of them) and those whose
    forward ran K7 (``ln_mlp_supported``: C = 64 and 128, not 32): 6 and 4
    over three stages of two blocks, with grad mode on or off; a plain
    ``enable()`` counts neither."""
    monkeypatch.setattr(PS, "BLOCK_KERNEL_MAX_C", 16)
    cfg = PS.SwinConfig(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 4),
                        window_size=(2, 3, 3))
    swin = PS.SwinTransformer3D(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.randn((1, 4, 48, 48, 3), generator=torch.Generator().manual_seed(1))
    x.requires_grad_(grad)
    for detail in (False, True):
        trace.enable(detail=detail)
        with torch.set_grad_enabled(grad):
            swin(x)
        _, counters = trace.drain()
        trace.disable()
        wide = {k: v for k, v in counters.items() if k.startswith("swin.")}
        assert wide == ({"swin.wide_mlp_fused": 6, "swin.wide_mlp_k7": 4}
                        if detail else {})


def test_tracing_changes_no_number():
    batch = tiny_batch(1)
    x = [torch.from_numpy(a) for a in batch[:4]]
    out = {}
    for on in (False, True):
        agent = tiny_agent()
        if on:
            trace.enable()
        vec = agent.dispatch(*batch, is_train=True)
        logits = PE.e2e_apply(agent.model, *x, training=True,
                              generator=torch.Generator().manual_seed(5))
        trace.disable()
        out[on] = (vec.detach(), logits.detach(),
                   [p.detach().clone() for p in agent.model.parameters()])
    assert trace.drain()[0]
    for a, b in zip(out[False][:2], out[True][:2]):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(out[False][2], out[True][2]))
