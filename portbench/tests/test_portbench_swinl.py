"""The Video Swin-L configuration and the cells and metrics that came with
it: its counts against ``FlopCounterMode`` over the reference's forward,
the registry's view of the two new cells (``msvd-swinl384-train`` and the
four-card ``msvd-train-ddp4``), the program built as the configuration
states, the window-attention reader (``attn_trace.py``) on a synthetic
trace, its counters held to the shapes in a tiny traced run, and the new
metrics reading None where they find nothing."""

import json
import time

import pytest
import torch

from portbench import attn_trace, harness, program, spans, trace
from portbench.peaks import PEAKS
from portbench.registry import ROOT, Registry
from portbench.tests import tiny
from portbench.tests.test_portbench_counts import counted
from portbench.tests.test_portbench_trace import Ev, OlderEv

SEED = 2**33 + 29
CONFIG = "lrce-msvd-swin-l384"
NEW_CELLS = ("msvd-swinl384-train", "msvd-train-ddp4")
NEW_METRICS = ("window_attn_ms.train", "window_attn_roofline.train",
               "nccl_ms.train")
MAIN, BWD = 1, 2


def config() -> dict:
    return json.loads((ROOT / "configs" / f"{CONFIG}.json").read_text())


def small() -> dict:
    """The configuration with its depths and frames cut and every width
    kept: 2 blocks a stage and 192 x 192 frames, so the window is still
    (3, 12, 12) at stages 0-2."""
    c = config()
    c["swin"] = {**c["swin"], "depths": [2, 2, 2, 2]}
    c["frame_size"] = 192
    c["video_feature_res"] = [6, 6]
    return c


@pytest.mark.parametrize("which", ["published", "small"])
def test_the_count_is_the_reference_forwards_products(which):
    c = config() if which == "published" else small()
    pieces = Registry().counts(CONFIG).pieces
    fwd = pieces(c, 2, train=False)
    assert sum(p.flops for p in fwd) == counted(c, 2)


def test_the_tower_costs_671_gflop_a_clip():
    pieces = Registry().counts(CONFIG).pieces(config(), 1, train=False)
    swin = sum(p.flops for p in pieces if p.part == "swin") / 3
    assert 671e9 < swin < 672e9


@pytest.mark.parametrize("name", NEW_CELLS)
def test_the_registry_loads_the_new_cells(name):
    reg = Registry()
    cell = reg.workload(name)
    assert reg.config(cell["config"])["name"] == cell["config"]
    assert reg.traffic(cell["traffic"])["kind"] == "steps"
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        cell["config"], cell["traffic"], cell["chips"])
    spec = harness.make_spec(name, SEED, 1.0, True)
    e2e, per = harness.assigned(spec)
    assert {"clips_per_s", "setup_s", "peak_gib"} <= {m["name"] for m in e2e}
    for m in per:
        spec.registry.metric(m["name"])
    names = {m["name"] for m in per}
    if name == "msvd-train-ddp4":
        assert "nccl_ms.train" in names and "window_attn_ms.train" \
            not in names
    else:
        assert {"window_attn_ms.train", "window_attn_roofline.train"} <= names


def test_the_program_builds_swin_l_as_stated():
    c = config()
    net = program.build_model(None, torch.device("meta"),
                              program.model_config(c))
    swin = net.video_extractor.swin
    assert swin.cfg.embed_dim == 192 and swin.cfg.window_size == (8, 12, 12)
    assert [layer.num_heads for layer in swin.layers] == [6, 12, 24, 48]
    assert swin.norm.weight.shape == (1536,)
    assert net.fusion_model.projection_layer.weight.shape == (768, 1536)
    assert program.model_config(c).swin == program.S.SWIN_LARGE


def test_expected_counters_from_the_shapes():
    """Swin-L at 384 on 5 frames: every window of every stage holds 432
    tokens, (64, 16, 4, 1) windows a clip at heads (6, 12, 24, 48)."""
    got = attn_trace.expected_counters(config(), 60)
    wh = 60 * (2 * 64 * 6 + 2 * 16 * 12 + 18 * 4 * 24 + 2 * 1 * 48)
    assert got == {"attn.window_heads": wh, "attn.window_heads_big": wh}
    c16 = json.loads((ROOT / "configs" / "lrce-msvd-16f.json").read_text())
    assert attn_trace.expected_counters(c16, 1)["attn.window_heads_big"] == 0
    assert [s[3] for s in attn_trace.stages(c16)] == [392] * 4


def test_the_bound_is_below_the_count_of_the_model():
    """The attention's least time uses less of the card than the products
    the whole step's count holds (``lrce_counts``), and is bound by the
    bytes at head_dim 32."""
    c, pk = config(), PEAKS["H100"]
    bound = attn_trace.bound_s(c, 60, pk)
    flops = sum(p.flops for p in
                Registry().counts(CONFIG).pieces(c, 20, train=True))
    assert 0 < bound < flops / pk["bf16_flops"]
    only_flops = attn_trace.bound_s(c, 60, {**pk, "hbm_bytes": float("inf")})
    assert only_flops < bound


def _events(cls):
    def prog(name, s, d):
        return cls("user_annotation", spans.PROGRAM + name, s, d,
                   thread=MAIN)

    def launch(corr, t, thread=MAIN):
        return cls("cuda_runtime", "cudaLaunchKernel", t, 1, corr=corr,
                   thread=thread)

    def kernel(corr, s, d, name):
        return cls("kernel", name, s, d, corr=corr)

    def node(s, d, seq):
        return cls("cpu_op", trace.BACKWARD + ": _WindowAttentionFnBackward",
                   s, d, seq=seq, thread=BWD, fwd_thread=MAIN)

    big = "void lrce::(anonymous namespace)::attn_fwd_big_kernel<32, 4>(int)"
    return [
        cls("user_annotation", trace.WINDOW, 0, 1000),
        prog("step", 0, 900),
        prog("forward", 10, 300),
        prog("swin", 20, 200),
        prog("swin.s0", 30, 100),
        cls("cpu_op", "_WindowAttentionFn", 35, 5, seq=4),
        launch(1, 40),
        launch(2, 45),
        prog("swin.s3", 140, 60),
        launch(3, 150),
        prog("fusion", 230, 50),
        launch(4, 240),                 # an attention-like name elsewhere
        node(400, 100, 4),
        launch(5, 410, BWD),
        launch(6, 420, BWD),
        kernel(1, 100, 30, big),
        kernel(2, 130, 20, "gemm_wgmma_kernel<0, false>"),
        kernel(3, 200, 10, "void attn_fwd_kernel<32, 19>(int)"),
        kernel(4, 300, 40, "attn_fwd_kernel<32, 0>"),
        kernel(5, 500, 50, "attn_bwd_rows_kernel<32>"),
        kernel(6, 550, 70, "void (anonymous namespace)::attn_bwd_cols_"
                           "kernel<32, 84>(int)"),
    ]


@pytest.mark.parametrize("cls", [Ev, OlderEv])
def test_the_reader_takes_the_attention_kernels_of_the_stage_spans(cls):
    s = attn_trace.reduce(_events(cls), units=1)
    ns = 1e-9
    assert s["launches"] == 4 and s["outside"] == 1
    assert abs(s["forward_s"] - 40 * ns) < 1e-15
    assert abs(s["backward_s"] - 120 * ns) < 1e-15
    assert s["by_stage_s"] == pytest.approx({"s0": 150 * ns, "s3": 10 * ns})
    assert set(s["by_kernel_s"]) == {"attn_fwd_big_kernel", "attn_fwd_kernel",
                                     "attn_bwd_rows_kernel",
                                     "attn_bwd_cols_kernel"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("cells"))


def test_a_tiny_traced_run_holds_the_counters_and_reads_none(root):
    """On the CPU no attention kernel runs, so both window-attention
    metrics read None; the sub-window's counters equal the shapes' (else it
    raises), and a one-card cell has no NCCL reading."""
    spec = harness.make_spec("tiny-train", SEED, 0.5, True, root=root,
                             benchmark=tiny.benchmark("tiny-train"))
    cpu = torch.device("cpu")
    outs = harness.run_ranks(spec, cpu, root)
    r = spec.registry.mode("train").finish(spec, outs, cpu, time.time())[1]
    for name in NEW_METRICS:
        assert spec.registry.metric(name).read(r) is None
    clips = 4 * 3
    assert r["window_attn"]["counters"] == attn_trace.expected_counters(
        tiny.CONFIG, clips)
    assert r["window_attn"]["launches"] == 0


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    class Old:      # a tracer of a program that predates count_detail
        def enable(self):
            pass

    monkeypatch.setattr(spans, "tracer", lambda: Old())
    r = {"mode": "train", "chips": 1}
    assert attn_trace.readings(r) is None and r["window_attn"] is None
    assert attn_trace.device_ms({"mode": "train", "chips": 1}) is None
