"""The readers of the program's own spans (``portbench/spans.py``): the
reduction of a device trace against the program's ``lrce.*`` ranges, the
host sub-window's units, a traced tiny run whose earlier readings the new
sub-windows leave as they were, a program without the tracer, and the
sources the per-layer metrics name."""

import copy
import json
import time

import pytest
import torch

from portbench import harness, spans, trace
from portbench.registry import ROOT
from portbench.tests import tiny
from portbench.tests.test_portbench_trace import Ev, OlderEv

SEED = 2**33 + 17
MAIN, BWD, OTHER = 1, 2, 3
NEW = {"train": ["fusion_host_ms.train", "backward_host_ms.train",
                 "optimizer_host_ms.train"],
       "request": ["fusion_host_ms.request", "fusion_launches.request"]}
SOURCES = {"host_clock", "device_trace", "program_span", "program_counter"}


def make_events(cls):
    def prog(name, s, d):
        return cls("user_annotation", spans.PROGRAM + name, s, d,
                   thread=MAIN)

    def launch(corr, t, thread=MAIN):
        return cls("cuda_runtime", "cudaLaunchKernel", t, 1, corr=corr,
                   thread=thread)

    def kernel(corr, s, d, name="k"):
        return cls("kernel", name, s, d, corr=corr)

    def node(s, d, seq):
        return cls("cpu_op", trace.BACKWARD + ": MmBackward0", s, d, seq=seq,
                   thread=BWD, fwd_thread=MAIN)

    return [
        cls("user_annotation", trace.WINDOW, 0, 1100),
        prog("step", 0, 1000),
        cls("gpu_user_annotation", spans.PROGRAM + "step", 0, 1000),
        prog("forward", 10, 390),
        prog("swin", 20, 80),
        cls("cpu_op", "aten::mm", 25, 5, seq=7),
        launch(1, 30),
        prog("fusion", 200, 190),
        prog("fusion.clip", 210, 90),
        cls("cpu_op", "aten::mm", 220, 5, seq=9),
        launch(2, 230),
        prog("backward", 500, 200),
        node(510, 50, 7),
        launch(3, 520, BWD),
        node(600, 50, 9),
        launch(4, 610, BWD),
        node(660, 30, 99),                  # its forward ran in no span
        launch(5, 670, BWD),
        prog("optimizer", 750, 50),
        launch(6, 760),
        launch(7, 900),                     # in step, in no span under it
        launch(8, 1010, OTHER),             # after the step: no span
        kernel(1, 100, 50),
        kernel(2, 250, 100),
        kernel(3, 560, 20),
        kernel(4, 640, 20, "ncclAllReduce"),
        kernel(5, 700, 20),
        kernel(6, 800, 100),
        kernel(7, 950, 10),
        kernel(8, 1050, 10),
        kernel(99, 1070, 10),               # unlaunched: the label before
    ]


@pytest.mark.parametrize("cls", [Ev, OlderEv])
def test_device_operations_go_to_the_innermost_program_span(cls):
    s = spans.reduce(make_events(cls), units=1)
    ns = 1e-9
    labels = s["labels"]
    assert set(labels) == {
        "step/forward/swin", "step/forward/fusion/fusion.clip",
        "step/forward/swin.backward",
        "step/forward/fusion/fusion.clip.backward", "step/backward",
        "step/optimizer", "step"}
    assert labels["step/forward/swin"]["launches"] == 1
    assert abs(labels["step/forward/fusion/fusion.clip"]["device_s"]
               - 100 * ns) < 1e-15
    # NCCL is launched but holds no device seconds of a span
    assert labels["step/forward/fusion/fusion.clip.backward"] == {
        "device_s": 0.0, "launches": 1, "idle_s": 60 * ns}
    assert s["launches"] == 9
    assert abs(s["unattributed_idle_s"] - (90 + 10) * ns) < 1e-15
    assert abs(s["idle_s"] - (100 + 100 + 210 + 60 + 40 + 80 + 50 + 90 + 10)
               * ns) < 1e-15
    assert abs(spans.inclusive(s, "fusion", "device_s") - 100 * ns) < 1e-15
    assert spans.inclusive(s, "fusion", "launches") == 2
    assert spans.inclusive(s, "swin", "launches") == 2
    assert spans.inclusive(s, "step", "launches") == 7
    idle = spans.innermost(s, "idle_s")
    assert abs(idle["backward"] - 40 * ns) < 1e-15
    assert abs(idle["optimizer"] - 80 * ns) < 1e-15
    assert abs(idle["fusion.clip.backward"] - 60 * ns) < 1e-15


def test_host_counts_the_programs_own_units():
    t = spans.tracer()

    def run():
        for _ in range(2):
            with t.span("step"):
                t.count("steps")
                with t.span("fusion"):
                    time.sleep(0.002)

    out = spans.host(run, 2, "step", {"steps": 1})
    assert out["units"] == 2 and out["counters"] == {"steps": 1.0}
    assert out["host_ms"]["fusion"] >= 2.0
    assert out["self_ms"]["step"] < out["host_ms"]["step"]
    assert not t.enabled()
    with pytest.raises(RuntimeError, match="top-level"):
        spans.host(run, 3, "step", {"steps": 1})
    with pytest.raises(RuntimeError, match="counted"):
        spans.host(run, 2, "step", {"steps": 2})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("cells"))


def earlier(spec, readings):
    """Every reading of the metrics BENCHMARK.json had before the program's
    spans, and the profiled sub-window's summary."""
    names = [m["name"] for m in harness.assigned(spec)[1]
             if m["name"] not in NEW["train"] + NEW["request"]]
    return ({n: spec.registry.metric(n).read(readings) for n in names},
            copy.deepcopy(readings["trace"]))


@pytest.mark.parametrize("cell,mode", [("tiny-train", "train"),
                                       ("tiny-request", "request")])
def test_a_traced_run_reads_the_new_metrics_and_keeps_the_rest(root, cell,
                                                               mode):
    spec = harness.make_spec(cell, SEED, 1.0, True, root=root,
                             benchmark=tiny.benchmark(cell))
    cpu = torch.device("cpu")
    outs = harness.run_ranks(spec, cpu, root)
    readings = spec.registry.mode(mode).finish(spec, outs, cpu,
                                               time.time())[1]
    before = earlier(spec, readings)
    got = {n: spec.registry.metric(n).read(readings) for n in NEW[mode]}
    assert earlier(spec, readings) == before
    assert readings["program"]["host"]["units"] == (
        spans.HOST_STEPS if mode == "train" else spans.HOST_REQUESTS)
    for name, value in got.items():
        if name == "fusion_launches.request":
            assert value is None    # no device operations on the CPU
        else:
            assert value > 0, name
    line = harness.run(spec, cpu, time.time(), root=root)
    assert line["correct"]
    assert set(line["metrics"]) >= set(NEW[mode]) - {
        "fusion_launches.request"}


def test_without_the_programs_tracer_the_readers_read_nothing(root,
                                                              monkeypatch):
    monkeypatch.setattr(spans, "tracer", lambda: None)
    spec = harness.make_spec("tiny-train", SEED, 0.5, True, root=root,
                             benchmark=tiny.benchmark("tiny-train"))
    line = harness.run(spec, torch.device("cpu"), time.time(), root=root)
    assert line["correct"]
    assert not set(line["metrics"]) & set(NEW["train"])
    assert "enqueue_ms.train" in line["metrics"]


def test_every_per_layer_source_is_one_the_contract_names():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    assert {m["source"] for m in bench["per_layer"]} <= SOURCES
    assert {m["name"] for m in bench["per_layer"]} >= set(
        NEW["train"] + NEW["request"])
