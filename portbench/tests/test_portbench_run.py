"""Whole runs of tiny cells on the CPU, with the look for a chip skipped:
sound runs are correct, the control (the reference with float8 operands in
the program's place) is not, and neither is a run whose timed path has one
of the faults its cell can have. Two ranks over gloo run the multi-rank
path."""

import json
import time

import pytest
import torch

from portbench import check, harness, program, run
from portbench.reference import lrce as R
from portbench.tests import tiny

SEED = 2**33 + 17

# The train mode with the JAX package planted in rank 1's process once its
# window has closed: the program runs in the ranks, not in the process that
# prints.
PLANTED = """
import sys
import types

from portbench.modes.train import finish, run_rank as _run_rank


def run_rank(spec, device, rank, world):
    out = _run_rank(spec, device, rank, world)
    if rank == 1:
        sys.modules["lrce_tpu"] = types.ModuleType("lrce_tpu")
    return out
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("cells"))


def one_run(root, cell, fault=None, trace=False, seconds=1.0):
    spec = harness.make_spec(cell, SEED, seconds, trace, root=root,
                             benchmark=tiny.benchmark(cell), fault=fault)
    return spec, harness.run(spec, torch.device("cpu"), time.time(),
                             root=root)


def shapes_of(spec):
    net = program.model(spec.config, torch.device("cpu"))
    return [(k, tuple(v.shape)) for k, v in net.named_parameters()]


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-request"])
def test_a_sound_run_is_correct_and_its_line_is_whole(root, cell):
    _, line = one_run(root, cell, trace=True)
    assert line["correct"], line["checks"]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes", "busy_s", "window_s"}


def test_two_ranks_over_gloo_are_correct(root):
    _, line = one_run(root, "tiny-train-2r")
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 2
    assert set(line["metrics"]) >= {"clips_per_s", "setup_s"}


def test_a_forbidden_module_in_a_rank_prints_no_result(root):
    name = "tiny-train-2r-planted"
    (root / "modes" / "planted.py").write_text(PLANTED)
    cell = dict(tiny.cells()["tiny-train-2r"], name=name, mode="planted")
    (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    with pytest.raises(SystemExit, match=r"lrce_tpu.* in rank 1"):
        one_run(root, name)


@pytest.mark.parametrize("group,key,value", [
    ("train", "compute_dtype", "bfloat16"),
    ("train", "param_dtype", "bfloat16"),
    ("fusion", "num_layers", 6),
])
def test_a_model_unlike_its_configuration_is_refused(group, key, value):
    config = dict(tiny.CONFIG, **{group: {**tiny.CONFIG[group], key: value}})
    with pytest.raises(ValueError, match=f"{group}"):
        program.model(config, torch.device("cpu"))


@pytest.mark.parametrize("key,value", [
    ("optimizer", "adam"), ("weight_decay", 0.0), ("eps", 1e-6),
    ("betas", [0.9, 0.98]),
])
def test_an_optimizer_unlike_its_configuration_is_refused(key, value):
    net = program.model(tiny.CONFIG, torch.device("cpu"))
    config = dict(tiny.CONFIG, train={**tiny.CONFIG["train"], key: value})
    with pytest.raises(ValueError, match=f"train.{key}"):
        program.agent(net, config, 1)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-train", "state_unchanged"),
    ("tiny-train", "half_batch"),
    ("tiny-train-2r", "no_exchange"),
    ("tiny-request", "answer_altered"),
])
def test_a_planted_fault_is_not_correct(root, cell, fault):
    _, line = one_run(root, cell, fault=fault)
    assert not line["correct"], line["checks"]


def test_the_control_is_not_correct(root):
    spec = harness.make_spec("tiny-train", SEED, 1.0, False, root=root,
                             benchmark=tiny.benchmark("tiny-train"))
    mode = spec.registry.mode("train")
    shapes = shapes_of(spec)
    ref = mode.reference_steps(spec, shapes, torch.device("cpu"),
                               R.Numerics())
    fp8 = mode.reference_steps(spec, shapes, torch.device("cpu"),
                               R.Numerics(fp8=True))
    numbers = check.training_numbers(
        {"losses": fp8.losses, "logits": fp8.logits,
         "grad_norms": [fp8.grad_norms], "change_norms": [fp8.change_norms]},
        ref)
    assert not check.passed(check.judge(numbers, spec.cell["limits"]))


def test_the_request_control_is_not_correct(root):
    spec = harness.make_spec("tiny-request", SEED, 1.0, False, root=root,
                             benchmark=tiny.benchmark("tiny-request"))
    mode = spec.registry.mode("request")
    shapes = shapes_of(spec)
    cpu = torch.device("cpu")
    ref = mode.reference_logits(spec, shapes, cpu, 6, R.Numerics())
    fp8 = mode.reference_logits(spec, shapes, cpu, 6, R.Numerics(fp8=True))
    gap = max(check.rel_l2(a, r) for a, r in zip(fp8, ref))
    assert gap > spec.cell["limits"]["logits_gap"]


def test_without_the_cards_a_run_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "msvd-train", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err
