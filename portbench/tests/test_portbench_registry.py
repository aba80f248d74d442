"""BENCHMARK.json against the benchmark's files: every cell, configuration,
traffic mix and metric is a file found by its name, names and units keep to
their characters, and a new cell is picked up from a file of its own."""

import json
import shutil

import pytest

from portbench import harness
from portbench.registry import ROOT, Registry, check_name, check_unit

BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def test_every_entry_resolves_to_its_file():
    reg = Registry()
    for c in BENCH["configs"]:
        cfg = reg.config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["reduced"] == cfg["reduced"]
        assert c["source"] == cfg["source"]
        assert callable(reg.counts(c["name"]).pieces)
    for w in BENCH["workloads"]:
        cell = reg.workload(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) \
            == (w["config"], w["traffic"], w["chips"], w["why"])
        reg.traffic(cell["traffic"])
        reg.mode(cell["mode"])
    for m in BENCH["per_layer"]:
        mod = reg.metric(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"],
                                                   m["moves"])
        e2e = {e["name"]: e for e in BENCH["end_to_end"]}
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer():
    for w in BENCH["workloads"]:
        spec = harness.make_spec(w["name"], 1, 1.0, False)
        e2e, per = harness.assigned(spec)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert per


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        check_name(e["name"])
        check_unit(e["unit"])
        assert e["better"] in ("lower", "higher")
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(names) // 4)


@pytest.mark.parametrize("bad", ["", ".x", "-x", "a b", "a/b", "a,b",
                                 "x" * 65, "µs"])
def test_names_outside_the_characters_are_refused(bad):
    with pytest.raises(ValueError):
        check_name(bad)


@pytest.mark.parametrize("bad", ["", "tokens per s", "x" * 17, "µs"])
def test_units_outside_the_characters_are_refused(bad):
    with pytest.raises(ValueError):
        check_unit(bad)


def test_a_new_cell_file_is_picked_up_without_editing_a_file(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cell = dict(json.loads((root / "workloads" / "msvd-train.json")
                           .read_text()), name="msvd-train-b20",
                traffic="steps-20q")
    (root / "workloads" / "msvd-train-b20.json").write_text(json.dumps(cell))
    reg = Registry(root)
    assert "msvd-train-b20" in reg.names("workloads")
    assert reg.workload("msvd-train-b20")["traffic"] == "steps-20q"
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_file_that_names_another_cell_is_refused(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(ROOT / "workloads", root / "workloads")
    (root / "workloads" / "copy.json").write_text(
        (root / "workloads" / "msvd-train.json").read_text())
    with pytest.raises(ValueError):
        Registry(root).workload("copy")
