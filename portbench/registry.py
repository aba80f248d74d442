"""Finding what a run needs by name: every cell, configuration, traffic
mix, count and per-layer metric is a file of its own under the benchmark's
folder, so that a later change adds files and edits none.

    workloads/<cell>.json      config, traffic, chips, ranks, mode, limits
    configs/<config>.json      the model's sizes, source, reduced, assumed
    traffic/<traffic>.json     the input generator's parameters
    counts/<config>.py         ``pieces(config, questions, train)``
    metrics/<metric>.py        ``UNIT``, ``LAYER``, ``MOVES``, ``read(r)``
    modes/<mode>.py            ``run_rank`` and ``finish`` of a kind of cell
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELL_KEYS = {"name", "config", "traffic", "chips", "ranks", "mode", "limits",
             "why"}


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r} (letters, digits, _ . -; "
                         "at most 64, not starting with . or -)")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise ValueError(f"not a unit: {unit!r}")
    return unit


class Registry:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self._modules: Dict[Path, ModuleType] = {}

    def _json(self, kind: str, name: str) -> dict:
        path = self.root / kind / f"{check_name(name)}.json"
        if not path.is_file():
            raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
        with open(path) as f:
            data = json.load(f)
        if data.get("name", name) != name:
            raise ValueError(f"{path} names itself {data['name']!r}")
        return data

    def _module(self, kind: str, name: str) -> ModuleType:
        path = self.root / kind / f"{check_name(name)}.py"
        if path not in self._modules:
            if not path.is_file():
                raise KeyError(f"no {kind} file named {name!r} ({path})")
            spec = importlib.util.spec_from_file_location(
                f"portbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}",
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return self._modules[path]

    def workload(self, name: str) -> dict:
        cell = self._json("workloads", name)
        missing = CELL_KEYS - set(cell)
        if missing:
            raise ValueError(f"cell {name!r} lacks {sorted(missing)}")
        for key in ("config", "traffic", "mode"):
            check_name(cell[key])
        if cell["chips"] not in (1, 4) or cell["ranks"] > cell["chips"]:
            raise ValueError(f"cell {name!r}: chips {cell['chips']}, ranks "
                             f"{cell['ranks']}")
        return cell

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def counts(self, config: str) -> ModuleType:
        return self._module("counts", config)

    def metric(self, name: str) -> ModuleType:
        mod = self._module("metrics", name)
        check_unit(mod.UNIT)
        check_name(mod.MOVES)
        if not (1 <= len(mod.LAYER) <= 200) or "\n" in mod.LAYER:
            raise ValueError(f"metric {name!r}: bad LAYER")
        return mod

    def mode(self, name: str) -> ModuleType:
        return self._module("modes", name)

    def names(self, kind: str):
        suffix = ".py" if kind in ("metrics", "counts", "modes") else ".json"
        return sorted(p.name[:-len(suffix)]
                      for p in (self.root / kind).glob("*" + suffix)
                      if not p.name.startswith("_"))
