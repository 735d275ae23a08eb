"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is the file its entry names; a traffic mix is
``benchmark/traffic/<name>.json``; a per-layer metric's reader is
``benchmark/metrics/<name>.py`` (a function ``read(ctx)``); the plain
reference a mix is judged by is ``benchmark/reference/<name>.py``,
named by the mix's ``reference`` key. A later change adds a cell, a mix, a
metric or a configuration as new files and entries, without editing a
file that is there.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class Spec:
    def __init__(self, root: Path | str = ROOT):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads(
            (self.root / "benchmark" / "traffic" / f"{name}.json").read_text())

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics `cell` reports."""
        return [m for m in self.doc["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics `cell` reports: those that list it."""
        return [m for m in self.doc["per_layer"] if cell in m["workloads"]]

    def reader(self, metric: str):
        return _load(self.root / "benchmark" / "metrics" / f"{metric}.py",
                     f"benchmark_metric_{metric}").read

    def reference(self, name: str):
        return _load(self.root / "benchmark" / "reference" / f"{name}.py",
                     f"benchmark_reference_{name}")


def _load(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
