"""BENCHMARK.json and the files it names, found by name.

- a configuration: ``benchmark/configs/<name>.json`` (its ``file``);
- a cell's traffic parameters, ``why`` and correctness limits:
  ``benchmark/cells/<cell name>.json``;
- a layer: ``benchmark/layers/<key>.json`` with its ``name`` (as
  BENCHMARK.json's ``layer`` says it) and its entry functions;
- a per-layer metric's reader: ``benchmark/metrics/<metric name>.py``,
  whose ``read(summary)`` returns the value or None.

A later cell, configuration, layer or metric is new files and new
entries; nothing here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Manifest:
    def __init__(self, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)
        self.bench = self.root / "benchmark"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.workloads = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def workload(self, name: str) -> dict:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return self.workloads[name]

    def config(self, name: str) -> dict:
        return json.loads((self.root / self.configs[name]["file"]).read_text())

    def cell(self, name: str) -> dict:
        return json.loads((self.bench / "cells" / f"{name}.json").read_text())

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell])]

    def layers(self) -> dict[str, dict]:
        """layer key (file stem) → {"name", "entries": ["module:function"]}."""
        return {p.stem: json.loads(p.read_text())
                for p in sorted((self.bench / "layers").glob("*.json"))}

    def reader(self, metric: str):
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
