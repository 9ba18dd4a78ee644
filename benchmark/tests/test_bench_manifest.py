"""BENCHMARK.json against the benchmark's contract, and the files it
names."""

import json
import os
import re

import pytest
import torch

from yardstick.manifest import Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def m():
    return Manifest()


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_units(m):
    d = m.data
    assert set(d) == KEYS["top"]
    assert os.path.getsize(m.root / "BENCHMARK.json") <= 64 * 1024
    assert 1 <= len(d["paths"]) <= 16 and all(PATH.match(p) for p in d["paths"])
    assert len(d["command"]) <= 32 and all(_line(w) for w in d["command"])
    for c in d["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"])
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/")
    for w in d["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
    names = []
    for kind in ("end_to_end", "per_layer"):
        for x in d[kind]:
            assert set(x) - {"workloads"} == KEYS[kind]
            assert NAME.match(x["name"]) and UNIT.match(x["unit"])
            assert x["better"] in ("lower", "higher")
            names.append(x["name"])
    for group in (names, [c["name"] for c in d["configs"]],
                  [w["name"] for w in d["workloads"]]):
        assert len(group) == len(set(group))
    pairs = [(w["config"], w["traffic"]) for w in d["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_run_length(m):
    d = m.data
    assert 1 <= d["run_seconds"] <= 51
    # a full check of 24 cells fits into the driver's 43200 s
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) / (d["run_seconds"] + 60)
    for x in d["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {x["name"] for x in d["end_to_end"]}


def test_every_metric_reported_where_it_says(m):
    d = m.data
    cells = set(m.workloads)
    layer_names = {layer["name"] for layer in m.layers().values()}
    for x in d["per_layer"]:
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(x.get("workloads", cells)) <= cells
        assert x["layer"] in layer_names
        assert callable(m.reader(x["name"]))
        for cell in x.get("workloads", cells):
            assert x["moves"] in {e["name"] for e in m.end_to_end(cell)}
    for cell in cells:
        e2e = {e["name"] for e in m.end_to_end(cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert m.per_layer(cell)


def test_configs_cells_and_files(m):
    used = {w["config"] for w in m.data["workloads"]}
    assert used == set(m.configs)
    files = [c["file"] for c in m.data["configs"]]
    assert len(files) == len(set(files))
    for name, work in m.workloads.items():
        cfg = m.config(work["config"])
        cell = m.cell(name)
        assert _line(cell["why"])
        assert "lanes_differ_pct" in cell["limits"]
        assert set(cell["limits"]) <= {"lanes_differ_pct", "viterbi_lanes_differ_pct",
                                       "soft_differ_pct"}
        for key in ("samprate", "binsize", "search_width", "cn0_threshold", "pm_dtype",
                    "pm_backend", "symrate", "symbolclocks", "window", "mod_index", "decode"):
            assert key in cfg, (name, key)
        assert getattr(torch, cfg["pm_dtype"]) == torch.float32


def test_a_cell_is_added_by_files_only(tiny_root):
    root = tiny_root("isee3_512bps.added", "isee3_512bps.clean", channels=4)
    m = Manifest(root)
    assert m.cell("isee3_512bps.added")["channels"] == 4
    assert m.config(m.workload("isee3_512bps.added")["config"])["symrate"] == 1024.0
    assert {x["name"] for x in m.per_layer("isee3_512bps.added")} == {
        x["name"] for x in m.data["per_layer"] if "workloads" not in x}
    assert json.loads((root / "BENCHMARK.json").read_text())["workloads"][-1]["name"] \
        == "isee3_512bps.added"
