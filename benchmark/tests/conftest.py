"""Tests of the benchmark harness.  Run here on the CPU:

    python -m pytest benchmark/tests -q -p no:cacheprovider

and the ones that need the card, on a machine with one:

    python -m pytest benchmark/tests -q -m cuda -p no:cacheprovider
"""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run on the card")
    return torch.device("cuda")


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of BENCHMARK.json and the benchmark's data files, with a
    cell added by files alone: make(name, base_cell, **overrides)
    writes benchmark/cells/<name>.json from the base cell's file with
    the overrides and adds the workload entry; returns the root."""

    def make(name: str, base: str, **overrides):
        bench = tmp_path / "benchmark"
        if not bench.exists():
            shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
            for d in ("configs", "cells", "layers", "metrics"):
                shutil.copytree(os.path.join(BENCH, d), bench / d)
        data = json.loads((tmp_path / "BENCHMARK.json").read_text())
        work = dict(next(w for w in data["workloads"] if w["name"] == base))
        work.update(name=name, traffic=name.split(".", 1)[1])
        data["workloads"].append(work)
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
        cell = json.loads((bench / "cells" / f"{base}.json").read_text())
        cell.update(overrides)
        (bench / "cells" / f"{name}.json").write_text(json.dumps(cell))
        return tmp_path

    return make
