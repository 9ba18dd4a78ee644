"""The import guard: nothing the benchmark runs may load JAX or the JAX
package, and the reference loads nothing of the program."""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import types

import run
from conftest import BENCH, ROOT
from yardstick import guard


def test_names_are_compared_whole():
    assert guard.forbidden_loaded(["jax.numpy", "numpy", "isee3_decoder_tpu_torch.ops"]) == ["jax"]
    assert guard.forbidden_loaded(["isee3_decoder_tpu.models", "flax", "jaxlib.xla"]) == [
        "flax", "isee3_decoder_tpu", "jaxlib"]
    assert guard.forbidden_loaded(["isee3_decoder_tpu_torch", "jaxtyping"]) == []


def test_benchmark_sources_import_nothing_forbidden():
    for path in pathlib.Path(BENCH).rglob("*.py"):
        names = guard.imported_names(path)
        assert not names & guard.FORBIDDEN, path
        if "reference" in path.parts:
            assert guard.PORT not in names and "yardstick" not in names, path


def test_reference_runs_without_the_program(tmp_path):
    code = (
        "import sys, torch, numpy as np\n"
        f"sys.path.insert(0, {BENCH!r})\n"
        "from reference import chain\n"
        "raw = torch.zeros((1, 2 * 65536 * 2), dtype=torch.int16)\n"
        "cfg = dict(samprate=250000.0, binsize=4.0, search_width=200.0,\n"
        "           cn0_threshold=21.0, symrate=1024.0, symbolclocks=1, window=1.0)\n"
        "from reference.pm import pm_demod\n"
        "from reference.symbols import symdemod\n"
        "symdemod(pm_demod(raw, cfg), cfg)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('isee3_decoder_tpu_torch', 'isee3_decoder_tpu', 'jax', 'yardstick'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(run.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(run.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"correct": True, "checks": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "isee3_512bps.clean", "--seed", "1", "--seconds", "1"])
    captured = capsys.readouterr()
    assert rc != 0 and "{" not in captured.out and "jax" in captured.err


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(run.torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "isee3_512bps.clean", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and "{" not in capsys.readouterr().out


def test_the_benchmark_alone_does_not_run(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    has no program to measure: the run fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "isee3_512bps.clean", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] == ["benchmark"]
