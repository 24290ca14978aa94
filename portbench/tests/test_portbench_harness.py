"""The harness's result line, its refusals, and the modules it loads."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from portbench.harness import (HERE, ROOT, FORBIDDEN, Cell, Outcome,
                               forbidden_modules, load_cell, result_line)
from portbench.tests.tiny import tiny_root

RUN = [sys.executable, "portbench/run.py", "--workload",
       "spmv-paper.search-graph", "--seed", "1", "--seconds", "1",
       "--trace", "0"]


def test_forbidden_names_are_compared_whole():
    loaded = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1,
              "repro": 1, "repro.core.dag": 1, "benchmarks.run": 1,
              "repro_torch": 1, "repro_torch.core": 1, "jaxtyping": 1,
              "reprolib": 1, "benchmarks_extra": 1, "torch": 1}
    assert forbidden_modules(loaded) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla", "flax", "repro",
         "repro.core.dag", "benchmarks.run"])
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "repro",
                              "benchmarks"}


def test_the_harness_and_its_references_load_no_jax_nor_the_jax_package():
    """Every module of the harness, its drivers, readers and references,
    and the program's modules they import, in a fresh interpreter."""
    code = f"""
import sys, json
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
from pathlib import Path
from portbench import harness, control, gpu, inputs
from portbench.reference import moe_lm, spmv
here = Path(harness.HERE)
for sub in ("drivers", "metrics"):
    for p in sorted((here / sub).glob("*.py")):
        harness.load_module(p, "m_" + p.stem.replace(".", "_"))
import repro_torch.search, repro_torch.rules, repro_torch.engine.wallclock
import repro_torch.spmv.distributed, repro_torch.train.step
import repro_torch.models.model, repro_torch.optim.adamw
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_result_line_keys_and_checks_last():
    cell = Cell("c", 1, {}, {}, ({"name": "setup_s", "unit": "s"},),
                ({"name": "step_us", "unit": "us"},))
    out = Outcome(attempted=3, checks={"y_gap": (1e-7, 1e-5)},
                  record={"setup_s": 2.5, "steps": 4, "steps_s": 1e-4},
                  device={"platform": "gpu", "kind": "k", "count": 1,
                          "memory_peak_bytes": 5})
    line = result_line(cell, out, trace=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"] == {"setup_s": {"value": 2.5, "unit": "s"}}
    assert line["checks"] == {"y_gap": {"value": 1e-7, "limit": 1e-5}}
    traced = result_line(cell, Outcome(attempted=1, checks=out.checks,
                                       record=out.record,
                                       breakdown={"device_ops": [],
                                                  "idle_gaps": []}),
                         trace=True)
    assert traced["metrics"] == {"step_us": {"value": 25.0, "unit": "us"}}
    assert list(traced)[-2:] == ["breakdown", "checks"]


@pytest.mark.parametrize("checks,failed,error,correct", [
    ({"y_gap": (1e-7, 1e-5)}, 0, None, True),
    ({"y_gap": (1e-3, 1e-5)}, 0, None, False),
    ({"y_gap": (float("nan"), 1e-5)}, 0, None, False),
    ({"y_gap": (1e-7, 1e-5)}, 1, None, False),
    ({"y_gap": (1e-7, 1e-5)}, 0, "boom", False),
    ({}, 0, None, False)])
def test_correct_needs_every_check_within_its_limit(checks, failed, error,
                                                    correct):
    out = Outcome(attempted=1, failed=failed, checks=checks, error=error)
    assert out.correct() is correct


def test_without_a_card_the_run_prints_no_result():
    """This machine has no card: the run must refuse, not fall back."""
    out = subprocess.run(RUN, capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_without_the_program_the_run_prints_no_result(tmp_path):
    """A checkout of BENCHMARK.json and the harness folder alone."""
    shutil.copytree(HERE, tmp_path / HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(RUN, capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "repro_torch" in out.stderr


def test_cells_read_from_the_repository(tmp_path):
    cell = load_cell("spmv-paper.search-graph")
    assert cell.chips == 1 and cell.config["n"] == 150_000
    assert cell.traffic["driver"] == "search_graph"
    rank = load_cell("spmv-paper.rank4-nccl", tiny_root(tmp_path))
    assert rank.chips == 4 == rank.traffic["ranks"]
    assert [m["name"] for m in rank.end_to_end] == ["step_us", "setup_s"]
    assert len(rank.per_layer) == 3
