"""BENCHMARK.json against the benchmark's contract, and the harness's
discovery of cells, configurations and metrics by the files alone."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench.harness import HERE, ROOT, load_cell, read_metrics
from portbench.tests.tiny import run_tiny, tiny_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert (ROOT / BENCH["command"][1]).is_file()


def test_run_seconds_fits_the_full_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads"):
        got = [x["name"] for x in BENCH[group]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(CELLS) // 4)


def test_configs_lie_under_paths_and_state_their_cuts():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size")), key
            assert key in cfg


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    c = load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])
    for m in c.end_to_end + c.per_layer:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    assert (HERE / "drivers" / f"{c.traffic['driver']}.py").is_file()


def test_every_config_is_used_and_every_share_is_named_so():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["name"].endswith("_roofline") or "mfu" in m["name"]


def test_a_new_cell_config_and_metric_are_found_from_files_alone(tmp_path):
    """Additions of a new cell: a configuration file, a traffic file and
    a metric reader, each new, and entries in BENCHMARK.json; no file of
    the harness is edited."""
    root = tiny_root(tmp_path)
    folder = root / HERE.name
    before = {p: p.read_bytes() for p in folder.rglob("*.py")}
    (folder / "configs" / "spmv-wide.json").write_text(json.dumps(
        {"name": "spmv-wide", "n": 2048, "nnz": 16384,
         "half_bandwidth": 512, "ranks": 4, "streams": 2,
         "reduced": []}))
    (folder / "traffic" / "search-short.json").write_text(json.dumps(
        {"driver": "search_graph", "t_measure_s": 0.0002, "repeats": 2,
         "warmup": 1, "replays": 10, "checked_designs": 2,
         "trace_designs": 2, "trace_replays": 2, "y_gap_limit": 1e-5}))
    (folder / "metrics" / "designs_seen.py").write_text(
        "def read(record):\n    return record.get('designs')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "spmv-wide", "source": "test",
                             "file": "portbench/configs/spmv-wide.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "spmv-wide.search-short",
                               "config": "spmv-wide",
                               "traffic": "search-short", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "candidates_per_s":
            m["workloads"].append("spmv-wide.search-short")
    bench["per_layer"].append({"name": "designs_seen", "unit": "designs",
                               "better": "higher", "source": "host_clock",
                               "layer": "evaluator",
                               "moves": "candidates_per_s",
                               "workloads": ["spmv-wide.search-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("spmv-wide.search-short", root)
    assert cell.config["n"] == 2048 and cell.traffic["replays"] == 10
    assert [m["name"] for m in cell.per_layer] == ["designs_seen"]
    assert read_metrics(cell.per_layer, {"designs": 560}, cell.folder) == \
        {"designs_seen": {"value": 560.0, "unit": "designs"}}
    assert {p: p.read_bytes() for p in folder.rglob("*.py")
            if p in before} == before
    assert not Path(folder / "metrics" / "designs_seen.py") in before
    line = run_tiny(root, "spmv-wide.search-short", seconds=0.3)
    assert line["correct"] is True, line.get("error")
    assert set(line["metrics"]) == {"candidates_per_s", "setup_s"}
    traced = run_tiny(root, "spmv-wide.search-short", seconds=0.3,
                      trace=True)
    assert traced["metrics"]["designs_seen"]["value"] >= 560
