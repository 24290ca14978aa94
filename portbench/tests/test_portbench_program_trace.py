"""The evaluator's phase readers (``eval.*_ms``) and the program-trace
tool (``program_trace.py``): each reader on a synthetic record, the
idle gaps named by the program's spans on the trace's clock, and the
tiny cells' traced runs, which report the new metrics beside the old
ones, read from the same record."""
from __future__ import annotations

import pytest

from portbench import program_trace as pt
from portbench.harness import HERE, Context, load_cell, read_metrics
from portbench.tests.tiny import run_tiny, tiny_root

PHASES = ("eval.capture_ms", "eval.gate_ms", "eval.timing_ms",
          "eval.unspanned_ms")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("portbench"))


def _span(count, total_s, self_s=None, device_s=None):
    return {"count": count, "total_s": total_s,
            "self_s": total_s if self_s is None else self_s,
            "device_s": device_s}


RECORD = {"repeats": 3, "t_measure_s": 0.005, "spans": {
    "engine.measure": _span(560, 560 * 0.066, self_s=560 * 0.0012),
    "executor.capture": _span(562, 562 * 0.009),
    "executor.release": _span(562, 562 * 0.002),
    "engine.gate": _span(560, 560 * 0.021),
    "engine.timing": _span(560, 560 * 0.0328)}}


def test_phase_readers_on_a_synthetic_record():
    metrics = [{"name": n, "unit": "ms"} for n in PHASES + ("eval.host_ms",)]
    got = {k: v["value"] for k, v in read_metrics(metrics, RECORD).items()}
    assert got == pytest.approx({
        "eval.capture_ms": 9.0, "eval.gate_ms": 21.0,
        "eval.timing_ms": 32.8, "eval.unspanned_ms": 1.2,
        "eval.host_ms": 66.0 - 15.0})


def test_phase_readers_find_nothing_in_the_parents_record():
    """A program without the phase spans, or without self time, gives
    no reading and raises nothing."""
    old = {"repeats": 3, "t_measure_s": 0.005, "spans": {
        "engine.measure": {"count": 560, "total_s": 37.0}}}
    metrics = [{"name": n, "unit": "ms"} for n in PHASES]
    assert read_metrics(metrics, old) == {}
    assert read_metrics(metrics, {}) == {}


def test_program_counter_readers_on_a_synthetic_record():
    rec = {"spans": {"engine.gate": _span(10, 0.2),
                     "train.forward": _span(4, 0.5, device_s=0.36),
                     "train.optimizer": _span(4, 0.6, device_s=0.52)},
           "counters": {"engine.gate_bytes": 10 * 1.2e6,
                        "moe.routed": 2000.0, "moe.dropped": 5.0,
                        "moe.slots": 3000.0}}
    assert pt.gate_mb(rec) == pytest.approx(1.2)
    assert pt.fwd_ms(rec) == pytest.approx(90.0)
    assert pt.drop_pct(rec) == pytest.approx(0.25)
    assert pt.slot_fill_pct(rec) == pytest.approx(66.5)
    for reader in (pt.gate_mb, pt.fwd_ms, pt.drop_pct, pt.slot_fill_pct):
        assert reader({}) is None
    host_only = {"spans": {"train.forward": _span(4, 0.5),
                           "train.optimizer": _span(4, 0.6)}}
    assert pt.fwd_ms(host_only) is None


def _kernel(ts, dur):
    return {"cat": "kernel", "name": "k", "ts": ts, "dur": dur, "ph": "X"}


def test_idle_gaps_are_named_by_the_innermost_span_at_their_start():
    """Three gaps on a synthetic trace: one inside a gate's copy span
    nested in the measure, one in the measure alone, one outside every
    span. The registry's clock sits 1,000 µs after the trace's base."""
    from repro_torch import obs

    tel = obs.Telemetry()
    tel.epoch_us = 1_000.0
    base_ns = 0

    def pair(sid, parent, name, b, e):
        return [{"name": name, "ph": "B", "ts": b - 1_000.0,
                 "span_id": sid, "parent_id": parent, "args": {}},
                {"name": name, "ph": "E", "ts": e - 1_000.0,
                 "span_id": sid, "parent_id": parent, "args": {}}]

    reg = (pair(1, None, "engine.measure", 0.0, 350.0)[:1] +
           pair(2, 1, "engine.gate", 100.0, 200.0) +
           pair(1, None, "engine.measure", 0.0, 350.0)[1:])
    events = [_kernel(50, 40), _kernel(110, 10), _kernel(300, 10),
              _kernel(400, 10), _kernel(900, 10)]
    spans = pt.span_intervals(reg, tel, base_ns)
    assert [(s["name"], s["depth"]) for s in spans] == [
        ("engine.measure", 0), ("engine.gate", 1)]
    got = pt.idle_spans(events, spans)
    # Gaps: 90-110 (measure), 120-300 (gate), 310-400 (measure),
    # 410-900 (no span).
    assert dict(got["idle_spans"]) == pytest.approx({
        "no span": 490e-6, "engine.gate": 180e-6,
        "engine.measure": 110e-6})
    assert got["named_s"] == pytest.approx(780e-6)


def test_capture_spans_enclose_their_instantiation():
    spans = [{"name": "executor.capture", "b": 100.0, "e": 900.0},
             {"name": "executor.capture", "b": 1_000.0, "e": 1_050.0}]
    events = [{"name": pt.INSTANTIATE, "ts": 400.0, "dur": 100.0},
              {"name": pt.INSTANTIATE, "ts": 1_040.0, "dur": 30.0}]
    got = pt.capture_encloses(events, spans)
    assert got == {"captures": 2, "calls": 2, "enclosed": 1,
                   "begin_margin_us": 40.0, "end_margin_us": -20.0}


def test_traced_search_reports_the_phases_beside_the_old_metrics(root):
    line = run_tiny(root, "spmv-paper.search-graph", seconds=0.5,
                    trace=True)
    assert line["correct"] is True, line.get("error")
    cell = load_cell("spmv-paper.search-graph", root)
    assert set(line["metrics"]) >= set(PHASES) | {"eval.host_ms",
                                                  "rules.distill_s"}
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["eval.unspanned_ms"] < m["eval.capture_ms"] + \
        m["eval.gate_ms"] + m["eval.timing_ms"]
    assert {x["name"] for x in cell.per_layer} >= set(PHASES)
    for name in PHASES:
        assert (HERE / "metrics" / f"{name}.py").is_file()


@pytest.mark.parametrize("workload", ["spmv-paper.search-graph",
                                      "deepseek-moe-16b.train-4k"])
def test_program_trace_runs_each_tiny_cell(root, workload):
    import torch

    torch.set_num_threads(2)
    cell = load_cell(workload, root)
    got = pt.run(Context(cell, 7, 1.0, True, device="cpu", root=root),
                 pairs=1)
    stretch = got["stretch"]
    assert stretch["idle_spans"] == [] == stretch["idle_gaps"]
    if workload.startswith("spmv"):
        assert [s["traced"] for s in got["sweeps"]] == [False, True]
        assert all(s["designs"] == 280 for s in got["sweeps"])
        ph = got["sweeps"][1]["phases"]
        assert ph["measure"] == pytest.approx(
            ph["capture"] + ph["release"] + ph["gate"] + ph["timing"] +
            ph["unspanned"], rel=0.02)
        assert got["sweeps"][1]["gate_mb"] > 0
        assert stretch["capture"]["captures"] == stretch["designs"]
    else:
        assert [b["traced"] for b in got["blocks"]] == \
            [False, True, True, False]
        traced = got["blocks"][1]
        assert 0.0 <= traced["drop_pct"] < 100.0
        assert 0.0 < traced["slot_fill_pct"] <= 100.0
        assert traced["fwd_ms"] is None      # no device on the CPU
