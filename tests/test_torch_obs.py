"""Telemetry (``obs/``) against the JAX package's (tests/test_obs.py
mirrored): spans, counters and gauges give the reference's event stream;
the disabled default is no-op singletons; a span closed by an exception
still counts; the Perfetto trace is schema-sane; and a search is
byte-identical with telemetry on and off, on every analytic backend,
with the reference's per-round digests. The evaluators' spans
(``engine.*``, ``store.*``, ``kernel.*``) run here on the CPU."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.search as RS  # noqa: E402
from repro import obs as r_obs  # noqa: E402
import repro_torch.core as TC  # noqa: E402
import repro_torch.engine as TE  # noqa: E402
import repro_torch.search as TS  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.driver import (SINKS, SearchDriver, TelemetrySink,  # noqa: E402,E501
                                make_sink)
from repro_torch.engine.base import EvalBatch  # noqa: E402
from repro_torch.engine.store import MAGIC, EvalStore  # noqa: E402
from repro_torch.kernels.autotune import spmv_mulsum_space  # noqa: E402
from repro_torch.space.schedule import canonical_key  # noqa: E402

CPU = torch.device("cpu")
T_MACHINE = TC.Machine(**dataclasses.asdict(RC.Machine()))


def instrument(o):
    """The same calls against either package's obs module."""
    with o.span("outer", layer="driver") as sp:
        sp.set(n=3)
        with o.span("inner"):
            pass
        with o.span("inner", k=1):
            pass
    o.counter("hits").add(2)
    o.counter("hits").add(3)
    o.gauge("best").set(1.5)
    o.event("marker", round=0)


def shape(events):
    return [(e["name"], e["ph"], e.get("s"), e["args"]) for e in events]


def test_spans_counters_gauges_match_reference():
    ex, r_ex = obs.MemoryExporter(), r_obs.MemoryExporter()
    tel, r_tel = obs.Telemetry([ex]), r_obs.Telemetry([r_ex])
    with obs.use(tel), r_obs.use(r_tel):
        assert obs.enabled()
        instrument(obs)
        instrument(r_obs)
    assert shape(ex.events) == shape(r_ex.events)
    assert [e["ts"] for e in ex.events] == sorted(e["ts"] for e in ex.events)
    spans = tel.spans_by_name()
    assert {k: v["count"] for k, v in spans.items()} == \
        {k: v["count"] for k, v in r_tel.spans_by_name().items()} == \
        {"outer": 1, "inner": 2}
    assert spans["outer"]["total_s"] >= spans["inner"]["total_s"] >= 0
    assert tel.counters() == r_tel.counters() == {"hits": 5.0}
    assert tel.gauges() == r_tel.gauges() == {"best": 1.5}
    end = [e for e in ex.events if e["ph"] == "E" and e["name"] == "outer"]
    assert end[0]["args"] == {"layer": "driver", "n": 3}
    lines = tel.summary().splitlines()
    assert [ln.split()[0] for ln in lines] == \
        [ln.split()[0] for ln in r_tel.summary().splitlines()]


def test_disabled_default_is_noop_singletons():
    assert obs.current() is obs.DISABLED and not obs.enabled()
    sp = obs.span("anything", n=1)
    with sp as inner:
        inner.set(x=2)
    assert obs.span("other") is sp
    assert obs.counter("c") is obs.counter("d") is obs.gauge("g")
    obs.counter("c").add(5)
    obs.gauge("g").set(3.0)
    obs.event("e", k=1)
    assert obs.DISABLED.spans_by_name() == {}
    assert obs.DISABLED.counters() == {} == obs.DISABLED.gauges()


def test_use_restores_previous_registry():
    tel = obs.Telemetry()
    with obs.use(tel):
        assert obs.current() is tel
        with obs.use(None):
            assert obs.current() is obs.DISABLED
        assert obs.current() is tel
    assert obs.current() is obs.DISABLED


def test_exception_inside_span_still_closes_it():
    ex = obs.MemoryExporter()
    tel = obs.Telemetry([ex])
    with obs.use(tel):
        with pytest.raises(RuntimeError, match="boom"):
            with obs.span("outer"):
                with obs.span("fails"):
                    raise RuntimeError("boom")
        with obs.span("after"):
            pass
    spans = tel.spans_by_name()
    assert spans["fails"]["count"] == spans["outer"]["count"] == 1
    assert [(e["name"], e["ph"]) for e in ex.events] == [
        ("outer", "B"), ("fails", "B"), ("fails", "E"), ("outer", "E"),
        ("after", "B"), ("after", "E")]
    assert tel._stack() == []


@pytest.mark.parametrize("backend,kwargs", [
    ("sim", None), ("vectorized", None),
    ("pool", {"n_workers": 2, "min_shard": 1})])
def test_run_search_byte_identical_with_telemetry(backend, kwargs):
    """Telemetry on or off, the port's search is the same, and both are
    the reference's; the round digests account for every proposal and
    miss, and equal the reference's but for the host seconds."""
    tg, rg = TC.spmv_dag(), RC.spmv_dag()

    def search():
        return TS.run_search(tg, TS.MCTSSearch(tg, 2, seed=0), budget=40,
                             batch_size=8, backend=backend,
                             backend_kwargs=kwargs, machine=T_MACHINE)

    plain = search()
    tel = obs.Telemetry(exporters=[obs.MemoryExporter()])
    with obs.use(tel):
        traced = search()
    r_tel = r_obs.Telemetry()
    with r_obs.use(r_tel):
        ref = RS.run_search(rg, RS.MCTSSearch(rg, 2, seed=0), budget=40,
                            batch_size=8, backend="sim")
    for res in (traced, ref):
        assert res.times == plain.times
        assert [canonical_key(s) for s in res.schedules] == \
            [canonical_key(s) for s in plain.schedules]
        assert (res.n_proposed, res.cache_hits, res.cache_misses) == \
            (plain.n_proposed, plain.cache_hits, plain.cache_misses)
    assert plain.telemetry is None and len(traced.telemetry) == 5

    def digest(rounds):
        return [{k: v for k, v in r.items() if k != "evaluate_s"}
                for r in rounds]

    assert digest(traced.telemetry) == digest(ref.telemetry)
    assert all(r["evaluate_s"] >= 0.0 for r in traced.telemetry)
    spans = tel.spans_by_name()
    assert spans["driver.run"]["count"] == 1
    assert spans["driver.round"]["count"] == 5
    assert {k: v["count"] for k, v in spans.items()} == \
        {k: v["count"] for k, v in r_tel.spans_by_name().items()}
    assert sum(r["n"] for r in traced.telemetry) == traced.n_proposed
    assert sum(r["misses"] for r in traced.telemetry) == traced.cache_misses
    assert traced.telemetry[-1]["best"] == traced.best()[1]
    assert tel.counters() == r_tel.counters()
    assert tel.gauges() == r_tel.gauges()


def test_perfetto_trace_schema(tmp_path):
    path = tmp_path / "trace.json"
    tg = TC.spmv_dag()
    tel = obs.Telemetry(exporters=[obs.PerfettoExporter(path),
                                   obs.JsonlExporter(tmp_path / "t.jsonl")])
    with obs.use(tel):
        res = TS.run_search(tg, TS.MCTSSearch(tg, 2, seed=0), budget=40,
                            batch_size=8, backend="vectorized")
    tel.close()
    with open(path) as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    assert events and obs.load_trace(path) == events
    assert obs.load_trace(tmp_path / "t.jsonl") == events
    assert {"driver.run", "driver.round", "driver.propose",
            "driver.evaluate", "driver.observe", "engine.batch",
            "engine.measure"} <= {e["name"] for e in events}
    stacks: dict = {}
    last_ts = -1.0
    for e in events:
        assert {"name", "ph", "ts", "pid"} <= set(e)
        assert e["ts"] >= last_ts
        last_ts = e["ts"]
        if e["ph"] == "B":
            stacks.setdefault(e["tid"], []).append(e["name"])
        elif e["ph"] == "E":
            assert stacks[e["tid"]].pop() == e["name"]
        else:
            assert e["ph"] in ("C", "i")
    assert all(not st for st in stacks.values())
    rounds = [e["args"]["round"] for e in events
              if e["name"] == "driver.round" and e["ph"] == "B"]
    assert rounds == list(range(len(res.telemetry)))


def test_warm_run_measures_nothing_and_store_meters_agree(tmp_path):
    path = str(tmp_path / "eval.store")
    tg = TC.spmv_dag()

    def search(store):
        return TS.run_search(tg, TS.MCTSSearch(tg, 2, seed=0), budget=60,
                             batch_size=8, backend="vectorized", store=store)

    with EvalStore(path) as st:
        cold = search(st)
        cold_stats = st.stats()
    assert cold.cache_misses > 0
    assert cold_stats["records_appended"] == cold.cache_misses
    tel = obs.Telemetry()
    with obs.use(tel), EvalStore(path) as st2:
        warm = search(st2)
        warm_stats = st2.stats()
    assert warm.times == cold.times
    assert warm.cache_misses == 0 and warm.store_hits > 0
    spans = tel.spans_by_name()
    assert spans.get("engine.measure", {}).get("count", 0) == 0
    assert spans["store.open"]["count"] == 1
    assert "store.append" not in spans
    assert warm_stats["lookup_hits"] == warm.store_hits
    assert warm_stats["records_loaded"] == cold.cache_misses
    assert warm_stats["bytes_read"] == \
        cold_stats["bytes_appended"] + len(MAGIC)


def test_store_open_reports_a_truncated_tail(tmp_path):
    path = tmp_path / "eval.store"
    with EvalStore(path) as st:
        st.put_many(b"f" * 16, [(b"k1", 1.0)])
    with open(path, "ab") as f:
        f.write(b"\x01garbage-partial-record")
    ex = obs.MemoryExporter()
    tel = obs.Telemetry(exporters=[ex])
    with obs.use(tel):
        with EvalStore(path) as st2:
            assert len(st2) == 1
            st2.put_many(b"f" * 16, [(b"k2", 2.0)])
    assert tel.counters()["store.truncated_tails"] == 1.0
    assert tel.spans_by_name()["store.append"]["count"] == 1
    trunc = [e for e in ex.events
             if e["name"] == "store.truncated_tail" and e["ph"] == "i"]
    assert len(trunc) == 1 and trunc[0]["args"]["bytes"] > 0


def test_kernel_evaluator_spans_on_the_cpu():
    """The kernel autotune's build and timing phases are spans, the gate
    checks a counter; inside engine.measure, inside engine.batch."""
    sp = spmv_mulsum_space(n=128, k=4, block_values=(32, 64), device=CPU)
    ev = TE.make_evaluator(sp, "wallclock", repeats=2, device=CPU)
    ex = obs.MemoryExporter()
    tel = obs.Telemetry([ex])
    cands = list(sp.enumerate_candidates())
    with obs.use(tel):
        ev.evaluate(cands)
        ev.evaluate(cands)
    spans = tel.spans_by_name()
    assert {k: v["count"] for k, v in spans.items()} == {
        "engine.batch": 2, "engine.measure": 1, "kernel.compile": 1,
        "kernel.timing": 1}
    assert tel.counters() == {"kernel.gate_checks": 2.0}
    names = [(e["name"], e["ph"]) for e in ex.events if e["ph"] in "BE"]
    assert names[:4] == [("engine.batch", "B"), ("engine.measure", "B"),
                         ("kernel.compile", "B"), ("kernel.compile", "E")]
    batch_ends = [e["args"] for e in ex.events
                  if e["name"] == "engine.batch" and e["ph"] == "E"]
    assert [(a["misses"], a["memory_hits"]) for a in batch_ends] == \
        [(2, 0), (0, 2)]


def _fake_batch(keys, times):
    return EvalBatch(schedules=[None] * len(keys), keys=list(keys),
                     times=np.asarray(times, dtype=np.float64))


def test_telemetry_sink_registered_and_emits():
    assert "telemetry" in SINKS
    sink = make_sink("telemetry", TC.spmv_dag())
    assert isinstance(sink, TelemetrySink)
    sink.consume(_fake_batch([b"a"], [1.0]), np.array([True]))
    assert sink.n_rounds == 1
    ex = obs.MemoryExporter()
    tel = obs.Telemetry(exporters=[ex])
    with obs.use(tel):
        sink.consume(_fake_batch([b"b", b"c"], [2.0, 0.5]),
                     np.array([True, False]))
    assert sink.n_rounds == 2
    assert tel.counters() == {"sink.consumed": 2.0, "sink.fresh": 1.0}
    assert tel.gauges() == {"sink.best": 0.5}
    marks = [e for e in ex.events if e["name"] == "sink.round"]
    assert len(marks) == 1 and marks[0]["args"]["round"] == 1


def test_driver_with_telemetry_sink_matches_plain():
    tg = TC.spmv_dag()
    plain = SearchDriver(tg, TS.MCTSSearch(tg, 2, seed=0), budget=30,
                         batch_size=6, backend="sim").run()
    tel = obs.Telemetry()
    with obs.use(tel):
        sunk = SearchDriver(tg, TS.MCTSSearch(tg, 2, seed=0), budget=30,
                            batch_size=6, backend="sim",
                            sinks=["telemetry"]).run()
    assert sunk.times == plain.times
    assert tel.counters()["sink.consumed"] == sunk.n_proposed
    assert tel.gauges()["sink.best"] == sunk.best()[1]


def test_load_trace_reads_the_jsonl_its_exporter_writes(tmp_path):
    """The reference's load_trace parses any text starting with "{" as
    one JSON document, so it cannot read back its own JsonlExporter's
    file of two or more events (kept as found there); the port's reads
    it line by line, and a one-event file too."""
    path = tmp_path / "run.jsonl"
    for o, p in ((obs, path), (r_obs, tmp_path / "ref.jsonl")):
        tel = o.Telemetry([o.JsonlExporter(p)])
        with o.use(tel):
            with o.span("a", n=1):
                pass
        tel.close()
    events = obs.load_trace(path)
    assert [(e["name"], e["ph"], e["args"]) for e in events] == \
        [("a", "B", {"n": 1}), ("a", "E", {"n": 1})]
    with pytest.raises(json.JSONDecodeError):
        r_obs.load_trace(tmp_path / "ref.jsonl")
    one = tmp_path / "one.jsonl"
    one.write_text(json.dumps(events[0]) + "\n")
    assert obs.load_trace(one) == [events[0]]
