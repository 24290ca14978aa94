"""The program's own spans and counters in a cell, on the card, beside
the device's trace on one clock: what a driver that ran its window and
its profiled stretch under a telemetry registry would record.

    python3 portbench/program_trace.py --workload spmv-paper.search-graph --seed <n> [--out <file>]
    python3 portbench/program_trace.py --workload deepseek-moe-16b.train-4k --seed <n> --seconds 40

prints one JSON line (and writes it to ``--out``):

- ``spmv-paper.search-graph``: ``pairs`` pairs of whole sweeps of the
  cell's evaluator, in the order off, on, on, off, ... (the same MCTS
  seed each, so the same designs), ``on`` under a registry: each
  sweep's candidates a second; the traced sweeps' phases a design
  (``executor.capture``, ``executor.release``, ``engine.gate``,
  ``engine.timing``, ``engine.measure`` and its self time) and the
  gate's megabytes; then the cell's profiled stretch of
  ``trace_designs`` designs under a registry: its ``idle_gaps`` as the
  benchmark names them, its ``idle_spans`` (the same gaps named by the
  innermost program span open at each one's start, "no span" where
  none is), its phases a design, and how each ``executor.capture``
  span encloses its ``cudaGraphInstantiateWithFlags`` call.
- ``deepseek-moe-16b.train-4k``: steps back to back in four blocks of
  ``seconds / 4``, off, on, on, off: each block's tokens a second; the
  traced steps' device milliseconds of ``train.forward``,
  ``train.backward`` and ``train.optimizer`` beside the
  ``make_train_step`` marks' (what ``model.fwd_bwd_ms`` and
  ``train.opt_ms`` read), the MoE counters' drop and slot-fill shares;
  then two steps profiled under a registry, their ``idle_gaps`` and
  ``idle_spans``.

The shares and means are those that the readers below give, for the
per-layer metrics a driver that records ``counters`` and a traced
registry's spans would report (``eval.gate_mb``, ``model.fwd_ms``,
``moe.drop_pct``, ``moe.slot_fill_pct``). On the CPU (the tests)
nothing is profiled and the idle lists are empty.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import gpu, harness, inputs  # noqa: E402

NO_SPAN = "no span"
INSTANTIATE = "cudaGraphInstantiateWithFlags"


# -- readers over a record of spans and counters ------------------------------

def gate_mb(record: dict):
    """eval.gate_mb: megabytes a design's gate copies to the host
    (``engine.gate_bytes`` over the ``engine.gate`` spans)."""
    gate = (record.get("spans") or {}).get("engine.gate")
    got = (record.get("counters") or {}).get("engine.gate_bytes")
    if not gate or not gate["count"] or got is None:
        return None
    return got / gate["count"] / 1e6


def fwd_ms(record: dict):
    """model.fwd_ms: device milliseconds of a step's forward
    (``train.forward`` over the steps, ``train.optimizer`` spans)."""
    spans = record.get("spans") or {}
    fwd, opt = spans.get("train.forward"), spans.get("train.optimizer")
    if not fwd or fwd.get("device_s") is None or not opt or \
            not opt["count"]:
        return None
    return fwd["device_s"] / opt["count"] * 1e3


def drop_pct(record: dict):
    """moe.drop_pct: 100 moe.dropped / moe.routed."""
    c = record.get("counters") or {}
    if not c.get("moe.routed"):
        return None
    return 100.0 * c["moe.dropped"] / c["moe.routed"]


def slot_fill_pct(record: dict):
    """moe.slot_fill_pct: 100 (moe.routed - moe.dropped) / moe.slots."""
    c = record.get("counters") or {}
    if not c.get("moe.slots"):
        return None
    return 100.0 * (c["moe.routed"] - c["moe.dropped"]) / c["moe.slots"]


def phases(spans: dict, designs: int) -> dict:
    """Host milliseconds a design of each evaluator phase, and of
    ``engine.measure``'s self time (``unspanned``)."""
    out = {}
    for key, name in (("capture", "executor.capture"),
                      ("release", "executor.release"),
                      ("gate", "engine.gate"), ("timing", "engine.timing"),
                      ("reference", "engine.reference"),
                      ("measure", "engine.measure")):
        if name in spans and designs:
            out[key] = spans[name]["total_s"] / designs * 1e3
    if "engine.measure" in spans and designs:
        out["unspanned"] = spans["engine.measure"]["self_s"] / designs * 1e3
    return out


# -- the program's spans on the trace's clock ---------------------------------

def span_intervals(events: list, tel, base_time_ns: int) -> list[dict]:
    """The finished spans of a registry's ``MemoryExporter`` events,
    each ``{name, id, parent, depth, b, e, attrs}`` with ``b`` and ``e``
    on the clock of the trace whose ``baseTimeNanoseconds`` is
    ``base_time_ns``."""
    open_: dict = {}
    out: dict = {}
    for ev in events:
        if ev["ph"] == "B":
            open_[ev["span_id"]] = ev
        elif ev["ph"] == "E" and ev["span_id"] in open_:
            b = open_.pop(ev["span_id"])
            out[ev["span_id"]] = {
                "name": ev["name"], "id": ev["span_id"],
                "parent": ev["parent_id"], "attrs": ev["args"],
                "b": tel.trace_ts(b["ts"], base_time_ns),
                "e": tel.trace_ts(ev["ts"], base_time_ns)}
    for s in out.values():
        depth, up = 0, s["parent"]
        while up in out:
            depth, up = depth + 1, out[up]["parent"]
        s["depth"] = depth
    return sorted(out.values(), key=lambda s: s["b"])


def span_at(spans: list[dict], t: float) -> str:
    """The innermost span open at ``t`` (µs, the trace's clock)."""
    best, depth = NO_SPAN, -1
    for s in spans:
        if s["b"] > t:
            break
        if t <= s["e"] and s["depth"] > depth:
            best, depth = s["name"], s["depth"]
    return best


def idle_spans(events: list, spans: list[dict], top: int = 10) -> dict:
    """The :data:`gpu.GAPS_NAMED` longest idle gaps of a profiled
    stretch (those ``gpu.summarize`` names by the host's call), summed
    by the innermost program span open at each one's start:
    ``{"idle_spans": [[name, s], ...], "named_s": their sum}``."""
    busy = gpu.busy_intervals(gpu.device_events(events))
    idle = sorted(((start - end, end) for (_, end), (start, _)
                   in zip(busy, busy[1:])), reverse=True)[:gpu.GAPS_NAMED]
    by: dict[str, float] = {}
    for length, end in idle:
        name = span_at(spans, end + 1.0)
        by[name] = by.get(name, 0.0) + length / 1e6
    return {"idle_spans": [[k, v] for k, v in sorted(
                by.items(), key=lambda kv: -kv[1])][:top],
            "named_s": sum(length for length, _ in idle) / 1e6}


def capture_encloses(events: list, spans: list[dict]) -> dict:
    """For each ``executor.capture`` span, the graph instantiation the
    runtime made inside it (the call that overlaps it most, within a
    millisecond): how many spans enclose theirs, and the least margin
    (µs) between a span's begin and its call's, and between the call's
    end and the span's."""
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == INSTANTIATE and "dur" in e)
    caps = [s for s in spans if s["name"] == "executor.capture"]
    begin, end, enclosed = [], [], 0
    for s in caps:
        # The call that overlaps the span most, within a millisecond.
        near = [(min(hi, s["e"]) - max(lo, s["b"]), lo, hi)
                for lo, hi in calls
                if lo <= s["e"] + 1e3 and hi >= s["b"] - 1e3]
        if not near:
            continue
        _, lo, hi = max(near)
        begin.append(lo - s["b"])
        end.append(s["e"] - hi)
        enclosed += lo >= s["b"] and hi <= s["e"]
    return {"captures": len(caps), "calls": len(calls),
            "enclosed": enclosed,
            "begin_margin_us": min(begin) if begin else None,
            "end_margin_us": min(end) if end else None}


class Profile(gpu.Profile):
    """:class:`gpu.Profile` that also keeps the trace's
    ``baseTimeNanoseconds`` (``result["base_time_ns"]``, 0 where nothing
    was traced), which puts a registry's spans on the trace's clock."""

    def stop(self) -> dict:
        self.running = False
        gpu.sync(self.device)
        self.result["window_s"] = time.perf_counter() - self._t0
        self.result["base_time_ns"] = 0
        if self._prof is not None:
            self._prof.stop()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    doc = json.load(f)
            self.result["events"] = doc["traceEvents"]
            self.result["base_time_ns"] = int(doc["baseTimeNanoseconds"])
            self._prof = None
        return self.result


def profiled(device, fn) -> dict:
    """``fn()`` under a registry and the profiler: the stretch's busy
    and window seconds, ``idle_gaps`` as the benchmark names them,
    ``idle_spans``, the registry's spans and counters, and the spans
    on the trace's clock with the trace's events (``intervals``,
    ``events``)."""
    from repro_torch import obs

    ex = obs.MemoryExporter()
    tel = obs.Telemetry([ex])
    with obs.use(tel), Profile(device) as got:
        fn()
    summary = gpu.summarize(got["events"], got["window_s"])
    spans = span_intervals(ex.events, tel, got["base_time_ns"])
    named = idle_spans(got["events"], spans)
    return {"busy_s": summary["busy_s"], "window_s": summary["window_s"],
            "idle_gaps": summary["breakdown"]["idle_gaps"],
            "idle_spans": named["idle_spans"],
            "idle_named_s": named["named_s"],
            "spans": tel.spans_by_name(), "counters": tel.counters(),
            "intervals": spans, "events": got["events"]}


# -- the cells ------------------------------------------------------------------

def _order(pairs: int) -> list[bool]:
    """Off, on, on, off, ...: ``pairs`` pairs, each side first in turn."""
    return [bool((i + i // 2) % 2) for i in range(2 * pairs)]


def _device(ctx: harness.Context):
    import torch

    return torch.device("cuda" if ctx.device is None else ctx.device)


def search(ctx: harness.Context, pairs: int = 2) -> dict:
    """The search cell's evaluator: sweeps without and with a registry,
    then its profiled stretch under one (the module's docstring)."""
    import numpy as np
    from repro_torch import obs

    drv = harness.load_module(ctx.cell.folder / "drivers" /
                              "search_graph.py",
                              "portbench_driver_search_graph")
    dev = _device(ctx)
    c, t = ctx.config, ctx.traffic
    vals, cols = inputs.band_matrix(c["n"], c["nnz"], c["half_bandwidth"],
                                    ctx.seed)
    x = inputs.vectors(c["n"], 1, ctx.seed)[0]
    prog = drv.Program(ctx, vals, cols, x, dev)
    drv.warm_up(prog, ctx.seed)
    seed = inputs.child_seed(ctx.seed, 12, 0)
    sweeps = []
    for traced in _order(pairs):
        tel = obs.Telemetry() if traced else None
        t0 = time.perf_counter()
        with obs.use(tel):
            _, n = drv.sweep(prog, seed, math.inf, set(), [])
        dt = time.perf_counter() - t0
        row = {"traced": traced, "designs": n, "s": dt,
               "candidates_per_s": n / dt}
        if traced:
            rec = {"spans": tel.spans_by_name(), "counters": tel.counters()}
            row["phases"] = phases(rec["spans"], n)
            row["gate_mb"] = gate_mb(rec)
        sweeps.append(row)
        print(f"sweep {'on ' if traced else 'off'}: {n} designs in "
              f"{dt:.2f} s", file=sys.stderr)
    rng = np.random.default_rng(inputs.child_seed(ctx.seed, 13))
    pick = [prog.designs[i] for i in
            rng.choice(len(prog.designs), t["trace_designs"],
                       replace=False)]
    ev = prog.evaluator()
    try:
        got = profiled(dev, lambda: ev.evaluate(pick))
    finally:
        ev.close()
    return {"sweeps": sweeps,
            "stretch": _stretch(got, len(pick)) | {
                "phases": phases(got["spans"], len(pick)),
                "gate_mb": gate_mb(got),
                "capture": capture_encloses(got["events"],
                                            got["intervals"])}}


def _stretch(got: dict, designs: int) -> dict:
    none = sum(s for k, s in got["idle_spans"] if k == NO_SPAN)
    return {"designs": designs, "busy_s": got["busy_s"],
            "window_s": got["window_s"], "idle_gaps": got["idle_gaps"],
            "idle_spans": got["idle_spans"],
            "idle_named_s": got["idle_named_s"],
            "no_span_share": none / got["idle_named_s"]
            if got["idle_named_s"] else None}


def train(ctx: harness.Context) -> dict:
    """The train cell's step: blocks of steps without and with a
    registry, then ``trace_steps`` steps profiled under one."""
    import torch
    from repro_torch import obs

    from portbench.reference import moe_lm as ref

    drv = harness.load_module(ctx.cell.folder / "drivers" / "train_step.py",
                              "portbench_driver_train_step")
    dev = _device(ctx)
    c, t = ctx.config, ctx.traffic
    s = ref.sizes(c)
    shapes = ref.leaf_shapes(s)
    events: list = []

    def mark(name: str) -> None:
        if dev.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append((name, e))

    stream = inputs.TokenStream(ctx.seed, t["batch"], t["seq"], s["vocab"],
                                dev)
    prog = drv.Program(c, shapes, ref.leaf_scales(shapes), ctx.seed, dev,
                       marks=mark)
    for _ in range(t["checked_steps"]):      # warm-up
        prog(stream.next())
    gpu.sync(dev)
    blocks = []
    for traced in _order(2):
        tel = obs.Telemetry() if traced else None
        marks = {"fwd_bwd": [], "opt": []}
        steps, t0 = 0, time.perf_counter()
        with obs.use(tel):
            while steps == 0 or time.perf_counter() < t0 + ctx.seconds / 4:
                events.clear()
                mark("start")
                prog(stream.next())
                gpu.sync(dev)
                steps += 1
                if events:
                    at = dict(events)
                    marks["fwd_bwd"].append(
                        at["start"].elapsed_time(at["backward"]))
                    marks["opt"].append(
                        at["backward"].elapsed_time(at["optimizer"]))
        dt = time.perf_counter() - t0
        row = {"traced": traced, "steps": steps, "s": dt,
               "tokens_per_s": steps * t["batch"] * t["seq"] / dt}
        if marks["fwd_bwd"]:
            row["marks_ms"] = {k: statistics.fmean(v)
                               for k, v in marks.items()}
        if traced:
            rec = {"spans": tel.spans_by_name(), "counters": tel.counters()}
            row["device_ms"] = {
                k: rec["spans"][f"train.{k}"]["device_s"] / steps * 1e3
                for k in ("forward", "backward", "optimizer")
                if rec["spans"][f"train.{k}"]["device_s"] is not None}
            row.update(fwd_ms=fwd_ms(rec), drop_pct=drop_pct(rec),
                       slot_fill_pct=slot_fill_pct(rec),
                       counters=rec["counters"])
        blocks.append(row)
        print(f"block {'on ' if traced else 'off'}: {steps} steps in "
              f"{dt:.2f} s", file=sys.stderr)
    got = profiled(dev, lambda: [prog(stream.next())
                                 for _ in range(t["trace_steps"])])
    return {"blocks": blocks,
            "stretch": _stretch(got, t["trace_steps"]) | {
                "device_ms": {k: v["device_s"] * 1e3 / t["trace_steps"]
                              for k, v in got["spans"].items()
                              if v["device_s"] is not None}}}


def run(ctx: harness.Context, pairs: int = 2) -> dict:
    driver = ctx.traffic["driver"]
    if driver == "search_graph":
        return search(ctx, pairs)
    if driver == "train_step":
        return train(ctx)
    raise harness.HarnessError(f"no program trace for the {driver} driver")


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0,
                    help="the train cell's four blocks together")
    ap.add_argument("--pairs", type=int, default=2,
                    help="the search cell's pairs of sweeps")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    os.environ.update(harness.cache_environment())
    sys.path.insert(0, str(harness.program_path()))
    cell = harness.load_cell(args.workload)
    ctx = harness.Context(cell, args.seed, args.seconds, True)
    line = {"workload": args.workload, "seed": args.seed,
            **run(ctx, args.pairs),
            "device": gpu.device_record(_device(ctx))}
    text = json.dumps(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
