"""The paper's search loop on the paper's program, under the compiled
objective whose ranks repeat.

Set-up makes the band matrix and x from the seed, partitions them with
the program's ``partition`` and builds its one-process SpMV
(``from_reference``), then warms every path the window takes: a capture,
a gate and a measurement of two designs, a capture and replays of one,
the rules pipeline once. The window runs sweeps back to back until
``ctx.seconds`` have passed and two sweeps are whole. A sweep is ``run_search`` over ``spmv_dag()``
at the configuration's streams with ``MCTSSearch`` seeded from the run's
seed and a fresh ``ExecutorEvaluator(cuda_graph=True)`` of the traffic's
protocol and no store, so that every design is captured, gated and
timed; once two sweeps are whole the strategy proposes nothing after
the window's time is up, so a later sweep may end short. After each whole sweep the rules pipeline
(``distill``) runs on its times and its fastest design is captured by
``jit_runner`` and replayed back to back ``replays`` times.

After the window the y = yL + yR that the replays left, after a sample
of the designs swept (drawn from the seed) and after each block of the
fastest design's replays, is held to float64 A x of the benchmark's own
arrays. A traced run also records the program's spans and profiles a
stretch of ``trace_designs`` designs and the fastest
design's replays one at a time, cold (after an L2 flush) and warm,
both after the window.
"""
from __future__ import annotations

import math
import sys
import time
import traceback

import numpy as np
import torch

from portbench import gpu, inputs
from portbench.harness import Context, Outcome
from portbench.reference import spmv as ref

# Device gaps longer than this split a profiled stretch into replays.
REPLAY_GAP_US = 50.0


class WindowedSearch:
    """A strategy that proposes what ``inner`` proposes until
    ``deadline``, then nothing; after each observation it calls
    ``observed(schedule)``."""

    def __init__(self, inner, deadline: float, observed):
        self.inner, self.deadline, self.observed = inner, deadline, observed

    def propose(self, budget: int):
        if time.perf_counter() >= self.deadline:
            return []
        return self.inner.propose(budget)

    def observe(self, schedule, t: float) -> None:
        self.inner.observe(schedule, t)
        self.observed(schedule)


class Program:
    """The port's SpMV, its DAG and designs, and the evaluator of the
    traffic's objective."""

    def __init__(self, ctx: Context, vals, cols, x, device):
        from repro_torch.core.dag import spmv_dag
        from repro_torch.core.enumerate import enumerate_schedules
        from repro_torch.spmv.distributed import from_reference
        from repro_torch.spmv.matrix import (EllMatrix, partition,
                                             stack_partitions)

        c = ctx.config
        self.device = device
        parts = partition(EllMatrix(vals, cols, c["n"]), c["ranks"])
        self.spmv = from_reference(stack_partitions(parts), x, device)
        self.graph = spmv_dag()
        self.streams = c["streams"]
        self.designs = list(enumerate_schedules(self.graph, self.streams))
        self.traffic = ctx.traffic

    def evaluator(self):
        from repro_torch.engine.wallclock import ExecutorEvaluator

        t = self.traffic
        s = self.spmv
        return ExecutorEvaluator(
            self.graph, impls=s.impls(), env=s.env(), reset=s.poison,
            repeats=t["repeats"], warmup=t["warmup"],
            t_measure_s=t["t_measure_s"], device=self.device,
            store_tag=s.store_tag, cuda_graph=True)

    def y(self) -> torch.Tensor:
        return self.spmv.yL + self.spmv.yR

    def replay_runner(self, design):
        """``jit_runner`` of ``design``, captured (its first call)."""
        from repro_torch.core.executor import jit_runner

        run = jit_runner(self.graph, design, self.spmv.impls(),
                         self.device)
        run(self.spmv.env())
        return run


def sweep(prog: Program, seed: int, deadline: float, sample: set[int],
          snaps: list):
    """One sweep; returns (SearchResult, designs measured). The y of the
    i-th distinct design measured is kept for each i in ``sample``."""
    from repro_torch.search import MCTSSearch, run_search

    seen: set = set()

    def observed(schedule) -> None:
        key = schedule.key()
        if key in seen:
            return
        if len(seen) in sample:
            snaps.append(prog.y().clone())
        seen.add(key)

    ev = prog.evaluator()
    try:
        res = run_search(prog.graph,
                         WindowedSearch(MCTSSearch(prog.graph, prog.streams,
                                                   seed=seed),
                                        deadline, observed),
                         ev, budget=None, batch_size=1)
    finally:
        ev.close()
    return res, len(seen)


def replay_block(prog: Program, design, count: int, snaps: list) -> float:
    """Host seconds of ``count`` back-to-back replays of ``design``."""
    run = prog.replay_runner(design)
    env = prog.spmv.env()
    gpu.sync(prog.device)
    t0 = time.perf_counter()
    for _ in range(count):
        run(env)
    gpu.sync(prog.device)
    dt = time.perf_counter() - t0
    snaps.append(prog.y().clone())
    run.release()
    return dt


def warm_up(prog: Program, seed: int) -> None:
    """Every path of the window once: two designs captured, gated and
    timed, a replay block, the rules pipeline."""
    from repro_torch.rules import distill
    from repro_torch.search import SearchResult

    ev = prog.evaluator()
    try:
        ev.evaluate(prog.designs[:2])
    finally:
        ev.close()
    replay_block(prog, prog.designs[0], 10, [])
    times = np.random.default_rng(inputs.child_seed(seed, 10)).random(
        len(prog.designs))
    distill(SearchResult(graph=prog.graph, schedules=prog.designs,
                         times=list(times), n_proposed=len(times),
                         cache_hits=0, cache_misses=len(times)))


def traced_stretch(prog: Program, seed: int, count: int) -> dict:
    """``count`` designs drawn from the seed, evaluated by a fresh
    evaluator of the window's objective under the profiler."""
    rng = np.random.default_rng(inputs.child_seed(seed, 13))
    pick = [prog.designs[i] for i in
            rng.choice(len(prog.designs), count, replace=False)]
    ev = prog.evaluator()
    try:
        with gpu.Profile(prog.device) as got:
            ev.evaluate(pick)
    finally:
        ev.close()
    return got


def traced_replays(prog: Program, design, count: int) -> list[dict]:
    """``count`` pairs of replays of ``design`` under the profiler, one
    after an L2 flush (cold) and one after it (warm), each alone on the
    device; per replay its device span and the µs of its ell_spmv and
    pack kernels."""
    run = prog.replay_runner(design)
    env = prog.spmv.env()
    flush = torch.empty(gpu.FLUSH_BYTES // 4, dtype=torch.float32,
                        device=prog.device)
    with gpu.Profile(prog.device) as got:
        for _ in range(count):
            for cold in (True, False):
                if cold:
                    flush.zero_()
                gpu.sync(prog.device)
                time.sleep(0.0005)
                run(env)
                gpu.sync(prog.device)
                time.sleep(0.0005)
    run.release()
    out = []
    replays = [c for c in gpu.clusters(gpu.device_events(got["events"]),
                                       REPLAY_GAP_US)
               if any("ell_spmv" in e["name"] for e in c)]
    for i, c in enumerate(replays):
        def us(word):
            return sum(e["dur"] for e in c if word in e["name"])
        out.append({"cold": i % 2 == 0,
                    "span_us": max(e["ts"] + e["dur"] for e in c) -
                    min(e["ts"] for e in c),
                    "ell_spmv_us": us("ell_spmv"), "pack_us": us("pack")})
    return out if len(out) == 2 * count else []


def run(ctx: Context) -> Outcome:
    from repro_torch import obs
    from repro_torch.rules import distill, label_times

    from portbench.metrics._yardstick import spmv_parts

    t_setup = time.perf_counter()
    dev = torch.device("cuda") if ctx.device is None else \
        torch.device(ctx.device)
    c, t = ctx.config, ctx.traffic
    vals, cols = inputs.band_matrix(c["n"], c["nnz"], c["half_bandwidth"],
                                    ctx.seed)
    x = inputs.vectors(c["n"], 1, ctx.seed)[0]
    prog = Program(ctx, vals, cols, x, dev)
    warm_up(prog, ctx.seed)
    gpu.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    record: dict = {"setup_s": time.perf_counter() - t_setup,
                    "t_measure_s": t["t_measure_s"], "repeats": t["repeats"],
                    "parts": spmv_parts(vals, cols, c["ranks"])}
    print(f"setup {record['setup_s']:.2f} s", file=sys.stderr)
    outcome = Outcome(record=record)
    rng = np.random.default_rng(inputs.child_seed(ctx.seed, 11))
    snaps: list = []
    sweeps: list[dict] = []
    best = None
    replay_s, replays, designs = 0.0, 0, 0
    tel = obs.Telemetry() if ctx.trace else None
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    try:
        with obs.use(tel):
            # The window closes at the first design after ctx.seconds
            # once two sweeps are whole: rank_rho needs two.
            while time.perf_counter() < deadline or len(sweeps) < 2:
                sample = set(rng.choice(len(prog.designs),
                                        t["checked_designs"],
                                        replace=False).tolist())
                t_sweep = time.perf_counter()
                res, n = sweep(prog, inputs.child_seed(ctx.seed, 12,
                                                       len(sweeps)),
                               deadline if len(sweeps) >= 2 else math.inf,
                               sample, snaps)
                designs += n
                print(f"sweep {len(sweeps)}: {n} designs in "
                      f"{time.perf_counter() - t_sweep:.2f} s",
                      file=sys.stderr)
                if n < len(prog.designs):
                    break
                distill(res)
                times = dict(zip((s.key() for s in res.schedules),
                                 res.times))
                labels = label_times(np.asarray(list(times.values())))
                sweeps.append({"times": times, "labels": dict(zip(
                    times, labels.labels.tolist()))})
                best = res.best()[0]
                replay_s += replay_block(prog, best, t["replays"], snaps)
                replays += t["replays"]
    except Exception:  # the window's failure is the run's result
        outcome.error = traceback.format_exc()
    record.update(window_s=time.perf_counter() - t0, designs=designs,
                  sweeps=sweeps, steps_s=replay_s, steps=replays)
    outcome.device = gpu.device_record(dev)
    outcome.attempted = designs
    if ctx.trace and outcome.error is None:
        # After the window, so that a traced run sweeps as the others:
        # a stretch of designs under the profiler, then the fastest
        # design's replays one at a time.
        record["spans"] = tel.spans_by_name()
        got = traced_stretch(prog, ctx.seed, t["trace_designs"])
        summary = gpu.summarize(got["events"], got["window_s"])
        record["stretch"] = {"busy_s": summary["busy_s"],
                             "window_s": summary["window_s"]}
        outcome.device.update(record["stretch"])
        outcome.breakdown = summary["breakdown"]
        if dev.type == "cuda":
            record["replay_trace"] = traced_replays(prog, best,
                                                    t["trace_replays"])

    # Held to the reference once the window has closed.
    y_ref = ref.matvec(vals, cols, x)
    gaps = [ref.rel_gap(y.cpu().numpy(), y_ref) for y in snaps]
    outcome.checks["y_gap"] = (max(gaps) if gaps else float("inf"),
                               t["y_gap_limit"])
    return outcome
