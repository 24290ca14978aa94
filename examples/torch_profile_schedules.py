"""Where a schedule's time goes on the card, and the H100 machine
model's host and halo constants.

Measures every schedule of the SpMV DAG (2 streams, 280 of them) at the
paper's size with the wall-clock evaluator, then profiles the fastest,
the median and the slowest one with ``torch.profiler``: host wall time
per run, device busy time per run (union of the kernel and copy
intervals on all streams) and the idle share, and device time by
kernel name. Prints one JSON line per profiled schedule.

Then the constants of :class:`repro_torch.core.costmodel.Machine` that
describe the executor and the halo exchange:

  * host µs per item of a run, over 400 calls of each: a GPU
    op's issue as the runner makes it (``with torch.cuda.stream(s)``
    around Pack, yL, yR), each CPU op (PostSend, PostRecv, WaitSend and
    WaitRecv on a finished exchange), and each sync item (CER's
    ``Event.record``, CES's ``Event.synchronize`` on a finished event,
    CSWE's ``Stream.wait_event``). Timed twice: by the host clock
    around the calls, and by ``torch.profiler`` spans
    (``record_function``) around each, less an empty span's µs. The
    profiler adds its own cost to every PyTorch op it records inside a
    span (PostSend's 8 copies), so the machine constants take the
    clock's figures: the mean over each kind's items;
  * the 8 device-to-device halo copies of a run (the pattern of
    ``DistributedSpmv.post_send``) at 5 block sizes, CUDA events around
    the 8 copies, and the straight line through them: its intercept is
    ``comm_latency_s``, and one block's bytes over its slope per byte
    give ``link_bytes_per_s``;
  * the model's makespan of the reference schedule under those
    constants beside the measured host µs of one run.

Usage: PYTHONPATH=src python examples/torch_profile_schedules.py \
           [--runs 50] [--repeats 20]
"""
import argparse
import dataclasses
import json
import statistics
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch.core as C
from repro_torch.core.executor import build_runner
from repro_torch.engine import ExecutorEvaluator
from repro_torch.engine.wallclock import reference_schedule
from repro_torch.spmv.distributed import from_reference
from repro_torch.spmv.matrix import band_matrix, partition, stack_partitions

N, NNZ, RANKS = 150_000, 1_500_000, 4     # the paper's size
SLEEP_CYCLES = 2_000_000                   # ~1 ms of device sleep
CALLS = 400                                # calls of each item timed


def device_intervals(prof) -> list[tuple[float, float, str]]:
    """(start us, end us, name) of every device-side event."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.time_range.start, e.time_range.end, e.name))
    return out


def union_length(iv: list[tuple[float, float, str]]) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e, _ in sorted(iv):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def host_costs(spmv, calls: int) -> dict:
    """Host µs per call of each item kind of a run (module docstring)."""
    impls = spmv.impls()
    stream = torch.cuda.Stream()
    env = {"x": spmv.x}
    env.update(impls["Pack"](env))
    env.update(impls["PostSend"](env))
    env.update(impls["PostRecv"](env))
    env.update(impls["WaitRecv"](env))
    torch.cuda.synchronize()
    event = torch.cuda.Event()
    event.record(stream)
    torch.cuda.synchronize()

    def gpu(name):
        def call():
            with torch.cuda.stream(stream):
                impls[name](env)
        return call

    items = {
        "empty": ("none", lambda: None),
        **{f"gpu:{n}": ("gpu", gpu(n)) for n in ("Pack", "yL", "yR")},
        **{f"cpu:{n}": ("cpu", lambda n=n: impls[n](env))
           for n in ("PostSend", "PostRecv", "WaitSend", "WaitRecv")},
        "sync:CER": ("sync", lambda: event.record(stream)),
        "sync:CES": ("sync", lambda: event.synchronize()),
        "sync:CSWE": ("sync", lambda: stream.wait_event(event)),
    }

    def drain():
        torch.cuda.synchronize()
        event.record(stream)   # a finished event for CES and CSWE
        torch.cuda.synchronize()

    for _, fn in items.values():          # warm every path once
        fn()
    drain()
    clock = {}
    for label, (_, fn) in items.items():
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        clock[label] = (time.perf_counter() - t0) / calls * 1e6
        drain()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for label, (_, fn) in items.items():
            for _ in range(calls):
                with record_function(label):
                    fn()
            drain()
    span = {e.key: e.cpu_time_total / e.count for e in prof.key_averages()
            if e.key in items}
    empty = span["empty"]
    net = {k: span[k] - empty for k in items if k != "empty"}

    def mean_of(kind):
        return statistics.mean(v for k, v in clock.items()
                               if items[k][0] == kind)

    return {"calls": calls, "profiler_us": span, "empty_span_us": empty,
            "net_us": net, "clock_us": clock,
            "launch_overhead_us": mean_of("gpu"),
            "cpu_op_us": mean_of("cpu"), "sync_op_us": mean_of("sync")}


def halo_fit(m_paper: int, n_ranks: int, iters: int = 50) -> dict:
    """Device µs of a run's 2R halo copies at 5 block sizes, and the
    straight line through them (module docstring)."""
    comm = torch.cuda.Stream(priority=-1)
    sizes = [m_paper // 4, m_paper // 2, m_paper, 2 * m_paper, 4 * m_paper]
    us = []
    for m in sizes:
        blocks = torch.randn(n_ranks, m, device="cuda")
        halo = torch.empty(n_ranks, 2, m, device="cuda")

        def copies():
            with torch.cuda.stream(comm):
                for r in range(n_ranks):
                    halo[(r + 1) % n_ranks, 0].copy_(blocks[r],
                                                     non_blocking=True)
                    halo[(r - 1) % n_ranks, 1].copy_(blocks[r],
                                                     non_blocking=True)

        for _ in range(3):
            copies()
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            s, e = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            # The copies wait behind a device sleep while the host
            # issues them (~14 us each), so the events time the device.
            with torch.cuda.stream(comm):
                torch.cuda._sleep(SLEEP_CYCLES)
            s.record(comm)
            copies()
            e.record(comm)
            e.synchronize()
            ts.append(s.elapsed_time(e) * 1e3)
        us.append(statistics.median(ts))
    block_bytes = [4.0 * m for m in sizes]
    slope, intercept = np.polyfit(block_bytes, us, 1)
    return {"block_rows": sizes, "block_bytes": block_bytes,
            "copies": 2 * n_ranks, "device_us": us,
            "us_per_byte": float(slope), "intercept_us": float(intercept),
            "comm_latency_s": float(intercept) * 1e-6,
            "link_bytes_per_s": 1e6 / float(slope)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv)

    graph = C.spmv_dag()
    A = band_matrix(n=N, nnz=NNZ, seed=0)
    x = np.random.default_rng(1).standard_normal(N).astype(np.float32)
    spmv = from_reference(stack_partitions(partition(A, RANKS)), x)
    ev = ExecutorEvaluator(graph, impls=spmv.impls(), env=spmv.env(),
                           reset=spmv.poison, repeats=args.repeats,
                           warmup=3, store_tag=spmv.store_tag)
    scheds = list(C.enumerate_schedules(graph, 2))
    times = np.asarray(ev.evaluate(scheds))
    order = np.argsort(times, kind="stable")
    print(json.dumps({
        "what": "exhaustive", "platform": ev.platform,
        "objective": ev.objective_key(), "schedules": len(scheds),
        "gated": ev.n_checked, "best_us": float(times.min()) * 1e6,
        "median_us": float(np.median(times)) * 1e6,
        "worst_us": float(times.max()) * 1e6,
        "spread": float(times.max() / times.min())}), flush=True)

    for label, i in (("fastest", order[0]), ("median", order[len(order) // 2]),
                     ("slowest", order[-1])):
        run = build_runner(graph, scheds[i], spmv.impls())
        for _ in range(5):
            run(spmv.env())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.runs):
                run(spmv.env())
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        iv = device_intervals(prof)
        by_name: dict[str, float] = {}
        for s, e, name in iv:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / args.runs
        busy = union_length(iv) / args.runs if iv else None
        host = wall / args.runs * 1e6
        print(json.dumps({
            "what": label, "schedule": " ".join(
                str(it) for it in scheds[i].items),
            "measured_us": float(times[i]) * 1e6,
            "profiled_host_us_per_run": host,
            "device_busy_us_per_run": busy,
            "device_idle_share": None if busy is None else 1 - busy / host,
            "device_us_by_name": {k: round(v, 3) for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])}}), flush=True)


    # The machine model's constants (host items; halo copies).
    hc = host_costs(spmv, CALLS)
    print(json.dumps({"what": "host_costs", **hc}), flush=True)
    hf = halo_fit(spmv.m, spmv.n_ranks)
    print(json.dumps({"what": "halo_fit", **hf}), flush=True)
    machine = C.Machine(
        launch_overhead_s=hc["launch_overhead_us"] * 1e-6,
        cpu_op_s=hc["cpu_op_us"] * 1e-6, sync_op_s=hc["sync_op_us"] * 1e-6,
        comm_latency_s=hf["comm_latency_s"],
        link_bytes_per_s=hf["link_bytes_per_s"])
    ref = reference_schedule(graph)
    run = build_runner(graph, ref, spmv.impls())
    host = [ev.timed(run) for _ in range(200)]
    model_graph = C.spmv_dag(rows_per_rank=N // RANKS,
                             nnz_per_rank=NNZ // RANKS, value_bytes=4)
    print(json.dumps({
        "what": "machine", "fitted": dataclasses.asdict(machine),
        "default": dataclasses.asdict(C.Machine()),
        "reference_schedule_host_us": statistics.median(host) * 1e6,
        "reference_schedule_model_us": C.makespan(model_graph, ref,
                                                  machine) * 1e6,
        "reference_schedule_default_model_us": C.makespan(
            model_graph, ref) * 1e6}), flush=True)


if __name__ == "__main__":
    main()
