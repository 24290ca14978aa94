"""Where a schedule's time goes on the card.

Measures every schedule of the SpMV DAG (2 streams, 280 of them) at the
paper's size with the wall-clock evaluator, then profiles the fastest,
the median and the slowest one with ``torch.profiler``: host wall time
per run, device busy time per run (union of the kernel and copy
intervals on all streams) and the idle share, and device time by
kernel name. Prints one JSON line per profiled schedule.

Usage: PYTHONPATH=src python examples/torch_profile_schedules.py \
           [--runs 50] [--repeats 20]
"""
import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as C
from repro_torch.core.executor import build_runner
from repro_torch.engine import ExecutorEvaluator
from repro_torch.spmv.distributed import from_reference
from repro_torch.spmv.matrix import band_matrix, partition, stack_partitions


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv)

    graph = C.spmv_dag()
    A = band_matrix(n=150_000, nnz=1_500_000, seed=0)
    x = np.random.default_rng(1).standard_normal(150_000).astype(np.float32)
    spmv = from_reference(stack_partitions(partition(A, 4)), x)
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


if __name__ == "__main__":
    main()
