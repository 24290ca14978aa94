"""The paper's SpMV as its MPI program: one process and one card a rank,
the halo exchanged over a ``torch.distributed`` group (NCCL on cards).

The run starts ``ranks`` worker processes of this file, each of which
makes the band matrix and its vectors x from the seed, takes its part
with the program's ``partition`` and builds the program's
``make_rank_spmv(part, mesh, use_kernel=True, overlap_local=True)``.
After a warm-up chunk and a barrier the window runs chunks of ``chunk``
steps: a chunk's first step takes the chunk's x through ``run(x)`` (the
next of ``vectors`` x from the seed, so that every chunk needs a fresh
exchange), the rest are ``run.step()``; after each chunk rank 0 says
whether the window's time is up and every rank stops at the same step,
since a rank that made one more step would wait for ever on its
exchange. After the window each rank holds the y of every chunk's
first step and of the last step to float64 A x of its own rows.

A traced run then times, on every rank, a fixed count of exchanges
alone (``halo_exchange`` and its waits, drained), the host's issue of a
fixed count of steps without a sync, and a profiled stretch of steps.
The rendezvous is TCP on a free local port; the traffic's
``nccl_env`` is set for the ranks (``NCCL_SHM_DISABLE=1``: no NCCL
segments in ``/dev/shm``).
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import Context, Outcome  # noqa: E402

WORKER_SLACK_S = 240.0


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def run(ctx: Context) -> Outcome:
    """Start the ranks, wait for all of them, merge their lines."""
    world = ctx.traffic["ranks"]
    port = free_port()
    env = {**os.environ, **ctx.traffic.get("nccl_env", {}),
           "PYTHONPATH": os.pathsep.join(
               [str(ctx.root / "src"), str(ctx.root),
                os.environ.get("PYTHONPATH", "")])}
    device = "cuda" if ctx.device is None else str(ctx.device)
    # Each rank's output goes to a file of its own: a pipe that nobody
    # reads while the rank runs fills up and stops the rank (NCCL_DEBUG).
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in range(world)]
    t_spawn = time.time()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(rank),
         str(world), str(port), str(ctx.root), ctx.cell.name,
         str(ctx.seed), str(ctx.seconds), str(int(ctx.trace)), device],
        stdout=out, stderr=err, text=True, env=env)
        for rank, (out, err) in enumerate(logs)]
    outcome = Outcome()
    lines, errors = [], []
    deadline = time.monotonic() + ctx.seconds + WORKER_SLACK_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode for p in procs if p.poll() is not None):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for rank, (p, (out, err)) in enumerate(zip(procs, logs)):
            out.seek(0)
            err.seek(0)
            text, log = out.read(), err.read()
            out.close()
            err.close()
            if p.returncode == 0:
                lines.append(json.loads(text.strip().splitlines()[-1]))
            else:
                errors.append(f"rank {rank}: exit {p.returncode}\n"
                              f"{log[-3000:]}")
    if errors:
        outcome.error = "\n".join(errors)
        outcome.failed = len(errors)
        outcome.checks["y_gap"] = (float("inf"),
                                   ctx.traffic["y_gap_limit"])
        outcome.device = {"platform": "gpu" if device == "cuda" else "cpu",
                          "count": world, "memory_peak_bytes": 0}
        return outcome
    slowest = max(lines, key=lambda r: r["window_s"])
    outcome.record.update(
        setup_s=max(r["window_start"] for r in lines) - t_spawn,
        steps=slowest["steps"], steps_s=slowest["window_s"],
        window_s=slowest["window_s"])
    outcome.attempted = sum(r["steps"] for r in lines)
    outcome.checks["y_gap"] = (max(r["y_gap"] for r in lines),
                               ctx.traffic["y_gap_limit"])
    outcome.device = {"platform": "gpu" if device == "cuda" else "cpu",
                      "kind": lines[0]["kind"], "count": world,
                      "memory_peak_bytes": max(r["peak"] for r in lines)}
    if lines[0].get("power_limit_w") is not None:
        outcome.device["power_limit_w"] = lines[0]["power_limit_w"]
    if ctx.trace:
        outcome.record.update(
            exchange_us=max(r["exchange_us"] for r in lines),
            issue_us=max(r["issue_us"] for r in lines),
            stretch={k: sum(r["stretch"][k] for r in lines) / world
                     for k in ("busy_s", "window_s")})
        outcome.device.update(outcome.record["stretch"])
        outcome.breakdown = lines[0]["breakdown"]
    return outcome


def worker(rank: int, world: int, port: int, root: str, workload: str,
           seed: int, seconds: float, trace: bool, device: str) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from portbench import gpu, inputs
    from portbench.harness import load_cell
    from portbench.reference import spmv as ref
    from repro_torch.spmv.distributed import (AXIS, halo_exchange,
                                              make_rank_spmv)
    from repro_torch.spmv.matrix import EllMatrix, partition

    cell = load_cell(workload, Path(root))
    c, t = cell.config, cell.traffic
    if device == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world, device_id=dev)
    else:
        dev = torch.device("cpu")
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
    try:
        mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=(AXIS,))
        n = c["n"]
        m = n // world
        rows = slice(rank * m, (rank + 1) * m)
        vals, cols = inputs.band_matrix(n, c["nnz"], c["half_bandwidth"],
                                        seed)
        xs = inputs.vectors(n, t["vectors"], seed)
        part = partition(EllMatrix(vals, cols, n), world)[rank]
        spmv = make_rank_spmv(part, mesh, dev, use_kernel=True,
                              overlap_local=True)
        spmv(xs[0][rows])
        for _ in range(t["chunk"]):
            spmv.step()
        gpu.sync(dev)
        dist.barrier()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        stop = torch.zeros(1, dtype=torch.int32, device=dev)
        got: list = []
        steps = 0
        window_start = time.time()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            j = (steps // t["chunk"]) % t["vectors"]
            # run() returns y on the host, a view of the device's y on
            # the CPU: copied, as later steps rewrite it.
            got.append((j, np.array(spmv(xs[j][rows]))))
            for _ in range(t["chunk"] - 1):
                y = spmv.step()
            steps += t["chunk"]
            gpu.sync(dev)
            if rank == 0:
                stop.fill_(int(time.perf_counter() >= deadline))
            dist.broadcast(stop, 0)
            if int(stop.item()):
                break
        window_s = time.perf_counter() - t0
        got.append((j, y.cpu().numpy().copy()))
        peak = int(torch.cuda.max_memory_allocated(dev)) \
            if dev.type == "cuda" else 0
        want = {j: ref.matvec(vals, cols, xs[j], rows)
                for j in {j for j, _ in got}}
        gaps = [ref.rel_gap(y, want[j]) for j, y in got]
        out = {"rank": rank, "steps": steps, "window_s": window_s,
               "window_start": window_start,
               "y_gap": max(gaps), "peak": peak,
               "kind": torch.cuda.get_device_name(dev)
               if dev.type == "cuda" else "cpu",
               "power_limit_w": gpu.power_limit_w() if rank == 0 and
               dev.type == "cuda" else None}
        if trace:
            out.update(traced(spmv, halo_exchange, t, dev, m))
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def traced(spmv, halo_exchange, t: dict, dev, m: int) -> dict:
    """The exchange alone, the host's issue of steps, a profiled
    stretch: µs, µs, and the stretch's busy and window seconds."""
    import torch

    from portbench import gpu

    block = torch.zeros(m, dtype=torch.float32, device=dev)
    halo = torch.empty(2 * m, dtype=torch.float32, device=dev)
    gpu.sync(dev)
    t0 = time.perf_counter()
    for _ in range(t["exchange_steps"]):
        for work in halo_exchange(block, spmv.group, out=halo)[1]:
            work.wait()
    gpu.sync(dev)
    exchange_us = (time.perf_counter() - t0) / t["exchange_steps"] * 1e6
    t0 = time.perf_counter()
    for _ in range(t["issue_steps"]):
        spmv.step()
    issue_us = (time.perf_counter() - t0) / t["issue_steps"] * 1e6
    gpu.sync(dev)
    with gpu.Profile(dev) as got:
        for _ in range(t["trace_steps"]):
            spmv.step()
    summary = gpu.summarize(got["events"], got["window_s"])
    return {"exchange_us": exchange_us, "issue_us": issue_us,
            "stretch": {"busy_s": summary["busy_s"],
                        "window_s": summary["window_s"]},
            "breakdown": summary["breakdown"]}


if __name__ == "__main__":
    a = sys.argv[1:]
    sys.path.insert(0, str(Path(a[3]) / "src"))
    try:
        line = worker(int(a[0]), int(a[1]), int(a[2]), a[3], a[4],
                      int(a[5]), float(a[6]), bool(int(a[7])), a[8])
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    print(json.dumps(line), flush=True)
