#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage: python3 chip_smoke.py        (from the repository root, one card)

Phases, each printing one JSON line:

  probe        card, capability, power limit, torch and nvcc versions
  build        nvcc build of the hand-written kernels (csrc/*.cu)
  kernels      each kernel against its plain PyTorch version on the card
               at the main path's shapes and on the reference sweep's
               cases; CUDA-event medians of kernel, plain version and one
               PyTorch library call, beside the bound (bytes or flops over
               the card's peak)
  distributed  the 4-rank SpMV at the paper's size against the float64
               oracle
  race         two schedules with one sync removed must fail the value
               gate (and pass with it)
  main_path    the paper's loop: spmv_dag -> MCTS (budget 400) measured
               on real streams -> labels -> features -> Algorithm 1 ->
               rules, with every kernel's launch count over that run

Then the card's ``name, power.limit``, one ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before the last line. Without CUDA, or without the repository beside
it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside tensor cores
PAPER_N, PAPER_NNZ, RANKS = 150_000, 1_500_000, 4
SLEEP_CYCLES = 50_000_000      # ~25 ms of device sleep (queues launches, delays a producer)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int = 60) -> float:
    """Median device milliseconds of ``fn()``: CUDA events around each
    call, the 50 MB L2 flushed before each, launches queued behind a
    device sleep so the host never starves the card."""
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    err = float((got.float() - ref.float()).abs().max())
    return err, err / (float(ref.float().abs().max()) + 1e-30)


def csr_of(vals_t: torch.Tensor, cols_t: torch.Tensor, n_cols: int):
    """The nonzeros of an ELL-T matrix as a CSR tensor (the library
    call's operand; built once, outside any timing)."""
    vals, cols = vals_t.T.contiguous(), cols_t.T.contiguous()
    keep = vals != 0
    crow = torch.zeros(vals.shape[0] + 1, dtype=torch.int64,
                       device=vals.device)
    crow[1:] = keep.sum(1).cumsum(0)
    return torch.sparse_csr_tensor(crow, cols[keep].long(), vals[keep],
                                   size=(vals.shape[0], n_cols))


def phase_kernels(spmv, dev) -> dict:
    from repro_torch.kernels.pack.ops import pack, pack_plain
    from repro_torch.kernels.spmv.ops import (ell_matvec, ell_matvec_t,
                                              ell_spmv_plain)

    # Fill the halo with the values the main path gives yR.
    spmv.post_send(spmv.pack(spmv.x))
    torch.cuda.synchronize()
    x, halo = spmv.x, spmv.halo.clone()

    calls = []
    for name, (vt, ct), xin in (("yL", spmv.local, x),
                                ("yR", spmv.remote, halo)):
        out = ell_matvec_t(vt, ct, xin)
        plain = ell_spmv_plain(vt, ct, xin)
        torch.cuda.synchronize()
        err, rel = rel_err(out, plain)
        if not rel <= 1e-5:
            raise AssertionError(f"ell_spmv {name}: rel err {rel} > 1e-5")
        k, n = vt.shape
        nz = vt != 0
        nnz = int(nz.sum())
        # The product's own bytes: each non-zero's value and column, each
        # x entry it touches, y. The kernel also reads the K*N - nnz
        # zero slots that pad every row to K (reported beside it).
        x_bytes = int(torch.unique(ct[nz]).numel()) * xin.element_size()
        n_bytes = nnz * (vt.element_size() + 4) + x_bytes + n * 4
        slot_bytes = k * n * (vt.element_size() + 4) + x_bytes + n * 4
        b, by = bound_ms(n_bytes, 2.0 * nnz)
        csr = csr_of(vt, ct, xin.numel())
        try:
            lib = time_cuda(lambda: torch.mv(csr, xin))
            lib_err = None
        except RuntimeError as e:          # no CSR mv on this build
            lib, lib_err = None, str(e)[:200]
        calls.append({
            "op": name, "K": k, "N": n, "nx": xin.numel(), "nnz": nnz,
            "bytes": n_bytes, "slot_bytes": slot_bytes,
            "bound_ms_slots": bound_ms(slot_bytes, 2.0 * nnz)[0],
            "max_abs_err": err, "rel_err": rel,
            "ms": time_cuda(lambda: ell_matvec_t(vt, ct, xin, out=out)),
            "plain_ms": time_cuda(lambda: ell_spmv_plain(vt, ct, xin)),
            "library_ms": lib, "library_error": lib_err,
            "bound_ms": b, "bound_by": by})

    idx, sendbuf = spmv.send_idx, torch.empty_like(spmv.sendbuf)
    got = pack(x, idx, out=sendbuf)
    plain = pack_plain(x, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, plain):
        raise AssertionError("pack differs from its plain version")
    valid = idx[(idx >= 0) & (idx < x.numel())]
    n_bytes = idx.numel() * 4 + got.numel() * got.element_size() + \
        int(torch.unique(valid).numel()) * x.element_size()
    b, by = bound_ms(n_bytes, 0.0)
    pack_call = {
        "op": "Pack", "n": x.numel(), "m": idx.numel(), "bytes": n_bytes,
        "max_abs_err": 0.0,
        "ms": time_cuda(lambda: pack(x, idx, out=sendbuf)),
        "plain_ms": time_cuda(lambda: pack_plain(x, idx)),
        "library_ms": time_cuda(lambda: torch.index_select(x, 0, idx)),
        "bound_ms": b, "bound_by": by}

    # The reference sweep's cases (tests/test_kernels.py): ragged n and
    # K, bf16 inputs, and pack with -1 padding.
    sweep = []
    rng = np.random.default_rng(0)
    for n, k, dtype in ((64, 1, torch.float32), (300, 7, torch.float32),
                        (512, 8, torch.float32), (1024, 16, torch.bfloat16),
                        (2048, 5, torch.bfloat16)):
        vals = torch.from_numpy(rng.standard_normal((n, k)).astype(
            np.float32)).to(dev, dtype)
        cols = torch.from_numpy(rng.integers(0, n, (n, k)).astype(
            np.int32)).to(dev)
        xs = torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dev, dtype)
        out = ell_matvec(vals, cols, xs)
        plain = ell_spmv_plain(vals.T, cols.T, xs)
        _, rel = rel_err(out, plain)
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        if not rel <= tol:
            raise AssertionError(f"ell_spmv ({n},{k},{dtype}): {rel}")
        sweep.append({"kernel": "ell_spmv", "n": n, "k": k,
                      "dtype": str(dtype), "rel_err": rel})
    for n, m, dtype in ((128, 64, torch.float32), (1000, 333, torch.float32),
                        (4096, 1024, torch.bfloat16)):
        xs = torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dev, dtype)
        ids = rng.integers(0, n, m).astype(np.int32)
        ids[::7] = -1
        ids_t = torch.from_numpy(ids).to(dev)
        if not torch.equal(pack(xs, ids_t), pack_plain(xs, ids_t)):
            raise AssertionError(f"pack ({n},{m},{dtype}) differs")
        sweep.append({"kernel": "pack", "n": n, "m": m,
                      "dtype": str(dtype), "exact": True})
    return {"ell_spmv": calls, "pack": [pack_call], "sweep": sweep}


def phase_race(spmv, dev) -> dict:
    """Both checks must be caught by the value gate, and pass intact."""
    from repro_torch.core.dag import (BoundOp, Graph, Op, OpKind, Schedule,
                                      spmv_dag)
    from repro_torch.core.executor import op_impl, run_items
    from repro_torch.core.sync import expand
    from repro_torch.engine.wallclock import (ExecutorEvaluator,
                                              reference_schedule)

    def caught(ev, g, items, drop) -> dict:
        cut = [it for it in items if it.name != drop]
        if len(cut) != len(items) - 1:
            raise AssertionError(f"{drop} not in the expanded schedule")
        ev.check(run_items(g, items, ev.impls, dev), "intact schedule")
        try:
            ev.check(run_items(g, cut, ev.impls, dev), f"without {drop}")
        except AssertionError as e:
            return {"dropped": drop, "caught": True,
                    "gate": str(e).strip().splitlines()[0][:160]}
        raise AssertionError(f"removing {drop} was not caught by the gate")

    # 1. Pack delayed on its stream; PostSend's copies no longer wait.
    g = spmv_dag()
    impls = spmv.impls()
    pack_impl = impls["Pack"]

    def slow_pack(env):
        torch.cuda._sleep(SLEEP_CYCLES)
        return pack_impl(env)

    impls["Pack"] = slow_pack
    ev = ExecutorEvaluator(g, impls=impls, env=spmv.env(),
                           reset=spmv.poison, device=dev)
    spmv_race = caught(ev, g, expand(g, reference_schedule(g)),
                       "CES-b4-PostSend")

    # 2. A GPU producer and consumer on two streams, without the CSWE.
    toy = Graph()
    toy.add_op(Op("P", OpKind.GPU))
    toy.add_op(Op("C", OpKind.GPU))
    toy.add_edge("P", "C")
    toy.finalize()
    src = torch.arange(1 << 20, dtype=torch.float32, device=dev)
    mid, res = torch.empty_like(src), torch.empty_like(src)

    def produce(s):
        torch.cuda._sleep(SLEEP_CYCLES)
        return torch.mul(s, 2.0, out=mid)

    def poison():
        mid.fill_(float("nan"))
        res.fill_(float("nan"))

    toy_impls = {"P": op_impl(produce, ["src"], ["mid"]),
                 "C": op_impl(lambda m: torch.add(m, 1.0, out=res),
                              ["mid"], ["res"])}
    sched = Schedule((BoundOp("start"), BoundOp("P", 0), BoundOp("C", 1),
                      BoundOp("end")))
    ev = ExecutorEvaluator(toy, impls=toy_impls, env={"src": src},
                           reset=poison, device=dev)
    toy_race = caught(ev, toy, expand(toy, sched), "CSWE-b4-C")
    return {"checks": [spmv_race, toy_race]}


def phase_main_path(spmv, A, x, dev) -> dict:
    from repro_torch.core.dag import spmv_dag
    from repro_torch.core.features import featurize
    from repro_torch.engine.wallclock import ExecutorEvaluator
    from repro_torch.kernels.pack import kernel as pack_k
    from repro_torch.kernels.spmv import kernel as spmv_k
    from repro_torch.rules import (algorithm1, extract_rulesets,
                                   label_times, render_rules_table,
                                   rules_by_class)
    from repro_torch.search import MCTSSearch, run_search

    g = spmv_dag()
    ev = ExecutorEvaluator(g, impls=spmv.impls(), env=spmv.env(),
                           reset=spmv.poison, repeats=20, warmup=3,
                           device=dev)
    spmv_k.ell_spmv.launches = 0
    pack_k.pack.launches = 0
    t0 = time.perf_counter()
    res = run_search(g, MCTSSearch(g, 2, seed=0), ev, budget=400,
                     batch_size=1)
    wall = time.perf_counter() - t0
    launches = {"ell_spmv": spmv_k.ell_spmv.launches,
                "pack": pack_k.pack.launches}

    ref = ev.reference_outputs()
    y = ref["yL"].astype(np.float64) + ref["yR"]
    oracle = A.matvec(x)
    y_rel = float(np.abs(y - oracle).max() / np.abs(oracle).max())
    if not y_rel <= 1e-4:
        raise AssertionError(f"main path y: rel err {y_rel} > 1e-4")
    if ev.n_checked != len(res.schedules):
        raise AssertionError(f"{ev.n_checked} gated of "
                             f"{len(res.schedules)} schedules")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never ran: {launches}")

    times = res.times_array()
    labels = label_times(times)
    fm = featurize(g, res.schedules)
    tree = algorithm1(fm.X, labels.labels)
    table = render_rules_table(
        rules_by_class(extract_rulesets(tree, fm.features)), top_k=2)
    if "performance class" not in table:
        raise AssertionError("no rules table")
    print(table, flush=True)
    best, t_best = res.best()
    return {
        "platform": ev.platform, "objective": ev.objective_key(),
        "proposed": res.n_proposed, "schedules": len(res.schedules),
        "gated": ev.n_checked, "best_us": float(t_best) * 1e6,
        "worst_us": float(times.max()) * 1e6,
        "median_us": float(np.median(times)) * 1e6,
        "spread": float(times.max() / times.min()),
        "best_schedule": " ".join(str(i) for i in best.items),
        "classes": labels.n_classes,
        "class_sizes": np.bincount(labels.labels).tolist(),
        "features": len(fm.features), "tree_leaves": tree.n_leaves(),
        "tree_depth": tree.depth(),
        "tree_error": tree.training_error(fm.X, labels.labels),
        "y_rel_err": y_rel, "search_wall_s": wall, "launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.device import probe, resolve_device
        from repro_torch.kernels import build
        from repro_torch.spmv.distributed import (from_reference,
                                                  make_distributed_spmv)
        from repro_torch.spmv.matrix import (band_matrix, partition,
                                             stack_partitions)
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 1
    if "jax" in sys.modules or "repro" in sys.modules:
        print("chip_smoke: JAX or the JAX package was imported",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device()
    smi = nvidia_smi_line()
    emit("probe", nvidia_smi=smi, **probe())

    report = build.build()
    ptxas = {s: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for s, log in report["logs"].items()}
    emit("build", seconds=report["seconds"], dir=str(report["dir"]),
         ptxas=ptxas)

    t0 = time.perf_counter()
    A = band_matrix(n=PAPER_N, nnz=PAPER_NNZ, seed=0)
    parts = partition(A, RANKS)
    x = np.random.default_rng(1).standard_normal(PAPER_N).astype(
        np.float32)
    spmv = from_reference(stack_partitions(parts), x, dev)
    torch.cuda.synchronize()
    emit("setup", n=PAPER_N, nnz=PAPER_NNZ, ranks=RANKS, m=spmv.m,
         k_local=spmv.local[0].shape[0], k_remote=spmv.remote[0].shape[0],
         seconds=time.perf_counter() - t0)

    kern = phase_kernels(spmv, dev)
    emit("kernels", **kern)

    y = make_distributed_spmv(parts, dev)(x)
    oracle = A.matvec(x)
    rel = float(np.abs(y - oracle).max() / np.abs(oracle).max())
    emit("distributed", rel_err=rel, ok=rel <= 1e-4)
    if not rel <= 1e-4:
        raise AssertionError(f"distributed y: rel err {rel} > 1e-4")

    emit("race", **phase_race(spmv, dev))
    main_path = phase_main_path(spmv, A, x, dev)
    emit("main_path", **main_path)

    def entry(name, source, replaces, calls):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": main_path["launches"][name],
                "max_abs_err": max(c["max_abs_err"] for c in calls),
                **{k: (None if any(c[k] is None for c in calls)
                       else sum(c[k] for c in calls))
                   for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
                "bound_by": calls[0]["bound_by"]}

    print(smi, flush=True)
    print(json.dumps({"kernels": [
        entry("ell_spmv", "src/repro_torch/csrc/ell_spmv.cu",
              "src/repro/kernels/spmv/kernel.py:49", kern["ell_spmv"]),
        entry("pack", "src/repro_torch/csrc/pack.cu",
              "src/repro/kernels/pack/kernel.py:49", kern["pack"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
