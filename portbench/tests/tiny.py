"""Tiny copies of the benchmark for the CPU tests: a temporary root with
this checkout's harness folder and a ``BENCHMARK.json`` whose cells
keep their traffic and drivers but run configurations small enough for
the CPU (their files written beside the real ones)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.harness import HERE, ROOT, Context, load_cell, run_cell

# The configurations' sizes for the CPU: every width that the program's
# plain path would take minutes for is cut, the kinds of layer kept.
TINY = {
    "spmv-paper": {"n": 1024, "nnz": 8192, "half_bandwidth": 256},
    "deepseek-moe-16b": {"num_hidden_layers": 2, "hidden_size": 128,
                         "num_attention_heads": 4, "num_key_value_heads": 4,
                         "moe_intermediate_size": 64, "n_routed_experts": 8,
                         "num_experts_per_tok": 2, "n_shared_experts": 1,
                         "vocab_size": 2048, "intermediate_size": 96},
}
# The traffic's parameters for the CPU: shorter windows and fewer steps.
TINY_TRAFFIC = {
    "search-graph": {"t_measure_s": 0.0002, "repeats": 2, "warmup": 1,
                     "replays": 20, "checked_designs": 4},
    # Limits read at this size on the CPU (the cell's are read on the
    # card): sound runs of seeds 6 and 7 read under them, the control of
    # those seeds over them.
    "train-4k": {"seq": 128, "batch": 2, "grad_norm_gap_limit": 0.01,
                 "grad_median_gap_limit": 2e-3,
                 "change_norm_gap_limit": 4e-3},
    "rank4-nccl": {"chunk": 20, "exchange_steps": 10, "issue_steps": 10},
}


# The four-card cell, whose files the harness keeps (PERF.md §7: its
# step's spread keeps it out of BENCHMARK.json), added by its entries
# alone.
RANK_CELL = {"name": "spmv-paper.rank4-nccl", "config": "spmv-paper",
             "traffic": "rank4-nccl", "chips": 4,
             "why": "the paper's MPI form, one process and card a rank"}
RANK_METRICS = [
    {"name": n, "unit": u, "better": "lower", "source": src,
     "layer": layer, "moves": "step_us", "workloads": [RANK_CELL["name"]]}
    for n, u, src, layer in (
        ("rank.exchange_us", "us", "host_clock", "per-rank SpMV"),
        ("rank.issue_us", "us", "host_clock", "per-rank SpMV"),
        ("device_idle_pct.rank", "%", "device_trace", "device"))]


def tiny_root(tmp: Path) -> Path:
    """A root under ``tmp`` with the harness folder and a BENCHMARK.json
    of tiny configurations, the four-card cell among its cells; returns
    it."""
    shutil.copytree(HERE, tmp / HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(RANK_CELL)
    bench["per_layer"] += RANK_METRICS
    for m in bench["end_to_end"]:
        if m["name"] == "step_us":
            m["workloads"].append(RANK_CELL["name"])
    for c in bench["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY.get(c["name"], {}))
        path.write_text(json.dumps(cfg))
    folder = tmp / HERE.name / "traffic"
    for w in bench["workloads"]:
        path = folder / f"{w['traffic']}.json"
        traffic = json.loads(path.read_text())
        traffic.update(TINY_TRAFFIC.get(w["traffic"], {}))
        path.write_text(json.dumps(traffic))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run_tiny(root: Path, workload: str, seed: int = 7,
             seconds: float = 1.0, trace: bool = False) -> dict:
    """One run of ``workload`` of a tiny root on the CPU, the look for a
    card skipped."""
    import torch

    torch.set_num_threads(2)
    cell = load_cell(workload, root)
    return run_cell(Context(cell, seed, seconds, trace, device="cpu",
                            root=root), require_card=False)
