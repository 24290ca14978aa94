"""The port's benchmark harness: one cell of ``BENCHMARK.json``, run once.

A cell names a configuration and a traffic mix. Both are data files
found by name: ``configs/<config>.json`` (the sizes as run, their
source, the cuts under ``reduced``) and ``traffic/<traffic>.json`` (the
parameters of the timed window and the driver that runs it,
``drivers/<driver>.py``). Every metric is a reader of its own,
``metrics/<metric>.py``, that takes it from what the driver recorded.
A new cell, configuration or metric is a new file and an entry in
``BENCHMARK.json``; no file here names one.

A driver's ``run(ctx)`` builds the program (the PyTorch and CUDA port,
``src/repro_torch``), warms it up, runs the timed window for
``ctx.seconds`` and, once the window has closed, holds what the timed
path produced to a plain reference under ``reference/``. It returns an
:class:`Outcome`; this module turns it into the result's last line.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Any

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Top-level module names that no process of a run may hold once its
# window has closed: the JAX stack and the JAX package beside the port
# (compared whole, so the port's own name, which begins with the JAX
# package's, is not one of them), and its benchmark folder.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


class HarnessError(RuntimeError):
    """A run that cannot give a result: no card, too few cards, no
    program beside the harness, or a forbidden module loaded."""


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def cache_environment(root: Path = ROOT) -> dict[str, str]:
    """Fixed cache directories inside the checkout for every build or
    kernel cache the program may use (the port builds its kernels into
    ``build/repro_torch/<hash>/`` by itself)."""
    build = root / "build"
    return {"TRITON_CACHE_DIR": str(build / "triton"),
            "TORCH_EXTENSIONS_DIR": str(build / "torch_extensions")}


def program_path(root: Path = ROOT) -> Path:
    """The port's source tree, which the harness measures."""
    src = root / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise HarnessError(f"no program beside the harness: {src}/"
                           "repro_torch is missing")
    return src


def load_module(path: Path, name: str):
    """A module from a file of the harness, by path (file names hold
    dots, which the import system reads as packages)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise HarnessError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with what it names, read from files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]
    folder: Path = HERE


def _reports(metric: dict, cell: str, e2e: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its configuration
    and traffic files, and the metrics it reports; its drivers and
    metric readers are those of ``root``'s copy of this folder."""
    folder = root / HERE.name
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise HarnessError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (folder / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = tuple(m for m in bench["end_to_end"]
                if "workloads" not in m or name in m["workloads"])
    names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"]
                      if _reports(m, name, names))
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer,
                folder)


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, the device
    (``None``: the card) and where the harness lives."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any = None
    root: Path = ROOT

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


@dataclasses.dataclass
class Outcome:
    """What a driver returns.

    ``record`` holds the raw readings (host-clock times, counts, spans,
    summaries of profiler traces) that the metric readers turn into
    numbers. ``checks`` maps each number compared with the reference to
    ``(value, limit)``: the run is correct when each value is finite and
    at most its limit, nothing failed and no error was raised.
    """

    attempted: int = 0
    failed: int = 0
    checks: dict[str, tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    record: dict = dataclasses.field(default_factory=dict)
    device: dict = dataclasses.field(default_factory=dict)
    breakdown: dict | None = None
    error: str | None = None

    def correct(self) -> bool:
        return (self.error is None and self.failed == 0 and
                self.attempted > 0 and bool(self.checks) and
                all(math.isfinite(v) and v <= lim
                    for v, lim in self.checks.values()))


def read_metrics(metrics: tuple[dict, ...], record: dict,
                 folder: Path = HERE) -> dict:
    """Each metric its reader finds something for, with its unit; a
    reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in metrics:
        reader = load_module(folder / "metrics" / f"{m['name']}.py",
                             f"portbench_metric_{m['name']}")
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell: Cell, outcome: Outcome, trace: bool) -> dict:
    """The contract's last line; the compared numbers, each beside its
    limit, come last under ``checks``."""
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                           outcome.record, cell.folder)
    line = {"correct": outcome.correct(), "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics,
            "device": outcome.device}
    if trace and outcome.breakdown:
        line["breakdown"] = outcome.breakdown
    if outcome.error:
        line["error"] = outcome.error[-2000:]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in outcome.checks.items()}
    return line


def run_cell(ctx: Context, *, require_card: bool = True) -> dict:
    """Run ``ctx.cell`` once and return its result line. With
    ``require_card`` (every run of the benchmark) a run without as many
    cards as the cell asks for raises :class:`HarnessError`; the tests
    pass False to drive the rest of a run on the CPU."""
    import torch

    if require_card:
        if not torch.cuda.is_available():
            raise HarnessError("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < ctx.cell.chips:
            raise HarnessError(
                f"the cell needs {ctx.cell.chips} cards, "
                f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    driver = load_module(
        ctx.cell.folder / "drivers" / f"{ctx.traffic['driver']}.py",
                         f"portbench_driver_{ctx.traffic['driver']}")
    outcome = driver.run(ctx)
    return result_line(ctx.cell, outcome, ctx.trace)


def print_result(line: dict) -> None:
    """The compared numbers as the last lines of standard error, then
    the result as the last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def parse_args(argv: list[str]):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    try:
        os.environ.update(cache_environment())
        sys.path.insert(0, str(program_path()))
        cell = load_cell(args.workload)
        line = run_cell(Context(cell, args.seed, args.seconds,
                                bool(args.trace)))
    except (HarnessError, FileNotFoundError, ImportError) as e:
        print(f"portbench: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    print_result(line)
    return 0

