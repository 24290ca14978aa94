"""Production-mesh dry run: one step of a cell, counted, nothing allocated.

Port of ``repro/launch/dryrun.py``. For every (architecture x input
shape) cell, on the 16x16 mesh and/or the 2x16x16 mesh: build the cell
(``launch/inputs.py``: a meta-device model, DTensor arguments whose
shards are meta tensors) over a ``fake`` process group of 256 or 512
ranks in this one process, run the step once under the analyzer
(``launch/hlo.py``: dot FLOPs, collective bytes by kind and by mesh
axis, argument/output/temporary bytes, all per GPU), price it with the
H100 roofline (``launch/costs.py``) and write a JSON record.

The record keeps the reference's keys where they mean the same thing and
drops its XLA-CPU ones (``cpu_upcast_bytes``,
``per_device_bytes_tpu_estimate``). Every applicable cell of the ten
configs runs; an exception is a failure. Mamba's time loop runs two of
its chunks, the second weighted by the chunks after the first
(``launch/inputs.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape decode_32k --reduced --mesh 2x4
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import pathlib
import time
import traceback

import torch.distributed as dist

from repro_torch.configs import ARCHS
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.launch import costs as costs_mod
from repro_torch.launch import hlo as hlo_mod
from repro_torch.launch.mesh import (PRODUCTION, init_fake_group,
                                     make_local_mesh, make_production_mesh)

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "dryrun_torch"


def mesh_name(multi_pod: bool, shape: tuple | None = None) -> str:
    if shape is not None:
        return "local" + "x".join(map(str, shape))
    return "pod2x16x16" if multi_pod else "pod16x16"


def fake_mesh(multi_pod: bool, shape: tuple | None = None):
    """The production mesh, or a (data, model) mesh of ``shape``, over a
    fake group of its size (replacing a default group of another
    size)."""
    size = math.prod(shape or PRODUCTION[multi_pod][0])
    if dist.is_initialized() and dist.get_world_size() != size:
        dist.destroy_process_group()
    if not dist.is_initialized():
        init_fake_group(size)
    if shape is not None:
        return make_local_mesh(*shape, device_type="cpu")
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def quiet() -> None:
    """DTensor warns at every two-step redistribution of a dim sharded
    over two mesh axes; the dry run counts those collectives."""
    for name in ("torch.distributed.tensor._redistribute",
                 "torch.distributed.tensor._dispatch",
                 "torch._logging._internal"):
        logging.getLogger(name).setLevel(logging.ERROR)


def analyze_cell(cell, mesh, chips: int, shape: str) -> dict:
    """Run ``cell`` once under the analyzer; the record's counted part."""
    t0 = time.time()
    analysis, _ = hlo_mod.analyze(cell.fn, *cell.args, mesh=mesh,
                                  counter=cell.counter)
    run_s = time.time() - t0
    mem = analysis.memory
    kind = cell.meta["kind"]
    rf = costs_mod.roofline(
        cell.cfg, shape, kind, chips,
        hlo_flops_per_chip=analysis.dot_flops,
        collective_bytes_per_chip=analysis.total_collective_bytes,
        memory_stats=mem,
        collective_bytes_f32=analysis.collective_bytes_f32)
    return {
        "memory_analysis": mem,
        "per_device_bytes": mem["argument_size_in_bytes"] +
        mem["temp_size_in_bytes"] + mem["output_size_in_bytes"] -
        mem["alias_size_in_bytes"],
        "hlo": {
            "dot_flops_per_chip": analysis.dot_flops,
            "collective_bytes_f32": analysis.collective_bytes_f32,
            "collective_bytes": analysis.collective_bytes,
            "collective_count": analysis.collective_count,
            "collective_bytes_by_axis": analysis.collective_bytes_by_axis,
            "loop_trips": analysis.loop_trips,
        },
        "roofline": rf.to_dict(),
        "run_s": run_s,
    }


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             out_dir: pathlib.Path = OUT_DIR, force: bool = False,
             tag: str = "", mesh_shape: tuple | None = None,
             reduced: bool = False) -> dict:
    """One cell's record (read back from ``out_dir`` unless ``force``).
    ``mesh_shape`` replaces the production mesh by a (data, model) one;
    ``reduced`` runs the arch's reduced config."""
    from repro_torch.launch.inputs import build_cell

    name = mesh_name(multi_pod, mesh_shape)
    tag = tag + ("__reduced" if reduced else "")
    out_path = out_dir / name / f"{arch}__{shape}{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    out_path.parent.mkdir(parents=True, exist_ok=True)
    quiet()
    t0 = time.time()
    mesh = fake_mesh(multi_pod, mesh_shape)
    chips = mesh.size()
    cfg = None
    if reduced:
        from repro_torch.configs import get_reduced
        from repro_torch.launch.inputs import cell_config

        cfg = cell_config(arch, shape, mesh, base=get_reduced(arch))
    cell = build_cell(arch, shape, mesh, cfg=cfg)
    build_s = time.time() - t0
    counted = analyze_cell(cell, mesh, chips, shape)
    record = {
        "arch": arch, "shape": shape, "mesh": name,
        "chips": chips, "kind": cell.meta["kind"],
        "meta": {k: v for k, v in cell.meta.items() if k != "rules"},
        "rules": cell.meta["rules"],
        **{k: v for k, v in counted.items() if k != "run_s"},
        "timings": {"build_s": build_s, "run_s": counted["run_s"]},
    }
    out_path.write_text(json.dumps(record, indent=1))
    return record


def summary(rec: dict) -> str:
    rl = rec["roofline"]
    return (f"{rec['per_device_bytes'] / 1e9:.2f} GB/GPU, "
            f"{rec['hlo']['dot_flops_per_chip'] / 1e12:.2f} TFLOP/GPU, "
            f"{sum(rec['hlo']['collective_bytes'].values()) / 1e9:.2f} GB "
            f"collectives, dom={rl['dominant']}, "
            f"frac={rl['roofline_fraction']:.3f}, "
            f"run={rec['timings']['run_s']:.0f}s")


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (a quick check)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="a (data, model) mesh instead of the production "
                         "one, e.g. 2x4")
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(n) for n in args.mesh.split("x")) \
        if args.mesh else None

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        todo = [(a, s) for a in ARCHS for s in SHAPES if applicable(a, s)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape)]

    failures, records = [], []
    for multi_pod in meshes:
        tag = mesh_name(multi_pod, mesh_shape)
        for a, s in todo:
            try:
                rec = run_cell(a, s, multi_pod=multi_pod, force=args.force,
                               mesh_shape=mesh_shape, reduced=args.reduced)
                print(f"[OK] {tag} {a} x {s}: {summary(rec)}", flush=True)
                records.append(rec)
            except Exception as e:  # noqa: BLE001
                failures.append((tag, a, s, repr(e)))
                print(f"[FAIL] {tag} {a} x {s}: {e!r}", flush=True)
                traceback.print_exc()
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()    # leave the caller no fake group
    if failures:
        raise SystemExit(f"{len(failures)} cell(s) failed: "
                         f"{[(t, a, s) for t, a, s, _ in failures]}")
    return records

if __name__ == "__main__":
    main()
