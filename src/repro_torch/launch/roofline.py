"""Assemble the roofline table from the dry run's JSON records.

Port of ``repro/launch/roofline.py``: the records of
``launch/dryrun.py`` (``build/dryrun_torch/<mesh>/``), priced on the
H100 constants of ``launch/costs.py``, with per-GPU bytes as the dry run
counted them (there is no XLA-CPU upcast to take out, so no estimate
column).

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod16x16]
Writes build/dryrun_torch/roofline_table_<mesh>.md and prints it.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch.dryrun import OUT_DIR

NOTES = {
    "compute": "more useful flops/GPU (bigger per-GPU tile, less "
               "dispatch/remat overhead)",
    "memory": "cut HBM traffic (fuse, bf16 state, smaller temps)",
    "collective": "overlap or shrink collectives (schedule search, bf16 "
                  "sync, fewer reshards)",
}


def load(mesh: str, variants: bool = False,
         out_dir: pathlib.Path = OUT_DIR) -> list[dict]:
    """Baseline cells (arch__shape.json); variants carry an extra
    __tag suffix and are listed separately."""
    recs = []
    for f in sorted((out_dir / mesh).glob("*.json")):
        is_variant = f.stem.count("__") > 1
        if is_variant != variants:
            continue
        rec = json.loads(f.read_text())
        if variants:
            rec["tag"] = f.stem.split("__", 2)[2]
        recs.append(rec)
    return recs


def render(recs: list[dict], mesh: str) -> str:
    rows = [
        f"### Roofline — {mesh} "
        f"({recs[0]['chips'] if recs else '?'} GPUs, H100 data sheet)",
        "",
        "| arch | shape | kind | GB/GPU | compute_s | memory_s | "
        "collective_s | dominant | MODEL/program | roofline frac | "
        "bottleneck note |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        rl = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {r['per_device_bytes'] / 1e9:.2f} "
            f"| {rl['compute_s']:.3g} | {rl['memory_s']:.3g} "
            f"| {rl['collective_s']:.3g} | {rl['dominant']} "
            f"| {rl['model_flops_ratio']:.2f} "
            f"| {rl['roofline_fraction']:.3f} | {NOTES[rl['dominant']]} |")
    return "\n".join(rows)


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod16x16")
    args = ap.parse_args(argv)
    table = render(load(args.mesh), args.mesh)
    var = load(args.mesh, variants=True)
    if var:
        table += ("\n\n### Variants\n\n"
                  "| arch | shape | variant | compute_s | collective_s | "
                  "roofline frac |\n|---|---|---|---|---|---|\n")
        for r in var:
            rl = r["roofline"]
            table += (f"| {r['arch']} | {r['shape']} | {r['tag']} "
                      f"| {rl['compute_s']:.3g} | {rl['collective_s']:.3g} "
                      f"| {rl['roofline_fraction']:.3f} |\n")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / f"roofline_table_{args.mesh}.md").write_text(table + "\n")
    print(table)
    return table


if __name__ == "__main__":
    main()
