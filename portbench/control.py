"""The controls and planted faults that the benchmark's checks must fail,
read at a cell's own size on the card (the tests read them at a size
the CPU holds).

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

prints one JSON line a seed: the numbers the cell compares, for its
control and, for a train cell, for each planted fault and for the
program itself (with the leaves that read the largest gaps). The
control is the plain reference computed in the precision below the one
the configuration states: the SpMV in bfloat16 (float32 stated), the
train step with float8 products (bfloat16 stated). The faults are
planted in the program underneath the step: half of each batch's
labels left out (the loss a mean over the rest), and one leaf's
gradient doubled on its way to the optimizer. A state left unchanged
reads 1 on the change by the measure and needs no run.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness, inputs  # noqa: E402
from portbench.reference import moe_lm, spmv  # noqa: E402


def spmv_control(c: dict, seed: int, device: str) -> dict:
    """y_gap of the bfloat16 product against float64, each rank's rows
    against its own largest |y| (the rank cell's measure) and the whole
    vector's (the search cell's)."""
    vals, cols = inputs.band_matrix(c["n"], c["nnz"], c["half_bandwidth"],
                                    seed)
    x = inputs.vectors(c["n"], 1, seed)[0]
    want = spmv.matvec(vals, cols, x)
    got = spmv.matvec_bf16(vals, cols, x, device=device)
    m = c["n"] // c["ranks"]
    by_rank = [spmv.rel_gap(got[r * m:(r + 1) * m], want[r * m:(r + 1) * m])
               for r in range(c["ranks"])]
    return {"y_gap": spmv.rel_gap(got, want), "y_gap_by_rank": max(by_rank)}


@contextlib.contextmanager
def doubled_gradient(leaf: str):
    """AdamW takes ``leaf``'s gradient doubled."""
    from repro_torch.optim.adamw import AdamW

    step = AdamW.step

    def faulty(self, grads, state, params):
        grads = dict(grads)
        grads[leaf] = grads[leaf] * 2.0
        return step(self, grads, state, params)

    AdamW.step = faulty
    try:
        yield
    finally:
        AdamW.step = step


def half_labels(batch: dict) -> dict:
    """The second half of every row's labels left out."""
    labels = batch["labels"].clone()
    labels[:, labels.shape[1] // 2:] = -1
    return {**batch, "labels": labels}


FAULTS = {"half_batch": (contextlib.nullcontext, half_labels),
          "doubled_gradient": (
              lambda: doubled_gradient("decoder.0.mlp.experts.wi"), None)}


def train_readings(ctx: harness.Context, seed: int, device,
                   faults=FAULTS, detail: int = 6) -> dict:
    """The train cell's readings for the control, each fault and the
    program, each against the float32 reference."""
    import torch

    drv = harness.load_module(ctx.cell.folder / "drivers" / "train_step.py",
                              "portbench_driver_train_step")
    c, t = ctx.config, ctx.traffic
    s = moe_lm.sizes(c)
    shapes = moe_lm.leaf_shapes(s)
    scales = moe_lm.leaf_scales(shapes)
    want = drv.check_steps(seed, t, s, shapes, scales, device)
    out = {"seed": seed, "control": drv.readings(drv.check_steps(
        seed, t, s, shapes, scales, device, precision="fp8"), want)}

    def program(hook=None) -> dict:
        prog = drv.Program(c, shapes, scales, seed, device)
        stream = inputs.TokenStream(seed, t["batch"], t["seq"], s["vocab"],
                                    device)
        got = drv.checked_steps(prog, stream, t, shapes, scales, seed,
                                device, hook)
        del prog
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        return got

    for name, (patch, hook) in faults.items():
        with patch():
            out[name] = drv.readings(program(hook), want)
    got = program()
    out["program"] = drv.readings(got, want)
    # The look: the leaves that read the largest first-gradient gaps,
    # each with its gap, its size and its reference norm over the
    # median leaf's.
    med = statistics.median(want["grad_norms"].values())
    gaps = drv.leaf_gaps(got["grad_norms"], want["grad_norms"])
    out["worst_leaves"] = [
        (k, g, shapes[k], want["grad_norms"][k] / med)
        for k, g in sorted(gaps.items(), key=lambda kv: -kv[1])[:detail]]
    out["losses"] = {"program": got["losses"], "reference": want["losses"]}
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(harness.program_path()))
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        if cell.traffic["driver"] == "train_step":
            ctx = harness.Context(cell, seed, 0.0, False)
            line = train_readings(ctx, seed, "cuda")
        else:
            line = {"seed": seed,
                    "control": spmv_control(cell.config, seed, "cuda")}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
