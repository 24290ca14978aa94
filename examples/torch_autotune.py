"""Autotune one of the port's hand-written kernels on the card.

  make_space -> make_evaluator("wallclock") -> MCTS -> distill

Every candidate block configuration is gated against the kernel's
reference and timed on the device (median of ``--repeats`` calls, the
device drained on both sides of the host clock); the times are
distilled into block-size design rules. ``--store`` keeps the
measurements in a file, so a second run replays them without measuring.

Usage: PYTHONPATH=src python examples/torch_autotune.py \
           [--space flash_attention] [--iters 32] [--store FILE] \
           [--rules FILE] [--set batch=1 --set heads=40 ...]
       PYTHONPATH=src python examples/torch_autotune.py --device cpu \
           --space flash_attention --set heads=1 --set seq=64 \
           --set head_dim=16            (a small rehearsal on the CPU)

The default instance of ``flash_attention`` is one attention layer of
qwen2.5-32b (40 heads of dim 128) at the train_4k length (4096), float32,
causal; ``--set`` overrides any factory argument.
"""
import argparse
import ast

import numpy as np
import torch

from repro_torch.engine import make_evaluator
from repro_torch.rules import distill
from repro_torch.search import MCTSSearch, run_search
from repro_torch.space import SPACES, make_space

DEFAULTS = {
    "flash_attention": {"batch": 1, "heads": 40, "seq": 4096,
                        "head_dim": 128},
    "spmv_mulsum": {"n": 150_000, "k": 10},
    "pack": {"n": 150_000, "m": 150_000},
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--space", default="flash_attention",
                    choices=sorted(n for n in SPACES if n in DEFAULTS))
    ap.add_argument("--iters", type=int, default=32,
                    help="MCTS proposals (the grid is exhausted earlier)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--store", default=None,
                    help="evaluation store file (warm starts)")
    ap.add_argument("--rules", default=None,
                    help="write the rules report to this file")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--atol", type=float, default=1e-5,
                    help="value gate's absolute tolerance (float32 "
                         "attention over 4096 keys differs by a few 1e-6 "
                         "between summation orders)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="override a factory argument (Python literal)")
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kwargs = dict(DEFAULTS[args.space])
    for item in args.set:
        name, _, value = item.partition("=")
        kwargs[name] = ast.literal_eval(value)

    space = make_space(args.space, device=args.device, seed=args.seed,
                       **kwargs)
    print(f"design space {space.name!r}: {space.signature}, "
          f"{space.n_candidates()} candidates over "
          f"{[n for n, _ in space.dims]}")
    ev = make_evaluator(space, "wallclock", repeats=args.repeats,
                        warmup=args.warmup, atol=args.atol,
                        device=args.device, store_path=args.store)
    with ev:
        res = run_search(space, MCTSSearch(space, seed=args.seed), ev,
                         budget=args.iters)
    print(f"{ev.objective_key()}")
    print(f"{len(res.schedules)} candidates ({ev.n_checked} gated; "
          f"{res.cache_misses} measured, {res.store_hits} from the store)")
    times = res.times_array()
    for cand, t in sorted(zip(res.schedules, times), key=lambda p: p[1]):
        print(f"  {space.describe(cand):28s} {t * 1e3:10.3f} ms")
    best, t_best = res.best()
    print(f"best parameters: {space.describe(best)} "
          f"({t_best * 1e3:.3f} ms; spread "
          f"{times.max() / times.min():.2f}x)")
    if len(res.schedules) >= 2:
        report = distill(res)
        print(f"{report.labeling.n_classes} classes, sizes "
              f"{np.bincount(report.labeling.labels).tolist()}")
        print(report.render())
        if args.rules:
            report.write(args.rules)


if __name__ == "__main__":
    main()
