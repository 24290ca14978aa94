"""3-D halo exchange, the paper's named future-work target (§VI):
per-face Pack/Send/Recv/Wait/boundary-update vertices, an
overlap-friendly Inner bulk update, MCTS over (order x stream) under the
analytic machine model, and decision-tree design rules.

The port's counterpart of ``examples/halo3d.py``, with the same flags
and the same prints. ``halo3d_dag`` has no op implementations (nor has
the JAX package's), so the search is analytic and needs no device: its
times are the model's, not measurements. By default the model holds the
H100's constants (``repro_torch.core.costmodel.Machine()``);
``--machine reference`` holds the JAX package's analytic defaults
instead (``REFERENCE_MACHINE``), under which this example prints what
``examples/halo3d.py`` prints.

Usage: PYTHONPATH=src python examples/torch_halo3d.py [--iters 1500]
           [--streams 2] [--machine h100|reference]
"""
import argparse

import numpy as np

import repro_torch.core as C
from repro_torch.core.dag import halo3d_dag
from repro_torch.search import MCTSSearch, run_search

# The JAX package's Machine() defaults (repro/core/costmodel.py):
# TPU-v5e-like data-sheet figures, not a measurement of anything the
# port runs on. Only for holding this example to examples/halo3d.py.
REFERENCE_MACHINE = C.Machine(
    flops_per_s=197e12, hbm_bytes_per_s=819e9, link_bytes_per_s=50e9,
    launch_overhead_s=5e-6, cpu_op_s=1e-6, sync_op_s=0.5e-6,
    comm_latency_s=5e-6)
MACHINES = {"h100": C.Machine(), "reference": REFERENCE_MACHINE}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--machine", choices=sorted(MACHINES), default="h100")
    args = ap.parse_args()

    graph = halo3d_dag()
    print(f"3-D halo DAG: {graph.n_vertices()} vertices "
          f"({len(graph.gpu_ops())} GPU ops, 6 faces + Inner)")

    res = run_search(graph, MCTSSearch(graph, args.streams, seed=0),
                     budget=args.iters, batch_size=1, backend="sim",
                     machine=MACHINES[args.machine])
    times = np.array(res.times)
    best = res.schedules[int(np.argmin(times))]
    print(f"explored {len(res.schedules)} schedules; "
          f"spread {times.max() / times.min():.2f}x "
          f"({times.min() * 1e6:.1f}..{times.max() * 1e6:.1f} us)")

    # Where does Inner land in the best schedule? (the overlap window)
    order = best.order()
    n_before = sum(1 for n in order[:order.index("Inner")]
                   if n.startswith("PostSend"))
    print(f"best schedule posts {n_before}/6 sends before launching "
          f"Inner (communication window opened first)")

    labels = C.label_times(times)
    fm = C.featurize(graph, res.schedules)
    tree = C.algorithm1(fm.X, labels.labels)
    rulesets = C.extract_rulesets(tree, fm.features)
    print(f"\n{labels.n_classes} classes; design rules:")
    print(C.render_rules_table(C.rules_by_class(rulesets), top_k=1))


if __name__ == "__main__":
    main()
