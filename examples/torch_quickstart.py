"""Quickstart on the card: the paper's loop with measured times.

  DAG -> MCTS -> each schedule run on real CUDA streams and events and
  timed -> labels -> features -> decision tree -> design rules

The schedules run the distributed SpMV at the paper's size (150 000
rows, 1 500 000 non-zeros, 4 ranks in one process) through the port's
hand-written kernels.

Usage: PYTHONPATH=src python examples/torch_quickstart.py [--iters 400]
       PYTHONPATH=src python examples/torch_quickstart.py --device cpu \
           --n 1024 --nnz 8192        (a small rehearsal on the CPU)
"""
import argparse

import numpy as np

import repro_torch.core as C
from repro_torch.engine import ExecutorEvaluator
from repro_torch.rules import (algorithm1, extract_rulesets, label_times,
                               render_rules_table, rules_by_class)
from repro_torch.search import MCTSSearch, run_search
from repro_torch.spmv.distributed import from_reference
from repro_torch.spmv.matrix import band_matrix, partition, stack_partitions


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--nnz", type=int, default=1_500_000)
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv)

    # 1. The program: the paper's distributed SpMV, as an op DAG, and
    #    its data on the device (4 ranks' buffers in one process).
    graph = C.spmv_dag()
    A = band_matrix(n=args.n, nnz=args.nnz, seed=0)
    x = np.random.default_rng(1).standard_normal(args.n).astype(np.float32)
    spmv = from_reference(stack_partitions(partition(A, 4)), x, args.device)

    # 2. Explore the (ordering x stream assignment) space with MCTS; each
    #    schedule is value-checked, then timed on the device.
    ev = ExecutorEvaluator(graph, impls=spmv.impls(), env=spmv.env(),
                           reset=spmv.poison, repeats=args.repeats,
                           warmup=3, device=args.device,
                           store_tag=spmv.store_tag)
    result = run_search(graph, MCTSSearch(graph, 2, seed=0), ev,
                        budget=args.iters, batch_size=1)
    times = result.times_array()
    print(f"{ev.objective_key()}")
    print(f"explored {len(result.schedules)} implementations "
          f"({ev.n_checked} passed the value gate); "
          f"spread {times.max() / times.min():.2f}x "
          f"({times.min() * 1e6:.1f}us .. {times.max() * 1e6:.1f}us)")

    # 3. Class labels from the sorted measurements (Fig. 4).
    labels = label_times(times)
    print(f"{labels.n_classes} performance classes, "
          f"sizes {np.bincount(labels.labels).tolist()}")

    # 4. Feature vectors + decision tree (Alg. 1).
    fm = C.featurize(graph, result.schedules)
    tree = algorithm1(fm.X, labels.labels)
    print(f"tree: {tree.n_leaves()} leaves, depth {tree.depth()}, "
          f"train error {tree.training_error(fm.X, labels.labels):.3f}")

    # 5. Design rules per performance class (Tables VI-VIII).
    print()
    print(render_rules_table(
        rules_by_class(extract_rulesets(tree, fm.features)), top_k=2))


if __name__ == "__main__":
    main()
