"""The search driver over measured schedules, with its telemetry.

  DAG -> SurrogateGuided (boosted surrogate) -> pool screened by an
  acquisition -> each chosen schedule gated and timed on real CUDA
  streams -> dataset and histogram sinks -> rules, dense and out of core

The schedules run the distributed SpMV (the paper's size by default: 150
000 rows, 1 500 000 non-zeros, 4 ranks in one process) through the
port's hand-written kernels, under an enabled telemetry registry that
writes a Perfetto trace (open it at https://ui.perfetto.dev).

Usage: PYTHONPATH=src python examples/torch_driver.py [--sim-budget 140]
       PYTHONPATH=src python examples/torch_driver.py --device cpu \
           --n 4096 --nnz 32768        (a small rehearsal on the CPU)
"""
import argparse
import time

import numpy as np

import repro_torch.core as C
from repro_torch import obs
from repro_torch.driver import DatasetSink, HistogramSink, SearchDriver
from repro_torch.engine import ExecutorEvaluator
from repro_torch.search import SurrogateGuided
from repro_torch.spmv.distributed import from_reference
from repro_torch.spmv.matrix import band_matrix, partition, stack_partitions


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--nnz", type=int, default=1_500_000)
    ap.add_argument("--sim-budget", type=int, default=140)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--acquisition", default="expected_improvement")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--trace", default="chiprun_out/driver_trace.json")
    args = ap.parse_args(argv)

    graph = C.spmv_dag()
    A = band_matrix(n=args.n, nnz=args.nnz, seed=0)
    x = np.random.default_rng(1).standard_normal(args.n).astype(np.float32)
    spmv = from_reference(stack_partitions(partition(A, 4)), x, args.device)
    ev = ExecutorEvaluator(graph, impls=spmv.impls(), env=spmv.env(),
                           reset=spmv.poison, repeats=args.repeats,
                           warmup=3, device=args.device,
                           store_tag=spmv.store_tag)
    strategy = SurrogateGuided(graph, 2, seed=0, surrogate="boost")
    dense_sink, ooc_sink = DatasetSink(graph), HistogramSink(graph)

    tel = obs.Telemetry([obs.PerfettoExporter(args.trace)])
    t0 = time.perf_counter()
    with obs.use(tel):
        result = SearchDriver(graph, strategy, ev, budget=None,
                              batch_size=args.batch,
                              sim_budget=args.sim_budget,
                              acquisition=args.acquisition,
                              sinks=[dense_sink, ooc_sink,
                                     "telemetry"]).run()
        dense, ooc = dense_sink.distill(), ooc_sink.distill()
    wall = time.perf_counter() - t0
    tel.close()

    q = strategy.screening_quality()
    print(ev.objective_key())
    print(f"{result.n_proposed} proposed, {result.cache_misses} measured "
          f"({ev.n_checked} passed the value gate), "
          f"{result.store_hits} from a store")
    print(f"surrogate: {q['n_screened']} screened, Spearman rho "
          f"{q['spearman']:.3f} over the {q['n_compared']} it chose")
    print(f"out-of-core rules equal the dense ones: "
          f"{dense.render() == ooc.render()}")
    print(f"{wall:.3f} s of wall; trace in {args.trace}")
    print(tel.summary())
    print()
    print(ooc.render(top_k=2))


if __name__ == "__main__":
    main()
