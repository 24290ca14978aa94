"""Design rules for an LM train step's collective overlap, on H100
constants; or a search over any registered design space.

The LM train step decomposes into an op-DAG (per-layer fwd/bwd compute,
per-layer gradient reduce-scatters, the optimizer update;
:mod:`repro_torch.core.stepdag`). "Streams" are the compute stream and
CUDA streams carrying NCCL-style collectives over NVLink. The search
portfolio (greedy seeding → MCTS refinement → surrogate-screened
exploitation) searches the (emission order x stream assignment) space
under the analytic machine model with the H100 data sheet's constants
(:func:`repro_torch.launch.costs.train_step_machine`), and the decision
tree emits rules like "rs0 before bwd2" or "rs1 different stream than
bwd1". Its times are the model's, not measurements.

With ``--space`` the same pipeline runs over a registered design space
instead: the paper's schedule spaces (``spmv``, ``spmv_fine``,
``halo3d``; analytic, or ``spmv`` measured on the card with
``--backend wallclock``) or the port's kernel parameter grids
(``flash_attention``, ``spmv_mulsum``, ``pack``: measured on the card by
default; ``demo`` is an analytic grid).

Usage: PYTHONPATH=src python examples/torch_schedule_search.py
           [--arch qwen2.5-32b] [--layers 4] [--iters 600]
           [--space spmv|halo3d|flash_attention|...]
           [--strategy portfolio|mcts]
           [--backend sim|vectorized|pool|wallclock|rpc]
           [--hosts host:port,host:port] [--device cuda|cpu]
           [--surrogate ridge|boost]
           [--acquisition argmin_topk|ucb|expected_improvement]
           [--rules [PATH]] [--store PATH]
           [--trace PATH] [--telemetry]

A fleet for ``--backend rpc`` is one or more
``python -m repro_torch.engine.server --space NAME --port 0`` processes
(they serve the registered spaces; the train-step DAG is served only by
in-process :class:`~repro_torch.engine.server.EvalServer` hosts).
"""
import argparse

import repro_torch.rules as R
import repro_torch.search as S
from repro_torch import obs
from repro_torch.core.stepdag import train_step_dag, with_comm_durations
from repro_torch.driver import ACQUISITIONS
from repro_torch.launch.costs import (LINK_BW, PEAK_FLOPS, costs_from_arch,
                                      train_step_machine)
from repro_torch.space import SPACES, ParamSpace, make_space

PAPER_N, PAPER_NNZ, RANKS = 150_000, 1_500_000, 4


def make_target(name: str, channels: int, device):
    try:
        return make_space(name, n_streams=channels)
    except TypeError:  # parameter grids take no n_streams
        try:
            return make_space(name, device=device)
        except TypeError:  # the demo grid takes no device either
            return make_space(name)


def spmv_program_kwargs(device) -> dict:
    """``wallclock`` arguments that run ``spmv``'s schedules on the
    paper's distributed SpMV (150,000 rows, 1,500,000 non-zeros, 4
    ranks in one process) through the port's kernels."""
    import numpy as np

    from repro_torch.spmv.distributed import from_reference
    from repro_torch.spmv.matrix import (band_matrix, partition,
                                         stack_partitions)

    A = band_matrix(n=PAPER_N, nnz=PAPER_NNZ, seed=0)
    x = np.random.default_rng(1).standard_normal(PAPER_N).astype(
        np.float32)
    spmv = from_reference(stack_partitions(partition(A, RANKS)), x, device)
    return {"impls": spmv.impls(), "env": spmv.env(), "reset": spmv.poison,
            "device": device, "store_tag": spmv.store_tag}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-32b")
    ap.add_argument("--layers", type=int, default=4,
                    help="coarse pipeline stages in the DAG")
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--channels", type=int, default=2)
    ap.add_argument("--space", choices=tuple(sorted(SPACES)),
                    default=None,
                    help="search a registered design space "
                         "(repro_torch.space registry) instead of the "
                         "train-step DAG; kernel grids default to the "
                         "wall-clock runner on the card")
    ap.add_argument("--strategy", choices=("portfolio", "mcts"),
                    default="portfolio",
                    help="portfolio = greedy seeding + MCTS refinement "
                         "+ surrogate-screened exploitation "
                         "(graph spaces only; kernel grids always "
                         "use mcts)")
    ap.add_argument("--backend",
                    choices=("sim", "vectorized", "pool", "wallclock",
                             "rpc"),
                    default=None,
                    help="evaluation engine (repro_torch.engine "
                         "registry); the analytic backends are "
                         "bit-identical — a pure throughput choice. "
                         "Default: sim for analytic targets, wallclock "
                         "for kernel grids. wallclock measures kernel "
                         "grids and spmv on the card; rpc requires "
                         "--hosts")
    ap.add_argument("--hosts", default=None, metavar="H:P,H:P",
                    help="comma-separated host:port evaluation servers "
                         "for --backend rpc (each running python -m "
                         "repro_torch.engine.server on a matching "
                         "--space)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu, for wallclock")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="schedules per propose() call; default 1 for "
                         "the sim backend (the paper's strictly "
                         "sequential loop) and 32 for the others, "
                         "which amortize across batches")
    ap.add_argument("--surrogate", choices=tuple(sorted(S.SURROGATES)),
                    default="ridge",
                    help="screening model for the portfolio's "
                         "exploitation phase (repro_torch.search "
                         "surrogate registry; 'boost' = gradient-boosted "
                         "trees)")
    ap.add_argument("--acquisition",
                    choices=tuple(sorted(ACQUISITIONS)),
                    default="argmin_topk",
                    help="how the candidate pool is ranked "
                         "(repro_torch.driver acquisition registry; "
                         "ucb / expected_improvement add the boosted "
                         "ensemble's per-tree uncertainty — pair them "
                         "with --surrogate boost)")
    ap.add_argument("--store", default=None, metavar="PATH",
                    help="persistent content-addressed evaluation "
                         "store (repro_torch.engine.EvalStore): times "
                         "from this run are appended, and a later run on "
                         "the same target and objective replays them "
                         "as store hits")
    ap.add_argument("--rules", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="render the full design-rule report "
                         "(repro_torch.rules.distill) to PATH, or to "
                         "stdout when given without a value")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace-event / Perfetto JSON "
                         "trace of the whole run (driver rounds, "
                         "evaluator batches, store traffic, distill "
                         "stages) to PATH — open it at "
                         "https://ui.perfetto.dev. Trace-enabled runs "
                         "attach an ephemeral evaluation store when "
                         "--store is not given, so the store layer "
                         "shows up in the trace (results are "
                         "byte-identical either way)")
    ap.add_argument("--telemetry", action="store_true",
                    help="print the telemetry summary table (span "
                         "walls, counters, gauges) after the run")
    args = ap.parse_args(argv)

    tel = None
    if args.trace or args.telemetry:
        exporters = [obs.PerfettoExporter(args.trace)] if args.trace \
            else []
        tel = obs.Telemetry(exporters=exporters)
        obs.set_current(tel)
    ephemeral_store = None
    if args.trace and args.store is None:
        # A pure observer: the store holds noiseless base times, and
        # cold runs with a store attached are byte-identical to
        # storeless ones — so a throwaway store is a free way to get
        # store-layer spans into the trace.
        import tempfile
        ephemeral_store = tempfile.mkdtemp(prefix="repro-trace-")
        args.store = f"{ephemeral_store}/trace.evalstore"

    machine = None
    if args.space is not None:
        target = make_target(args.space, args.channels, args.device)
        graph = getattr(target, "graph", None)
        kind = "parameter grid" if isinstance(target, ParamSpace) \
            else "schedule space"
        print(f"design space {target.name!r} ({kind})")
    else:
        costs = costs_from_arch(args.arch, args.layers,
                                tokens_per_chip=16 * 4096 // 16)
        graph = with_comm_durations(train_step_dag(args.layers, costs),
                                    LINK_BW)
        target = graph
        machine = train_step_machine()
        print(f"train-step DAG for {args.arch}: "
              f"{graph.n_vertices()} ops, {args.layers} stages "
              "(H100 data-sheet constants, analytic model)")

    kernel_grid = isinstance(target, ParamSpace) \
        and target.runner is not None
    if args.backend is None:
        args.backend = "wallclock" if kernel_grid else "sim"
    if args.batch_size is None:
        args.batch_size = 1 if args.backend == "sim" else 32
    backend_kwargs = None
    if args.backend == "rpc":
        if not args.hosts:
            ap.error("--backend rpc requires --hosts host:port[,...]")
        hosts = [h.strip() for h in args.hosts.split(",") if h.strip()]
        backend_kwargs = {"hosts": hosts}
        print(f"evaluation fleet: {len(hosts)} host(s) "
              f"({', '.join(hosts)})")
    elif args.hosts:
        ap.error("--hosts only applies to --backend rpc")
    if args.backend == "wallclock":
        if kernel_grid:
            backend_kwargs = {"device": args.device}
        elif args.space == "spmv":
            backend_kwargs = spmv_program_kwargs(args.device)
        else:
            ap.error("--backend wallclock measures the kernel grids and "
                     "spmv; this target has no program to run")

    if args.strategy == "portfolio" and graph is not None:
        strategy = S.PortfolioSearch(graph, args.channels, seed=0,
                                     surrogate=args.surrogate,
                                     acquisition=args.acquisition)
    else:  # graph-less spaces: the space-generic MCTS
        strategy = S.MCTSSearch(target, seed=0) if graph is None \
            else S.MCTSSearch(graph, args.channels, seed=0)
    res = S.run_search(target, strategy, budget=args.iters,
                       backend=args.backend, batch_size=args.batch_size,
                       backend_kwargs=backend_kwargs,
                       store_path=args.store, machine=machine)
    times = res.times_array()
    best, best_t = res.best()
    print(f"explored {len(res.schedules)} candidates "
          f"({res.n_proposed} evaluations, {res.cache_hits} memo hits); "
          f"best {times.min() * 1e3:.4f} ms, "
          f"worst {times.max() * 1e3:.4f} ms "
          f"({times.max() / times.min():.2f}x)")
    if args.store is not None:
        print(f"evaluation store {args.store}: {res.store_hits} warm "
              f"hits, {res.cache_misses} new evaluations appended")
    if args.strategy == "portfolio" and graph is not None:
        q = strategy.screening_quality()
        print(f"surrogate screened {q['n_screened']} candidates "
              f"({q['n_compared']} evaluated; rank corr "
              f"{q['spearman']:.2f})")
    if graph is None:
        print(f"best parameters: {target.describe(best)}")
    else:
        print("best emission order:",
              " ".join(str(i) for i in best.items
                       if i.name not in ("start", "end")))

    report = R.distill(res)
    print(f"\n{report.labeling.n_classes} performance classes; "
          f"design rules:")
    print(R.render_rules_table(report.grouped(), top_k=2))
    if args.rules == "-":
        print("\n" + report.render())
    elif args.rules is not None:
        path = report.write(args.rules)
        print(f"\nfull design-rule report written to {path}")

    if tel is not None:
        if args.telemetry:
            print("\n" + tel.summary())
        if res.telemetry:
            r_last = res.telemetry[-1]
            print(f"\ntelemetry: {len(res.telemetry)} driver rounds; "
                  f"final round {r_last['round']} "
                  f"(best {r_last['best'] * 1e6:.2f} us, "
                  f"{r_last['misses']} misses)")
        tel.close()
        if args.trace:
            print(f"trace written to {args.trace} — open it at "
                  "https://ui.perfetto.dev")
        obs.set_current(None)
    if ephemeral_store is not None:
        import shutil
        shutil.rmtree(ephemeral_store, ignore_errors=True)

    # Roofline context for the fastest train-step schedule.
    if args.space is None:
        total_flops = sum(op.flops for op in graph.ops.values())
        print(f"\ncompute-only bound "
              f"{total_flops / PEAK_FLOPS * 1e3:.4f} ms at the H100 data "
              f"sheet's bf16 peak; best overlap schedule "
              f"{times.min() * 1e3:.4f} ms "
              f"({total_flops / PEAK_FLOPS / times.min():.0%} of peak; "
              "analytic model, not a measurement)")


if __name__ == "__main__":
    main()
