"""Is a schedule's measured time signal or host jitter?

Measures every schedule of the SpMV DAG (2 streams, 280 of them) at the
paper's size several times in one process, with the same evaluator
settings as the main path (``repeats`` timed calls, median kept):
sweeps alternate forward and reverse enumeration order, so a drift over
the run shows as disagreement between them. Reports

  * per-schedule dispersion: the interquartile range (IQR) of the
    ``repeats`` samples behind each median;
  * the lag-1 autocorrelation of the medians in the order they were
    measured: near 0 when each schedule's time is its own, near 1 when
    the time drifts slowly and neighbours in the run share its level;
  * the Spearman rank correlation of the medians of every two sweeps;
  * the schedules' share of the variance of the medians (1 - mean
    within-schedule variance across sweeps / total variance);
  * the performance classes (:func:`label_times`) of each sweep and, for
    each class of sweep 0, the share of its schedules that the other
    sweeps' times put in the same class under sweep 0's class edges;
  * for each class boundary of sweep 0, the gap between the two classes
    beside the median per-schedule IQR.

With ``--paired`` every timed call of a schedule is followed by one of
the reference schedule (topological order, one stream), and a sample is
the ratio of the two, scaled by the reference's median time measured at
the start: a drift of the host's speed that both calls share cancels.

Prints one JSON line per sweep and one summary line; ``--out`` also
writes every schedule's medians and IQRs as JSON.

Usage: PYTHONPATH=src python examples/torch_schedule_noise.py \
           [--sweeps 3] [--repeats 20] [--paired] [--out PATH]
       PYTHONPATH=src python examples/torch_schedule_noise.py \
           --device cpu --n 1024 --nnz 8192     (a small rehearsal)
"""
import argparse
import json

import numpy as np

import repro_torch.core as C
from repro_torch.core.executor import build_runner
from repro_torch.engine import ExecutorEvaluator
from repro_torch.engine.wallclock import reference_schedule
from repro_torch.rules import label_times
from repro_torch.spmv.distributed import from_reference
from repro_torch.spmv.matrix import band_matrix, partition, stack_partitions


def ranks(a: np.ndarray) -> np.ndarray:
    """Ranks 0..n-1, ties given their mean rank."""
    order = np.argsort(a, kind="stable")
    r = np.empty(len(a), dtype=np.float64)
    r[order] = np.arange(len(a), dtype=np.float64)
    for v in np.unique(a):
        tied = a == v
        if tied.sum() > 1:
            r[tied] = r[tied].mean()
    return r


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.corrcoef(ranks(a), ranks(b))[0, 1])


def lag1_autocorr(a: np.ndarray) -> float:
    d = a - a.mean()
    return float((d[1:] * d[:-1]).mean() / d.var()) if d.var() else 0.0


def classify(times: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Class of each time under upper class edges (ascending)."""
    return np.searchsorted(edges, times, side="left")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweeps", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--nnz", type=int, default=1_500_000)
    ap.add_argument("--paired", action="store_true",
                    help="time each call beside one of the reference "
                         "schedule and keep the ratio")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.sweeps < 2:
        ap.error("--sweeps must be at least 2")

    graph = C.spmv_dag()
    A = band_matrix(n=args.n, nnz=args.nnz, seed=0)
    x = np.random.default_rng(1).standard_normal(args.n).astype(np.float32)
    spmv = from_reference(stack_partitions(partition(A, 4)), x, args.device)
    ev = ExecutorEvaluator(graph, impls=spmv.impls(), env=spmv.env(),
                           reset=spmv.poison, repeats=args.repeats,
                           warmup=args.warmup, device=args.device,
                           store_tag=spmv.store_tag)
    scheds = list(C.enumerate_schedules(graph, 2))
    runs = [build_runner(graph, s, spmv.impls(), ev.device) for s in scheds]
    n = len(scheds)
    ref_run = build_runner(graph, reference_schedule(graph), spmv.impls(),
                           ev.device)
    ref_s = float(np.median([ev.timed(ref_run) for _ in range(200)]))

    def samples_us(run) -> np.ndarray:
        if not args.paired:
            return np.asarray(ev.measure(run)) * 1e6
        for _ in range(args.warmup - 1):
            ev.timed(run)
            ev.timed(ref_run)
        t = np.asarray([(ev.timed(run), ev.timed(ref_run))
                        for _ in range(args.repeats)])
        return t[:, 0] / t[:, 1] * ref_s * 1e6

    med = np.empty((args.sweeps, n))
    iqr = np.empty((args.sweeps, n))
    for k in range(args.sweeps):
        order = list(range(n)) if k % 2 == 0 else list(range(n))[::-1]
        for j in order:
            ev.check(runs[j], f"schedule {j}")
            samples = samples_us(runs[j])
            q1, q2, q3 = np.percentile(samples, [25, 50, 75])
            med[k, j], iqr[k, j] = q2, q3 - q1
        lab = label_times(med[k])
        print(json.dumps({
            "what": "sweep", "sweep": k,
            "order": "forward" if k % 2 == 0 else "reverse",
            "platform": ev.platform, "gated": ev.n_checked,
            "best_us": float(med[k].min()),
            "median_us": float(np.median(med[k])),
            "worst_us": float(med[k].max()),
            "spread": float(med[k].max() / med[k].min()),
            "lag1_autocorr": lag1_autocorr(med[k][order]),
            "iqr_us_median": float(np.median(iqr[k])),
            "iqr_us_p90": float(np.percentile(iqr[k], 90)),
            "classes": lab.n_classes,
            "class_sizes": np.bincount(lab.labels).tolist()}), flush=True)

    base = label_times(med[0])
    # Sweep 0's class edges: the slowest time of every class but the last.
    edges = np.array([med[0][base.labels == c].max()
                      for c in range(base.n_classes - 1)])
    kept = [[float(np.mean(classify(med[k], edges)[base.labels == c]
                           == c)) for c in range(base.n_classes)]
            for k in range(1, args.sweeps)]
    gaps = []
    for c in range(base.n_classes - 1):
        lo, hi = med[0][base.labels == c], med[0][base.labels == c + 1]
        gaps.append({"between": [c, c + 1],
                     "gap_us": float(hi.min() - lo.max()),
                     "median_gap_us": float(np.median(hi) - np.median(lo))})
    within = float(np.mean(np.var(med, axis=0)))
    total = float(np.var(med))
    pairs = [(a, b) for a in range(args.sweeps)
             for b in range(a + 1, args.sweeps)]
    print(json.dumps({
        "what": "summary", "platform": ev.platform,
        "objective": ev.objective_key(), "schedules": n,
        "sweeps": args.sweeps, "paired": args.paired,
        "reference_us": ref_s * 1e6,
        "spearman": {f"{a}-{b}": spearman(med[a], med[b])
                     for a, b in pairs},
        "schedule_variance_share": 1.0 - within / total if total else None,
        "iqr_us_median": float(np.median(iqr)),
        "iqr_us_p90": float(np.percentile(iqr, 90)),
        "sweep0_classes": base.n_classes,
        "sweep0_class_sizes": np.bincount(base.labels).tolist(),
        "class_kept_by_sweep": kept,
        "sweep0_boundaries": gaps}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"schedules": [" ".join(str(i) for i in s.items)
                                     for s in scheds],
                       "median_us": med.tolist(), "iqr_us": iqr.tolist()},
                      f)


if __name__ == "__main__":
    main()
