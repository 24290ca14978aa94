"""Is a schedule's measured time signal or host jitter, under each
measurement protocol, and does the H100 machine model rank the
schedules as the card does?

Measures every schedule of the SpMV DAG (2 streams, 280 of them) at the
paper's size several times in one process under one or more protocols
of :class:`~repro_torch.engine.wallclock.ExecutorEvaluator`:

  * ``--median``: the median of ``--repeats`` calls, each between two
    drains of the device (the evaluator's ``t_measure_s=None``);
  * ``--paired``: the same, but every timed call of a schedule is
    followed by one of the reference schedule (topological order, one
    stream), and a sample is the ratio of the two, scaled by the
    reference's median time measured at the start: a drift of the
    host's speed that both calls share cancels;
  * ``--t-measure S [S ...]``: the paper's §III-C3 protocol, the median
    of ``--windows`` windows of S seconds, each the program run back to
    back, elapsed / runs (``t_measure_s=S``).

Without any of the three, ``--median`` alone. Sweeps alternate between
the protocols (sweep k of every protocol before sweep k + 1 of any), and
between forward and reverse enumeration order, so a drift over the run
shows as disagreement. For each protocol it reports

  * per-schedule dispersion: the interquartile range (IQR) of the
    samples behind each median;
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

Then the analytic model: the 280 schedules under the H100
:class:`~repro_torch.core.costmodel.Machine` on
``spmv_dag(rows_per_rank=n/4, nnz_per_rank=nnz/4, value_bytes=4)`` (the
port's float32) through the ``vectorized`` backend, checked bit for bit
against ``sim``; its best/median/worst µs, the host seconds each backend
took for all 280, and, against each protocol's mean of its sweeps'
medians, Spearman ρ and the share of schedules the two put in the same
performance class.

Prints one JSON line per sweep, one summary line per protocol and one
model line; ``--out`` also writes every schedule's medians and IQRs as
JSON, after every sweep, and the model's makespans at the end.

Usage: PYTHONPATH=src python examples/torch_schedule_noise.py \
           [--sweeps 3] [--median] [--paired] [--t-measure 0.01 0.05] \
           [--n 150000 --nnz 1500000] [--out PATH]
       PYTHONPATH=src python examples/torch_schedule_noise.py \
           --device cpu --n 1024 --nnz 8192     (a small rehearsal)
"""
import argparse
import dataclasses
import json
import time

import numpy as np

import repro_torch.core as C
from repro_torch.core.executor import build_runner
from repro_torch.engine import ExecutorEvaluator, make_evaluator
from repro_torch.engine.wallclock import reference_schedule
from repro_torch.rules import label_times
from repro_torch.spmv.distributed import from_reference
from repro_torch.spmv.matrix import band_matrix, partition, stack_partitions

RANKS = 4


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


def summary(med: np.ndarray, iqr: np.ndarray) -> dict:
    """Repeatability of (sweeps, schedules) medians and their IQRs."""
    sweeps = med.shape[0]
    base = label_times(med[0])
    # Sweep 0's class edges: the slowest time of every class but the last.
    edges = np.array([med[0][base.labels == c].max()
                      for c in range(base.n_classes - 1)])
    kept = [[float(np.mean(classify(med[k], edges)[base.labels == c]
                           == c)) for c in range(base.n_classes)]
            for k in range(1, sweeps)]
    gaps = []
    for c in range(base.n_classes - 1):
        lo, hi = med[0][base.labels == c], med[0][base.labels == c + 1]
        gaps.append({"between": [c, c + 1],
                     "gap_us": float(hi.min() - lo.max()),
                     "median_gap_us": float(np.median(hi) - np.median(lo))})
    within = float(np.mean(np.var(med, axis=0)))
    total = float(np.var(med))
    pairs = [(a, b) for a in range(sweeps) for b in range(a + 1, sweeps)]
    rho = {f"{a}-{b}": spearman(med[a], med[b]) for a, b in pairs}
    return {
        "spearman": rho, "spearman_min": min(rho.values()),
        "schedule_variance_share": 1.0 - within / total if total else None,
        "iqr_us_median": float(np.median(iqr)),
        "iqr_us_p90": float(np.percentile(iqr, 90)),
        "sweep0_classes": base.n_classes,
        "sweep0_class_sizes": np.bincount(base.labels).tolist(),
        "class_kept_by_sweep": kept,
        "sweep0_boundaries": gaps}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweeps", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=20,
                    help="calls per schedule under --median and --paired")
    ap.add_argument("--windows", type=int, default=5,
                    help="windows per schedule under --t-measure")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--nnz", type=int, default=1_500_000)
    ap.add_argument("--median", action="store_true",
                    help="the median of --repeats drained calls")
    ap.add_argument("--paired", action="store_true",
                    help="time each call beside one of the reference "
                         "schedule and keep the ratio")
    ap.add_argument("--t-measure", type=float, nargs="+", default=[],
                    metavar="S", help="the paper's protocol: windows of "
                    "S seconds of back-to-back runs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.sweeps < 2:
        ap.error("--sweeps must be at least 2")
    protocols = (["median"] if args.median else []) + \
        (["paired"] if args.paired else []) + \
        [f"t_measure={s}" for s in args.t_measure]
    protocols = protocols or ["median"]

    graph = C.spmv_dag()
    A = band_matrix(n=args.n, nnz=args.nnz, seed=0)
    x = np.random.default_rng(1).standard_normal(args.n).astype(np.float32)
    spmv = from_reference(stack_partitions(partition(A, RANKS)), x,
                          args.device)
    common = dict(impls=spmv.impls(), env=spmv.env(), reset=spmv.poison,
                  warmup=args.warmup, device=args.device,
                  store_tag=spmv.store_tag)
    evs = {p: ExecutorEvaluator(graph, repeats=args.repeats, **common)
           if not p.startswith("t_measure=") else
           ExecutorEvaluator(graph, repeats=args.windows,
                             t_measure_s=float(p.split("=")[1]), **common)
           for p in protocols}
    ev0 = next(iter(evs.values()))
    scheds = list(C.enumerate_schedules(graph, 2))
    runs = [build_runner(graph, s, spmv.impls(), ev0.device) for s in scheds]
    n = len(scheds)
    ref_run = build_runner(graph, reference_schedule(graph), spmv.impls(),
                           ev0.device)
    ref_s = float(np.median([ev0.timed(ref_run) for _ in range(200)]))

    def samples_us(p: str, run) -> np.ndarray:
        ev = evs[p]
        if p != "paired":
            return np.asarray(ev.measure(run)) * 1e6
        for _ in range(args.warmup - 1):
            ev.timed(run)
            ev.timed(ref_run)
        t = np.asarray([(ev.timed(run), ev.timed(ref_run))
                        for _ in range(args.repeats)])
        return t[:, 0] / t[:, 1] * ref_s * 1e6

    med = {p: np.empty((args.sweeps, n)) for p in protocols}
    iqr = {p: np.empty((args.sweeps, n)) for p in protocols}
    wall = {p: [] for p in protocols}

    def dump(sweeps_done: int, **more) -> None:
        """Every finished sweep's medians and IQRs (written after each
        sweep, so a run cut short keeps what it measured)."""
        if args.out:
            with open(args.out, "w") as f:
                json.dump({
                    "schedules": [" ".join(str(i) for i in s.items)
                                  for s in scheds],
                    "sweeps_done": sweeps_done,
                    "median_us": {p: med[p][:sweeps_done].tolist()
                                  for p in protocols},
                    "iqr_us": {p: iqr[p][:sweeps_done].tolist()
                               for p in protocols}, **more}, f)

    for k in range(args.sweeps):
        order = list(range(n)) if k % 2 == 0 else list(range(n))[::-1]
        for p in protocols:
            t0 = time.perf_counter()
            for j in order:
                evs[p].check(runs[j], f"schedule {j}")
                q1, q2, q3 = np.percentile(samples_us(p, runs[j]),
                                           [25, 50, 75])
                med[p][k, j], iqr[p][k, j] = q2, q3 - q1
            wall[p].append(time.perf_counter() - t0)
            m = med[p][k]
            lab = label_times(m)
            print(json.dumps({
                "what": "sweep", "protocol": p, "sweep": k,
                "order": "forward" if k % 2 == 0 else "reverse",
                "platform": ev0.platform, "gated": evs[p].n_checked,
                "wall_s": wall[p][-1],
                "best_us": float(m.min()), "median_us": float(np.median(m)),
                "worst_us": float(m.max()), "spread": float(m.max() / m.min()),
                "iqr_us_median": float(np.median(iqr[p][k])),
                "lag1_autocorr": lag1_autocorr(m[order]),
                "classes": lab.n_classes,
                "class_sizes": np.bincount(lab.labels).tolist()}),
                flush=True)
        dump(k + 1)

    for p in protocols:
        print(json.dumps({
            "what": "summary", "protocol": p, "platform": ev0.platform,
            "objective": evs[p].objective_key(), "n": args.n,
            "nnz": args.nnz, "schedules": n, "sweeps": args.sweeps,
            "reference_us": ref_s * 1e6, "sweep_wall_s": wall[p],
            **summary(med[p], iqr[p])}), flush=True)

    # The analytic model on the same 280 schedules (numpy on the host).
    model_graph = C.spmv_dag(rows_per_rank=args.n // RANKS,
                             nnz_per_rank=args.nnz // RANKS, value_bytes=4)
    t0 = time.perf_counter()
    model = np.asarray(make_evaluator(model_graph, "vectorized")
                       .evaluate(scheds))
    vec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = make_evaluator(model_graph, "sim").evaluate(scheds)
    sim_s = time.perf_counter() - t0
    if model.tolist() != sim:
        raise AssertionError("vectorized and sim disagree")
    mlab = label_times(model)
    # Makespans within a picosecond differ only by the order of float
    # sums: ties. With one distinct makespan rho is undefined (null).
    model_ps = np.round(model * 1e12)
    distinct = len(np.unique(model_ps))
    against = {}
    for p in protocols:
        card = med[p].mean(axis=0)
        clab = label_times(card)
        against[p] = {
            "rho_model_vs_card": spearman(model_ps, card) if distinct > 1
            else None,
            "same_class_share": float(np.mean(mlab.labels == clab.labels)),
            "card_classes": clab.n_classes,
            "card_best_us": float(card.min()),
            "card_median_us": float(np.median(card)),
            "card_worst_us": float(card.max()),
            "card_sweep_wall_s": float(np.mean(wall[p]))}
    print(json.dumps({
        "what": "model", "machine": dataclasses.asdict(ev0.machine),
        "graph": {"rows_per_rank": args.n // RANKS,
                  "nnz_per_rank": args.nnz // RANKS, "value_bytes": 4},
        "sim_equals_vectorized": True,
        "best_us": float(model.min()) * 1e6,
        "median_us": float(np.median(model)) * 1e6,
        "worst_us": float(model.max()) * 1e6,
        "distinct_makespans": distinct, "classes": mlab.n_classes,
        "class_sizes": np.bincount(mlab.labels).tolist(),
        "vectorized_s": vec_s, "sim_s": sim_s, "against": against}),
        flush=True)
    dump(args.sweeps, model_us=(model * 1e6).tolist())

if __name__ == "__main__":
    main()
