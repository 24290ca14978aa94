"""Search result -> rendered design rules, as one call.

:func:`distill` labels the times, featurizes the candidates through
their design space (order/stream pairs for schedule spaces, threshold
features such as ``block_q >= 64`` for kernel parameter spaces), runs
Algorithm 1, and extracts the rulesets::

    res = run_search(space, MCTSSearch(space), budget=...)
    report = distill(res)                      # -> RuleReport
    print(report.render())

with the paper's evaluation hooks as keyword arguments: a pluggable
``labeler``, a ``canonical`` report or ruleset list to annotate against
(§V over/under-constraint marks), and a ``full_space`` of (candidates,
times) for the Table-V class-range accuracy, optionally widened by
``range_widen``.

Two streamed-corpus seams: ``features=`` takes a feature matrix already
folded by a :class:`repro_torch.driver.DatasetSink` (the featurize stage
is skipped), and ``histograms=`` a :class:`repro_torch.driver.
HistogramSink` whose matrix is never materialized (the tree grows from
blockwise class-count histograms, bit for bit the dense tree). Every
stage is a ``rules.<stage>`` telemetry span inside ``rules.distill``
(:mod:`repro_torch.obs`) and a ``stage_seconds`` entry.

``distill`` is duck-typed: it needs ``.schedules``, ``.times`` and a
design space (``.design_space()`` / ``.space`` / ``.graph``). The JAX
package's ``repro/rules/pipeline.py`` with its imports rewritten.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Callable, Sequence, TYPE_CHECKING

import numpy as np

from repro_torch import obs
from repro_torch.core.features import FeatureMatrix
from repro_torch.rules.labels import Labeling, label_times
from repro_torch.rules.rulesets import (RuleSet, annotate_vs_canonical,
                                        class_range_accuracy, extract_rulesets,
                                        render_rules_table, rules_by_class)
from repro_torch.rules.trees import (DecisionTree, HistogramGrower,
                                     TreeSearchTrace, algorithm1,
                                     algorithm1_from_histograms)
from repro_torch.space.base import DesignSpace, as_space

if TYPE_CHECKING:  # pragma: no cover - typing only, no runtime dep
    from repro_torch.core.dag import Graph, Schedule
    from repro_torch.search.pipeline import SearchResult


def _space_of(result) -> DesignSpace:
    """The corpus's design space, however the result spells it.

    ``SearchResult`` carries ``design_space()``; other duck-typed
    corpora may expose a ``.space`` attribute or just a ``.graph``
    (normalized through :func:`~repro_torch.space.base.as_space`).
    """
    ds = getattr(result, "design_space", None)
    if callable(ds):
        return ds()
    sp = getattr(result, "space", None)
    if isinstance(sp, DesignSpace):
        return sp
    return as_space(result.graph)


@dataclasses.dataclass
class RuleReport:
    """Everything the labels -> tree -> rules pipeline produced."""

    graph: "Graph | None"          # None for graph-less (parameter) spaces
    feature_matrix: FeatureMatrix
    labeling: Labeling
    tree: DecisionTree
    trace: TreeSearchTrace
    rulesets: list[RuleSet]
    n_schedules: int
    training_error: float
    class_range_acc: float | None = None   # Table V, when full_space given
    annotated: bool = False                # §V marks vs a canonical report
    stage_seconds: dict = dataclasses.field(default_factory=dict)
    """Wall seconds per pipeline stage (label/featurize/tree/rules/
    accuracy) — so benchmark rows can keep attributing time to the
    stage they are about."""

    def grouped(self) -> dict[int, list[RuleSet]]:
        return rules_by_class(self.rulesets)

    def summary(self) -> dict:
        """Flat stats dict (benchmark rows, smoke assertions)."""
        out = {
            "n_schedules": self.n_schedules,
            "n_classes": self.labeling.n_classes,
            "n_features": len(self.feature_matrix.features),
            "n_rulesets": len(self.rulesets),
            "n_leaves": self.tree.n_leaves(),
            "tree_depth": self.tree.depth(),
            "training_error": self.training_error,
            "algorithm1_trials": len(self.trace.max_leaf_nodes),
        }
        if self.annotated:
            out["n_overconstrained"] = sum(
                bool(rs.extraneous) for rs in self.rulesets)
            out["n_underconstrained"] = sum(
                rs.insufficient for rs in self.rulesets)
        if self.class_range_acc is not None:
            out["class_range_acc"] = self.class_range_acc
        return out

    def render(self, top_k: int = 3) -> str:
        """Markdown report: corpus stats, class ranges, rule tables."""
        s = self.summary()
        lines = [
            "# design-rule report",
            "",
            f"- schedules: {s['n_schedules']} "
            f"({s['n_features']} features, "
            f"{s['n_classes']} performance classes)",
            f"- tree: {s['n_leaves']} leaves, depth {s['tree_depth']}, "
            f"training error {s['training_error']:.4f} "
            f"({s['algorithm1_trials']} Algorithm-1 trials)",
        ]
        if self.class_range_acc is not None:
            lines.append(f"- class-range accuracy (full space): "
                         f"{self.class_range_acc:.3f}")
        if self.annotated:
            lines.append(
                f"- vs canonical rules: "
                f"{s['n_overconstrained']} overconstrained, "
                f"{s['n_underconstrained']} underconstrained rulesets")
        lines.append("")
        for c, (lo, hi) in enumerate(self.labeling.class_ranges()):
            lines.append(f"- class {c + 1} time range: "
                         f"[{lo * 1e6:.2f}, {hi * 1e6:.2f}] us")
        lines.append("")
        lines.append(render_rules_table(self.grouped(), top_k=top_k))
        return "\n".join(lines) + "\n"

    def write(self, path, top_k: int = 3) -> pathlib.Path:
        """Render to an explicit path (no hidden side-effect writes)."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.render(top_k=top_k))
        return path


def distill(result: "SearchResult",
            labeler: Callable[[np.ndarray], Labeling] = label_times,
            canonical: "RuleReport | list[RuleSet] | None" = None,
            full_space: "tuple[Sequence[Schedule], np.ndarray] | None"
            = None,
            range_widen: float = 0.0,
            features: FeatureMatrix | None = None,
            histograms=None) -> RuleReport:
    """Label -> featurize -> Algorithm 1 -> rulesets, as one call.

    ``labeler`` maps the observed times to a :class:`Labeling`
    (defaults to the paper's §IV-A convolution labeling; pass e.g.
    ``functools.partial(label_times, prominence_percentile=95)`` or any
    custom labeler). ``canonical`` annotates the extracted rulesets
    against a reference report's rulesets (§V). ``full_space`` is a
    (schedules, times) pair covering the whole design space; when
    given, the Table-V class-range accuracy is computed by classifying
    the full space in this report's feature basis, with each class's
    (lo, hi) time range widened to (lo*(1-w), hi*(1+w)) for
    ``range_widen=w`` (noise-dosed measurements).

    ``features`` is the streaming-corpus hook: a pre-built
    :class:`FeatureMatrix` for ``result.schedules`` (row i =
    schedule i), e.g. the incrementally folded matrix of a
    :class:`repro_torch.driver.DatasetSink`. When given, the featurize
    stage is skipped entirely — the sync-expansion work was already paid
    when the schedules streamed in. Only that stage is saved: the
    label, tree, and rules stages still scale with the whole corpus.

    ``histograms`` is the out-of-core hook: a streamed-corpus handle
    (a :class:`repro_torch.driver.HistogramSink`, or anything exposing
    ``n_rows`` / ``feature_list()`` / ``value_grids()`` /
    ``blocks()``) whose feature matrix is *never* materialized. The
    tree stage then runs Algorithm 1 through
    :class:`repro_torch.rules.trees.HistogramGrower` — one blockwise
    pass per tree level, O(features x bins) extra memory — and produces the
    same tree, rulesets, and training error bit for bit as the dense
    path (locked by test); the report's ``feature_matrix`` carries the
    pruned feature list over a 0-row ``X``. Mutually exclusive with
    ``features`` and ``full_space``.
    """
    if histograms is not None and features is not None:
        raise ValueError(
            "pass features= (dense streamed matrix) or histograms= "
            "(out-of-core), not both")
    if histograms is not None and full_space is not None:
        raise ValueError(
            "full_space= accuracy needs the in-memory feature path; "
            "it cannot be combined with histograms=")
    stage_seconds: dict[str, float] = {}
    scheds = getattr(result, "schedules", None)
    n_rows = len(scheds) if scheds is not None else len(result.times)
    distill_span = obs.span("rules.distill", n_schedules=n_rows)
    distill_span.__enter__()

    def staged(name, fn):
        # Each stage is both a rules.<stage> telemetry span and a
        # stage_seconds entry (the tests read the dict).
        with obs.span(f"rules.{name}"):
            t0 = time.perf_counter()
            out = fn()
            stage_seconds[name] = time.perf_counter() - t0
        return out

    try:
        return _distill_staged(result, labeler, canonical, full_space,
                               range_widen, features, histograms, staged,
                               stage_seconds)
    finally:
        distill_span.__exit__(None, None, None)


def _distill_staged(result, labeler, canonical, full_space, range_widen,
                    features, histograms, staged, stage_seconds):
    times = np.asarray(result.times, dtype=np.float64)
    labeling = staged("label", lambda: labeler(times))
    grower = None
    if histograms is not None:
        if histograms.n_rows != len(times):
            raise ValueError(
                f"histogram corpus has {histograms.n_rows} rows but "
                f"the result has {len(times)} times — the streamed "
                "corpus must cover exactly the result's observations")
        # The pruned feature list is the histogram path's "featurize":
        # discovery is a blockwise min/max fold, never a matrix.
        feats = staged("featurize", histograms.feature_list)
        fm = FeatureMatrix(feats,
                           np.zeros((0, len(feats)), dtype=np.int8))
    elif features is not None:
        if features.X.shape[0] != len(result.schedules):
            raise ValueError(
                f"features has {features.X.shape[0]} rows but the "
                f"corpus has {len(result.schedules)} schedules — the "
                "matrix must cover exactly the result's schedule list")
        fm = features
    else:
        sp = _space_of(result)
        fm = staged("featurize",
                    lambda: sp.featurize(list(result.schedules)))
    trace = TreeSearchTrace([], [], [])
    if histograms is not None:
        def fit_tree():
            nonlocal grower
            grower = HistogramGrower(histograms.blocks, labeling.labels,
                                     values=histograms.value_grids())
            return algorithm1_from_histograms(
                histograms.blocks, labeling.labels, trace=trace,
                grower=grower)
        tree = staged("tree", fit_tree)
    else:
        tree = staged("tree",
                      lambda: algorithm1(fm.X, labeling.labels,
                                         trace=trace))
    rulesets = staged("rules",
                      lambda: extract_rulesets(tree, fm.features))

    annotated = canonical is not None
    if annotated:
        canon_sets = canonical.rulesets \
            if isinstance(canonical, RuleReport) else canonical
        annotate_vs_canonical(rulesets, canon_sets)

    acc = None
    if full_space is not None:
        space_schedules, space_times = full_space

        def accuracy():
            ranges = [(lo * (1.0 - range_widen),
                       hi * (1.0 + range_widen))
                      for lo, hi in labeling.class_ranges()]
            Xf = _space_of(result).apply_features(
                list(space_schedules), fm.features)
            return class_range_accuracy(tree, Xf, space_times, ranges)

        acc = staged("accuracy", accuracy)

    if histograms is not None:
        n_schedules = histograms.n_rows
        training_error = grower.training_error(tree)
    else:
        n_schedules = len(result.schedules)
        training_error = tree.training_error(fm.X, labeling.labels)
    return RuleReport(
        graph=getattr(result, "graph", None),
        feature_matrix=fm, labeling=labeling,
        tree=tree, trace=trace, rulesets=rulesets,
        n_schedules=n_schedules,
        training_error=training_error,
        class_range_acc=acc, annotated=annotated,
        stage_seconds=stage_seconds)
