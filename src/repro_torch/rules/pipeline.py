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

The JAX package's ``repro/rules/pipeline.py``, dense path only: no
out-of-core ``histograms=``, no streamed ``features=``, no telemetry.
``distill`` is duck-typed: it needs ``.schedules``, ``.times`` and a
design space (``.design_space()`` / ``.space`` / ``.graph``).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.dag import Graph
from repro_torch.core.features import FeatureMatrix
from repro_torch.rules.labels import Labeling, label_times
from repro_torch.rules.rulesets import (RuleSet, annotate_vs_canonical,
                                        class_range_accuracy,
                                        extract_rulesets,
                                        render_rules_table, rules_by_class)
from repro_torch.rules.trees import (DecisionTree, TreeSearchTrace,
                                     algorithm1)
from repro_torch.space.base import DesignSpace, as_space


def _space_of(result) -> DesignSpace:
    """The corpus's design space, however the result spells it."""
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

    graph: Graph | None            # None for graph-less (parameter) spaces
    feature_matrix: FeatureMatrix
    labeling: Labeling
    tree: DecisionTree
    trace: TreeSearchTrace
    rulesets: list[RuleSet]
    n_schedules: int
    training_error: float
    class_range_acc: float | None = None   # Table V, when full_space given
    annotated: bool = False                # §V marks vs a canonical report

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


def distill(result,
            labeler: Callable[[np.ndarray], Labeling] = label_times,
            canonical: "RuleReport | list[RuleSet] | None" = None,
            full_space: "tuple[Sequence, np.ndarray] | None" = None,
            range_widen: float = 0.0) -> RuleReport:
    """Label -> featurize -> Algorithm 1 -> rulesets, as one call.

    ``labeler`` maps the observed times to a :class:`Labeling`
    (defaults to the paper's §IV-A convolution labeling). ``canonical``
    annotates the extracted rulesets against a reference report's
    rulesets (§V). ``full_space`` is a (candidates, times) pair covering
    the whole design space; when given, the Table-V class-range
    accuracy is computed by classifying the full space in this report's
    feature basis, with each class's (lo, hi) time range widened to
    (lo*(1-w), hi*(1+w)) for ``range_widen=w``.
    """
    times = np.asarray(result.times, dtype=np.float64)
    labeling = labeler(times)
    sp = _space_of(result)
    fm = sp.featurize(list(result.schedules))
    trace = TreeSearchTrace([], [], [])
    tree = algorithm1(fm.X, labeling.labels, trace=trace)
    rulesets = extract_rulesets(tree, fm.features)

    annotated = canonical is not None
    if annotated:
        canon_sets = canonical.rulesets \
            if isinstance(canonical, RuleReport) else canonical
        annotate_vs_canonical(rulesets, canon_sets)

    acc = None
    if full_space is not None:
        space_candidates, space_times = full_space
        ranges = [(lo * (1.0 - range_widen), hi * (1.0 + range_widen))
                  for lo, hi in labeling.class_ranges()]
        Xf = sp.apply_features(list(space_candidates), fm.features)
        acc = class_range_accuracy(tree, Xf, space_times, ranges)

    return RuleReport(
        graph=getattr(result, "graph", None),
        feature_matrix=fm, labeling=labeling,
        tree=tree, trace=trace, rulesets=rulesets,
        n_schedules=len(result.schedules),
        training_error=tree.training_error(fm.X, labeling.labels),
        class_range_acc=acc, annotated=annotated)
