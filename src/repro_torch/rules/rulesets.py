"""Design-rule generation from a trained decision tree (paper §IV-D, §V).

Every root->leaf path is a *ruleset* for the leaf's majority performance
class. Feature decisions render to text exactly like the paper:

    order feature, went right (value 1):  "u before v"
    order feature, went left  (value 0):  "v before u"
    stream feature, right:                "u same stream as v"
    stream feature, left:                 "u different stream than v"

Rulesets from reduced searches are annotated against the canonical
(exhaustive-search) rulesets: *overconstrained* (extra harmless rules) or
*underconstrained* ("insufficient rules" — missing constraints), §V.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.features import Feature
from repro_torch.rules.trees import DecisionTree


@dataclasses.dataclass(frozen=True)
class Rule:
    feature: Feature
    value: int  # 0 or 1

    def text(self) -> str:
        return self.feature.describe(self.value)

    def canonical_atom(self) -> tuple:
        """Normalized identity so negations/symmetries compare equal.

        order:(u,v,1) == "u before v"; order:(u,v,0) == "v before u" is a
        *different* atom. stream features are symmetric in (u,v) already
        (u < v by construction).
        """
        return (self.feature.kind, self.feature.u, self.feature.v,
                self.value)


@dataclasses.dataclass
class RuleSet:
    rules: list[Rule]
    class_label: int
    n_samples: int
    pure: bool                       # leaf contains a single class
    extraneous: list[Rule] = dataclasses.field(default_factory=list)
    insufficient: bool = False

    def atoms(self) -> frozenset:
        return frozenset(r.canonical_atom() for r in self.rules)

    def render(self) -> list[str]:
        out = [r.text() for r in self.rules]
        if self.insufficient:
            out.append("insufficient rules")
        return out


def extract_rulesets(tree: DecisionTree,
                     features: list[Feature]) -> list[RuleSet]:
    """One RuleSet per leaf, sorted by sample count (descending)."""
    out: list[RuleSet] = []
    for path, leaf in tree.paths():
        rules = [Rule(features[f], 1 if went_right else 0)
                 for (f, _t, went_right) in path]
        n_nonzero = int(np.count_nonzero(leaf.value))
        out.append(RuleSet(
            rules=rules,
            class_label=int(tree.classes_[leaf.majority_class()]),
            n_samples=leaf.n_samples,
            pure=n_nonzero <= 1,
        ))
    out.sort(key=lambda r: -r.n_samples)
    return out


def rules_by_class(rulesets: list[RuleSet]) -> dict[int, list[RuleSet]]:
    grouped: dict[int, list[RuleSet]] = {}
    for rs in rulesets:
        grouped.setdefault(rs.class_label, []).append(rs)
    return grouped


def annotate_vs_canonical(candidate: list[RuleSet],
                          canonical: list[RuleSet]) -> None:
    """Mark each candidate ruleset over/under-constrained (paper §V).

    A candidate ruleset R for class c is *consistent* with canonical
    ruleset C (same class) if C's atoms are a subset of R's — extra atoms
    in R are extraneous-but-harmless. If no canonical ruleset of the same
    class is a subset of R, R is underconstrained ("insufficient rules").
    """
    canon_by_class = rules_by_class(canonical)
    for rs in candidate:
        best_extra: list[Rule] | None = None
        for canon in canon_by_class.get(rs.class_label, []):
            if canon.atoms() <= rs.atoms():
                extra_atoms = rs.atoms() - canon.atoms()
                extra = [r for r in rs.rules
                         if r.canonical_atom() in extra_atoms]
                if best_extra is None or len(extra) < len(best_extra):
                    best_extra = extra
        if best_extra is None:
            rs.insufficient = True
            rs.extraneous = []
        else:
            rs.insufficient = False
            rs.extraneous = best_extra


# ---------------------------------------------------------------------------
# Table V: how well subset-derived rules generalize to the whole space.
# ---------------------------------------------------------------------------

def class_range_accuracy_loop(tree: DecisionTree,
                              X_full: np.ndarray,
                              times_full: np.ndarray,
                              class_ranges: list[tuple[float, float]]
                              ) -> float:
    """Reference (per-sample Python loop) for the vectorized version."""
    pred = tree.predict(X_full)
    times_full = np.asarray(times_full, dtype=np.float64)
    ok = 0
    for c, t in zip(pred, times_full):
        lo, hi = class_ranges[int(c)]
        if lo <= t <= hi:
            ok += 1
    return ok / max(1, len(times_full))


def class_range_accuracy(tree: DecisionTree,
                         X_full: np.ndarray,
                         times_full: np.ndarray,
                         class_ranges: list[tuple[float, float]]) -> float:
    """Fraction of implementations whose measured time falls within the
    time range of the class the tree assigns them (paper Table V).

    One batched tree descent plus a gather of the per-class (lo, hi)
    bounds; locked to :func:`class_range_accuracy_loop` by tests.
    """
    times_full = np.asarray(times_full, dtype=np.float64)
    if times_full.size == 0:
        return 0.0
    pred = tree.predict(X_full).astype(np.int64)
    ranges = np.asarray(class_ranges, dtype=np.float64)
    lo, hi = ranges[pred, 0], ranges[pred, 1]
    ok = int(np.count_nonzero((lo <= times_full) & (times_full <= hi)))
    return ok / times_full.size


def render_rules_table(grouped: dict[int, list[RuleSet]],
                       top_k: int = 3) -> str:
    """Markdown-ish rendering like Tables VI-VIII."""
    lines: list[str] = []
    for c in sorted(grouped):
        lines.append(f"## performance class {c + 1}")
        for rs in grouped[c][:top_k]:
            lines.append(f"  ruleset ({rs.n_samples} samples"
                         f"{', impure' if not rs.pure else ''}"
                         f"{', underconstrained' if rs.insufficient else ''})")
            extra = {r.canonical_atom() for r in rs.extraneous}
            for r in rs.rules:
                mark = "  [extraneous]" if r.canonical_atom() in extra else ""
                lines.append(f"    - {r.text()}{mark}")
            if rs.insufficient:
                lines.append("    - insufficient rules")
    return "\n".join(lines)
