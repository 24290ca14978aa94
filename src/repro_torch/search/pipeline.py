"""The search loop: strategy x evaluator -> deduplicated observations.

:func:`run_search` is the JAX package's ``SearchDriver`` loop with no
acquisition and no sinks: the same budget clamping and the same
first-observation-per-canonical-candidate record, so the same strategy,
seed and times give the same result. It drives a schedule space (a
``Graph``) or any :class:`~repro_torch.space.base.DesignSpace`.
``SearchResult.dataset()`` emits the (features, labels, times) triple
the rules pipeline consumes; :func:`repro_torch.rules.distill` turns a
whole result into a rules report.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.costmodel import Machine
from repro_torch.core.dag import Graph
from repro_torch.core.features import FeatureMatrix
from repro_torch.engine import make_evaluator
from repro_torch.engine.base import EvaluatorBase
from repro_torch.rules.labels import Labeling, label_times
from repro_torch.space.base import DesignSpace, as_space
from repro_torch.space.schedule import tie_key  # noqa: F401 (re-export)


@dataclasses.dataclass
class SearchResult:
    """Deduplicated observations from one search run.

    ``graph`` is the searched DAG for schedule spaces and ``None`` for
    parameter spaces; ``space`` carries the space searched (filled in
    from ``graph`` when not given).
    """

    graph: Graph | None
    schedules: list[Any]
    times: list[float]
    n_proposed: int
    cache_hits: int
    cache_misses: int
    # First-time evaluations served by the persistent store instead of a
    # paid measurement; 0 without a store.
    store_hits: int = 0
    space: DesignSpace | None = None

    def design_space(self) -> DesignSpace:
        """The searched space (wrapping ``graph`` when not recorded)."""
        if self.space is None:
            self.space = as_space(self.graph)
        return self.space

    def best(self) -> tuple[Any, float]:
        """The fastest observed (candidate, time); exact ties go to the
        smallest canonical encoding (the space's ``tie_key``), so the
        winner depends only on the observed set."""
        if not self.schedules:
            raise ValueError(
                "empty search result (budget 0 or strategy proposed "
                "nothing) has no best schedule")
        times = self.times_array()
        ties = np.flatnonzero(times == times.min())
        key = self.design_space().tie_key
        i = int(ties[0]) if ties.size == 1 else \
            min((int(j) for j in ties), key=lambda j: key(self.schedules[j]))
        return self.schedules[i], self.times[i]

    def times_array(self) -> np.ndarray:
        return np.asarray(self.times, dtype=np.float64)

    def dataset(self) -> tuple[FeatureMatrix, Labeling, np.ndarray]:
        """(features, labels, times) for the rules pipeline."""
        times = self.times_array()
        return (self.design_space().featurize(self.schedules),
                label_times(times), times)


def run_search(graph: "Graph | DesignSpace", strategy,
               evaluator: EvaluatorBase | None = None, *, budget: int,
               batch_size: int = 1, backend: str | None = None,
               backend_kwargs: dict | None = None,
               store_path: "str | None" = None,
               machine: Machine | None = None) -> SearchResult:
    """Drive ``strategy`` (``propose``/``observe``) for up to ``budget``
    proposals, each measured by ``evaluator``.

    ``budget`` counts proposals, not distinct candidates (an exhaustive
    run passes ``space.n_candidates()``); the run ends early when the
    strategy proposes nothing. ``batch_size`` candidates are asked for
    per ``propose``; 1 is the paper's strictly sequential loop. A
    strategy that returns more than asked is clamped to the remaining
    budget. Every proposal is observed; the result keeps the first
    observation per canonical candidate.

    Pass a preconfigured ``evaluator`` (its memo cache outlives the
    run), or let the call build one: ``backend`` (default
    ``"wallclock"``) with ``backend_kwargs`` and an optional
    ``store_path`` (the persistent store; a warmed one replays without
    measuring). ``machine`` is the analytic model's constants for the
    evaluator built here; an ``evaluator`` passed in already owns its
    machine, so the two are refused together. An evaluator built here
    is closed when the run ends.
    """
    if evaluator is not None and machine is not None:
        raise ValueError(
            "pass either machine= or evaluator= (the evaluator "
            "already owns a machine), not both")
    space = as_space(graph)
    owned = evaluator is None
    if owned:
        kwargs = dict(backend_kwargs or {})
        if store_path is not None:
            kwargs["store_path"] = store_path
        evaluator = make_evaluator(space, backend or "wallclock",
                                   machine=machine, **kwargs)
    elif backend is not None or backend_kwargs or store_path is not None:
        raise ValueError(
            "pass evaluator= or backend=/backend_kwargs=/store_path=, "
            "not both (attach the store to your own evaluator)")
    ev = evaluator
    try:
        hits0, misses0, store0 = ev.cache_hits, ev.cache_misses, \
            ev.store_hits
        schedules: list = []
        times: list[float] = []
        seen: set[bytes] = set()
        n_proposed = 0
        while n_proposed < budget:
            ask = min(batch_size, budget - n_proposed)
            batch = strategy.propose(ask)[:ask]
            if not batch:
                break
            n_proposed += len(batch)
            for cand, (key, t) in zip(batch, ev.evaluate_keyed(batch)):
                strategy.observe(cand, float(t))
                if key not in seen:
                    seen.add(key)
                    schedules.append(cand)
                    times.append(float(t))
        return SearchResult(graph=getattr(space, "graph", None),
                            schedules=schedules, times=times,
                            n_proposed=n_proposed,
                            cache_hits=ev.cache_hits - hits0,
                            cache_misses=ev.cache_misses - misses0,
                            store_hits=ev.store_hits - store0,
                            space=space)
    finally:
        if owned:
            ev.close()
