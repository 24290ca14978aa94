"""The single search entry point: strategy x evaluator -> dataset.

:func:`run_search` drives any strategy against any evaluation backend
(measured on the card by default) over a schedule space (a ``Graph``)
or any :class:`~repro_torch.space.base.DesignSpace`, and collects the
deduplicated (candidate, time) observations. ``SearchResult.dataset()``
emits the (features, labels, times) triple the rules pipeline consumes;
:func:`repro_torch.rules.distill` turns a whole result into a rules
report.

The loop itself lives in :class:`repro_torch.driver.SearchDriver`;
``run_search`` constructs a driver with no acquisition override and no
sinks. Construct a driver directly to screen pools with a named
acquisition (``ucb``, ``expected_improvement``) or to stream evaluated
batches to sinks. The JAX package's ``repro/search/pipeline.py`` with
the port's signature (evaluator third, ``budget`` keyword-only and
required, the ``wallclock`` backend by default).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.costmodel import Machine
from repro_torch.core.dag import Graph
from repro_torch.core.features import FeatureMatrix
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
    # One dict per driver round — {round, n, n_fresh, best, evaluate_s,
    # memory_hits, store_hits, misses} — filled only when a telemetry
    # registry (repro_torch.obs) is enabled during the run, else None.
    # Observational: never part of the result's identity.
    telemetry: "list[dict] | None" = None

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
               evaluator: EvaluatorBase | None = None, *,
               budget: int | None,
               batch_size: int = 1, backend: str | None = None,
               backend_kwargs: dict | None = None,
               sim_budget: int | None = None,
               stall_limit: int = 1000,
               store=None,
               store_path: "str | None" = None,
               machine: Machine | None = None) -> SearchResult:
    """Drive ``strategy`` (``propose``/``observe``) for up to ``budget``
    proposals, each measured by ``evaluator``.

    ``budget`` counts proposals, not distinct candidates (an exhaustive
    run passes ``space.n_candidates()``); ``None`` runs until the
    strategy exhausts or, for strategies that never return an empty
    batch, until ``stall_limit`` consecutive proposals bring no fresh
    evaluation. ``batch_size`` candidates are asked for per
    ``propose``; 1 is the paper's strictly sequential loop. A strategy
    that returns more than asked is clamped to the remaining budget.
    Every proposal is observed; the result keeps the first observation
    per canonical candidate.

    ``sim_budget`` bounds fresh evaluations (paid measurements plus
    store warm hits) instead of proposals: the loop stops once that
    many distinct candidates were evaluated. It is checked between
    batches, so a batch may overshoot by up to ``batch_size - 1``.
    Whenever the loop is not bounded by a proposal ``budget``, or a
    ``sim_budget`` is set, ``stall_limit`` breaks it after that many
    consecutive proposals without a fresh evaluation.

    Pass a preconfigured ``evaluator`` (its memo cache outlives the
    run), or let the call build one: ``backend`` (default
    ``"wallclock"``) with ``backend_kwargs`` and an optional persistent
    store (``store=`` a shared :class:`~repro_torch.engine.store.
    EvalStore`, or ``store_path=`` a file the evaluator opens and
    owns; a warmed store replays without measuring). ``machine`` is
    the analytic model's constants for the evaluator built here; an
    ``evaluator`` passed in already owns its machine, so the two are
    refused together, as are ``evaluator`` and ``backend``. An
    evaluator built here is closed when the run ends.
    """
    # Lazy: repro_torch.driver.driver imports this module for
    # SearchResult.
    from repro_torch.driver.driver import SearchDriver
    return SearchDriver(graph, strategy, evaluator, budget=budget,
                        batch_size=batch_size, backend=backend,
                        backend_kwargs=backend_kwargs,
                        sim_budget=sim_budget, stall_limit=stall_limit,
                        store=store, store_path=store_path,
                        machine=machine).run()
