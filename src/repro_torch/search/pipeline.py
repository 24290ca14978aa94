"""The search loop: strategy x evaluator -> deduplicated observations.

:func:`run_search` is the JAX package's ``SearchDriver`` loop with no
acquisition and no sinks: the same budget clamping and the same
first-observation-per-canonical-schedule record, so the same strategy,
seed and times give the same result.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dag import Graph, Schedule
from repro_torch.engine.base import EvaluatorBase
from repro_torch.space.schedule import canonical_key


def tie_key(schedule: Schedule) -> tuple:
    """Total order on canonical encodings (``None`` streams sort first)."""
    return tuple((name, -1 if s is None else s)
                 for name, s in canonical_key(schedule))


@dataclasses.dataclass
class SearchResult:
    """Deduplicated observations from one search run."""

    graph: Graph
    schedules: list[Schedule]
    times: list[float]
    n_proposed: int
    cache_hits: int
    cache_misses: int

    def best(self) -> tuple[Schedule, float]:
        """The fastest observed (schedule, time); exact ties go to the
        lexicographically smallest canonical encoding."""
        if not self.schedules:
            raise ValueError(
                "empty search result (budget 0 or strategy proposed "
                "nothing) has no best schedule")
        times = self.times_array()
        ties = np.flatnonzero(times == times.min())
        i = min((int(j) for j in ties),
                key=lambda j: tie_key(self.schedules[j]))
        return self.schedules[i], self.times[i]

    def times_array(self) -> np.ndarray:
        return np.asarray(self.times, dtype=np.float64)


def run_search(graph: Graph, strategy, evaluator: EvaluatorBase,
               budget: int, batch_size: int = 1) -> SearchResult:
    """Drive ``strategy`` (``propose``/``observe``) for up to ``budget``
    proposals, each measured by ``evaluator``.

    ``budget`` counts proposals, not distinct schedules; the run ends
    early when the strategy proposes nothing. ``batch_size`` schedules
    are asked for per ``propose``; 1 is the paper's strictly sequential
    loop. A strategy that returns more than asked is clamped to the
    remaining budget. Every proposal is observed; the result keeps the
    first observation per canonical schedule.
    """
    ev = evaluator
    hits0, misses0 = ev.cache_hits, ev.cache_misses
    schedules: list[Schedule] = []
    times: list[float] = []
    seen: set[tuple] = set()
    n_proposed = 0
    while n_proposed < budget:
        ask = min(batch_size, budget - n_proposed)
        batch = strategy.propose(ask)[:ask]
        if not batch:
            break
        n_proposed += len(batch)
        for schedule, (key, t) in zip(batch, ev.evaluate_keyed(batch)):
            strategy.observe(schedule, float(t))
            if key not in seen:
                seen.add(key)
                schedules.append(schedule)
                times.append(float(t))
    return SearchResult(graph=graph, schedules=schedules, times=times,
                        n_proposed=n_proposed,
                        cache_hits=ev.cache_hits - hits0,
                        cache_misses=ev.cache_misses - misses0)
