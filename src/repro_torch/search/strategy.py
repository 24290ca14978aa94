"""The :class:`SearchStrategy` protocol and the stateless strategies.

Every explorer speaks one interface:

    propose(budget) -> up to ``budget`` candidates (empty = done)
    observe(candidate, time) -> feed one measured time back

The caller (:func:`repro_torch.search.pipeline.run_search`) owns
evaluation, so it can be memoized, stored or measured on the card
without touching any strategy. The JAX package's
``repro/search/strategy.py`` without the cost-model-guided greedy
strategy (the port has no analytic model) and the pool-screening
extension of the surrogate strategies.
"""
from __future__ import annotations

import random
from typing import Any, Iterator, Protocol, runtime_checkable

from repro_torch.core.dag import Graph
from repro_torch.space.base import DesignSpace, as_space


@runtime_checkable
class SearchStrategy(Protocol):
    """Pluggable explorer of a design space."""

    def propose(self, budget: int) -> list:
        """Return up to ``budget`` candidates (empty = done)."""
        ...

    def observe(self, candidate: Any, time: float) -> None:
        """Feed back the measured time of a proposed candidate."""
        ...


class ExhaustiveSearch:
    """Full enumeration in the space's canonical order; ``observe`` is a
    no-op. Exhausts after one full sweep."""

    def __init__(self, graph: "Graph | DesignSpace",
                 n_streams: int | None = None):
        self.space = as_space(graph, n_streams)
        self.graph = getattr(self.space, "graph", None)
        self.n_streams = getattr(self.space, "n_streams", None)
        self._iter: Iterator = self.space.enumerate_candidates()

    def propose(self, budget: int) -> list:
        out: list = []
        for s in self._iter:
            out.append(s)
            if len(out) >= budget:
                break
        return out

    def observe(self, candidate: Any, time: float) -> None:
        pass


class RandomSearch:
    """I.i.d. uniform rollouts — the paper's unguided baseline.

    Duplicates are possible (and cheap: the evaluator memoizes); the
    strategy never exhausts on its own, so the budget is the only
    stopping criterion.
    """

    def __init__(self, graph: "Graph | DesignSpace",
                 n_streams: int | None = None, seed: int = 0):
        self.space = as_space(graph, n_streams)
        self.graph = getattr(self.space, "graph", None)
        self.n_streams = getattr(self.space, "n_streams", None)
        self.rng = random.Random(seed)

    def propose(self, budget: int) -> list:
        return [self.space.random_candidate(self.rng)
                for _ in range(budget)]

    def observe(self, candidate: Any, time: float) -> None:
        pass
