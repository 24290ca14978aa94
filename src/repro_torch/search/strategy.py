"""The :class:`SearchStrategy` protocol and the stateless strategies.

Every explorer speaks one interface:

    propose(budget) -> up to ``budget`` candidates (empty = done)
    observe(candidate, time) -> feed one measured time back

The caller (:class:`repro_torch.driver.SearchDriver`, behind
:func:`repro_torch.search.pipeline.run_search`) owns evaluation, so it
can be memoized, stored or measured on the card without touching any
strategy. :class:`PoolSearchStrategy` splits screening out of
``propose`` so the driver can rank a two-stage strategy's pool with its
own acquisition; the two-stage strategies live in
:mod:`repro_torch.search.surrogate`. :class:`GreedyCostModel` builds
schedules by prefix simulation under the analytic
:class:`~repro_torch.core.costmodel.Machine` (the H100's by default).
The JAX package's ``repro/search/strategy.py``.
"""
from __future__ import annotations

import random
from typing import Any, Iterator, Protocol, runtime_checkable

from repro_torch.core.costmodel import Machine, op_durations, simulate
from repro_torch.core.dag import BoundOp, Graph, Schedule
from repro_torch.space.base import DesignSpace, as_space
from repro_torch.space.schedule import (eligible_items,  # noqa: F401
                                        random_schedule)


@runtime_checkable
class SearchStrategy(Protocol):
    """Pluggable explorer of a design space."""

    def propose(self, budget: int) -> list:
        """Return up to ``budget`` candidates (empty = done)."""
        ...

    def observe(self, candidate: Any, time: float) -> None:
        """Feed back the measured time of a proposed candidate."""
        ...


@runtime_checkable
class PoolSearchStrategy(SearchStrategy, Protocol):
    """The pool-proposal extension: screening split out of ``propose``.

    Two-stage strategies internally do *pool -> rank -> top-k*; this
    protocol exposes the stages so the acquisition-aware driver
    (:class:`repro_torch.driver.SearchDriver`) can substitute its own
    ranking while the strategy keeps candidate generation, RNG state
    and screening bookkeeping. A conforming strategy's ``propose(k)``
    must equal ``pad(screen(propose_pool(k), k, <default acq>), k)``
    whenever ``propose_pool`` returns a pool — so driving through
    either path is the same search.

    ``propose_pool(budget)``
        The raw candidate pool a ``propose(budget)`` call would screen
        (novel, canonical, deduped), or ``None`` when screening does
        not apply yet (warmup: the driver falls back to ``propose``).
    ``screen(pool, budget, acquisition)``
        Rank ``pool`` with ``acquisition(surrogate, pool, best=...)``
        and return the chosen ``<= budget`` candidates, recording
        whatever the strategy logs about screening. Pools no larger
        than ``budget`` pass through unranked.
    ``pad(chosen, budget)``
        Fill ``chosen`` up to ``budget`` (e.g. with uniform rollouts)
        so the search loop is never starved.

    :class:`repro_torch.search.surrogate.SurrogateGuided` is the
    reference implementation.
    """

    def propose_pool(self, budget: int) -> list | None:
        ...

    def screen(self, pool: list, budget: int, acquisition) -> list:
        ...

    def pad(self, chosen: list, budget: int) -> list:
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


class GreedyCostModel:
    """Epsilon-greedy construction guided by prefix simulation.

    Each schedule is grown item by item; at every step the candidate
    extensions are scored by simulating the *partial* schedule under the
    analytic machine model and the arg-min is taken (ties broken by
    canonical item order). With probability ``epsilon`` a uniformly
    random extension is taken instead, so repeated proposals explore
    beyond the single pure-greedy trajectory. The first proposal of a
    run is always pure greedy (epsilon applies from the second on).

    Prefix simulations bypass the evaluator (and therefore the
    ``sim_budget`` meter); ``n_prefix_sims`` counts them. Under the
    H100 ``Machine()`` at the paper's size every complete SpMV schedule
    has one makespan, so the choice between extensions is decided by
    prefix makespans and, where those tie too, by item order.
    """

    def __init__(self, graph: Graph, n_streams: int,
                 machine: Machine | None = None,
                 epsilon: float = 0.25, seed: int = 0):
        self.graph = graph
        self.n_streams = n_streams
        self.machine = machine or Machine()
        self.epsilon = epsilon
        self.rng = random.Random(seed)
        self._n_proposed = 0
        self._durations = op_durations(graph, self.machine)
        self.n_prefix_sims = 0

    def _prefix_cost(self, prefix: list[BoundOp]) -> float:
        self.n_prefix_sims += 1
        return simulate(self.graph, Schedule(tuple(prefix)),
                        self.machine,
                        durations=self._durations).makespan

    def _build(self, greedy_only: bool) -> Schedule:
        prefix: list[BoundOp] = []
        while True:
            options = eligible_items(self.graph, prefix, self.n_streams)
            if not options:
                return Schedule(tuple(prefix))
            if not greedy_only and self.rng.random() < self.epsilon:
                prefix.append(self.rng.choice(options))
                continue
            best = min(options,
                       key=lambda o: self._prefix_cost(prefix + [o]))
            prefix.append(best)

    def propose(self, budget: int) -> list[Schedule]:
        out: list[Schedule] = []
        for _ in range(budget):
            out.append(self._build(greedy_only=self._n_proposed == 0))
            self._n_proposed += 1
        return out

    def observe(self, schedule: Schedule, time: float) -> None:
        pass
