"""The acquisition-aware search driver: the propose/observe round loop.

:class:`SearchDriver` owns the control path of a search: rounds of

    propose pool -> score pool with an acquisition function
        -> evaluate the chosen batch -> observe -> stream to sinks

against any :class:`~repro_torch.search.strategy.SearchStrategy` and
any evaluation backend — on the card, every evaluation a measurement.
:func:`repro_torch.search.run_search` is its thin wrapper (no
acquisition override, no sinks).

What the driver adds over a bare loop:

* **Acquisition override** (``acquisition=``): for strategies that
  speak the pool protocol
  (:class:`~repro_torch.search.strategy.PoolSearchStrategy` —
  ``SurrogateGuided`` and anything the portfolio delegates to it), the
  driver takes over screening: it asks the strategy for its raw
  candidate pool and ranks it with a named
  :data:`~repro_torch.driver.acquisitions.ACQUISITIONS` entry
  (``argmin_topk`` reproduces the strategy's built-in behavior exactly;
  ``ucb`` / ``expected_improvement`` add uncertainty from the boosted
  ensemble's per-tree variance). Strategies without a pool (MCTS,
  random, exhaustive) ignore the override and propose as usual.
* **Sinks** (``sinks=``): every evaluated batch is streamed — with its
  run-level freshness mask — to each attached
  :class:`~repro_torch.driver.sinks.Sink` (``"dataset"`` folds the
  corpus incrementally; ``"histogram"`` keeps only encodings and
  distills out of core; ``"trace"`` records the per-round choice
  stream; ``"telemetry"`` marks rounds in the trace). Names resolve
  through :func:`~repro_torch.driver.sinks.make_sink`; pre-built
  objects pass through.
* **Telemetry** (:mod:`repro_torch.obs`): ``driver.run``,
  ``driver.round``, ``driver.propose``, ``driver.acquire``,
  ``driver.evaluate`` and ``driver.observe`` spans, with the
  evaluator's ``engine.batch`` / ``engine.measure`` inside
  ``driver.evaluate``; a pure observer, never read back.

Determinism: the driver adds no randomness of its own. Proposal RNG
lives in the strategy, evaluation noise in the evaluator (seeded per
canonical key), and acquisition scoring is a pure function of the
surrogate state — so the same seed and times choose the same batches
on every analytic backend and as the JAX package's driver
(tests/test_torch_driver.py).

The JAX package's ``repro/driver/driver.py`` with the port's
conventions: the evaluator is the third positional argument, ``budget``
is keyword-only and required, and an evaluator built here is
``wallclock`` (measured on the card) unless ``backend=`` names another.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch import obs
from repro_torch.core.costmodel import Machine
from repro_torch.core.dag import Graph, Schedule
from repro_torch.driver.acquisitions import AcquisitionFn, resolve_acquisition
from repro_torch.driver.sinks import Sink, make_sink
from repro_torch.engine import make_evaluator
from repro_torch.engine.base import EvaluatorBase
from repro_torch.search.pipeline import SearchResult
from repro_torch.search.strategy import PoolSearchStrategy, SearchStrategy
from repro_torch.space.base import DesignSpace, as_space


class SearchDriver:
    """Round-based search loop: propose -> screen -> evaluate -> stream.

    Single-use: construct, :meth:`run` once, read the
    :class:`~repro_torch.search.pipeline.SearchResult`. All parameters
    shared with ``run_search`` keep its exact semantics (see that
    docstring for budget/sim_budget/batch_size/stall_limit); the
    driver-only knobs are ``acquisition`` / ``acquisition_kwargs``
    (registry name or a pre-built ``acq(surrogate, pool, best=)``
    callable), ``sinks`` (registry names or pre-built objects; the
    caller owns sink lifecycle — the driver only ``consume``\\ s), and
    the persistent evaluation store (``store=`` a shared
    :class:`~repro_torch.engine.store.EvalStore` / ``store_path=`` a file
    the evaluator opens and owns) forwarded to the evaluator the
    driver constructs — with it, ``sim_budget`` and the stall detector
    meter fresh evaluations (misses + store hits), so a warm search
    replays the cold trajectory byte-identically at zero measurement
    cost.
    """

    def __init__(self, graph: "Graph | DesignSpace",
                 strategy: SearchStrategy,
                 evaluator: EvaluatorBase | None = None, *,
                 budget: int | None,
                 batch_size: int = 1,
                 backend: str | None = None,
                 backend_kwargs: dict | None = None,
                 sim_budget: int | None = None,
                 stall_limit: int = 1000,
                 store=None,
                 store_path: "str | None" = None,
                 machine: Machine | None = None,
                 acquisition: "str | AcquisitionFn | None" = None,
                 acquisition_kwargs: dict | None = None,
                 sinks: "tuple | list" = ()):
        if evaluator is not None and machine is not None:
            raise ValueError(
                "pass either machine= or evaluator= (the evaluator "
                "already owns a machine), not both")
        if evaluator is not None and (backend is not None
                                      or backend_kwargs is not None):
            raise ValueError(
                "pass either backend=/backend_kwargs= or a "
                "preconfigured evaluator=, not both")
        if acquisition is None and acquisition_kwargs is not None:
            raise ValueError(
                "acquisition_kwargs requires acquisition=")
        if evaluator is not None and (store is not None
                                      or store_path is not None):
            raise ValueError(
                "pass store=/store_path= only when the driver builds "
                "the evaluator; attach the store to your preconfigured "
                "evaluator= instead")
        if store is not None and store_path is not None:
            raise ValueError("pass store= or store_path=, not both")
        for k in ("store", "store_path"):
            if backend_kwargs and k in backend_kwargs and (
                    store is not None or store_path is not None):
                raise ValueError(
                    f"{k} passed both directly and in backend_kwargs")
        self.space = as_space(graph)
        self.graph = graph
        self.strategy = strategy
        self.machine = machine
        self.budget = budget
        self.batch_size = batch_size
        self.evaluator = evaluator
        self.backend = backend
        self.backend_kwargs = backend_kwargs
        self.store = store
        self.store_path = store_path
        self.sim_budget = sim_budget
        self.stall_limit = stall_limit
        self.acquisition = None if acquisition is None else \
            resolve_acquisition(acquisition, acquisition_kwargs)
        self.sinks: list[Sink] = [
            make_sink(s, self.space) if isinstance(s, str) else s
            for s in sinks]
        self._ran = False
        self._round = 0       # current round index (spans + sinks agree)

    # -- one round's proposal ------------------------------------------
    def _choose(self, ask: int) -> list[Schedule]:
        """The round's batch: acquisition-screened when possible.

        With an acquisition override and a pool-protocol strategy, the
        driver screens the strategy's raw pool itself (the strategy
        still keeps the screening bookkeeping — pending predictions,
        pool counters — so ``screening_quality()`` reports whichever
        acquisition actually ran). Otherwise the strategy's own
        ``propose`` is the whole story, clamped exactly like the
        pre-driver loop.
        """
        s = self.strategy
        if self.acquisition is not None \
                and isinstance(s, PoolSearchStrategy):
            with obs.span("driver.propose", round=self._round):
                pool = s.propose_pool(ask)
            if pool is not None:
                obs.counter("driver.pool_size").add(len(pool))
                with obs.span("driver.acquire", round=self._round,
                              pool=len(pool)):
                    chosen = s.screen(pool, ask, self.acquisition)
                # same over-returning clamp as the propose() path: a
                # screen() that ignores its budget must not overshoot
                return s.pad(chosen, ask)[:ask]
        with obs.span("driver.propose", round=self._round):
            return s.propose(ask)[:ask]

    # -- the loop -------------------------------------------------------
    def run(self) -> SearchResult:
        """Drive the strategy to completion; see ``run_search``."""
        if self._ran:
            raise RuntimeError(
                "SearchDriver is single-use: strategy and sink state "
                "carry across rounds, so re-running would double-count "
                "observations; construct a fresh driver instead")
        self._ran = True
        owns_evaluator = self.evaluator is None
        kwargs = dict(self.backend_kwargs or {})
        if self.store is not None:
            kwargs["store"] = self.store
        if self.store_path is not None:
            kwargs["store_path"] = self.store_path
        ev = self.evaluator if self.evaluator is not None else \
            make_evaluator(self.space, self.backend or "wallclock",
                           machine=self.machine, **kwargs)
        budget, batch_size = self.budget, self.batch_size
        sim_budget, stall_limit = self.sim_budget, self.stall_limit
        hits0, misses0 = ev.cache_hits, ev.cache_misses
        store0 = ev.store_hits
        # sim_budget and the stall detector meter *fresh evaluations*
        # (paid measurements + store warm hits), so a search against a
        # warmed persistent store replays the cold run's trajectory —
        # byte-identical results — instead of running unbounded on free
        # lookups. Storeless, fresh == misses: the pre-store semantics.
        fresh0 = ev.fresh_evals()
        schedules: list[Schedule] = []
        times: list[float] = []
        seen: set[bytes] = set()
        n_proposed = 0
        stalled = 0
        # Telemetry is a pure observer: spans/counters/gauges are never
        # read back, so the trajectory is byte-identical with a live
        # registry attached (tests/test_torch_obs.py). The
        # round-by-round summary lands on SearchResult.telemetry only
        # when a registry is enabled — the disabled default pays one
        # flag check per round.
        tel = obs.current()
        rounds_tel: "list[dict] | None" = [] if tel.enabled else None
        best = float("inf")

        try:
            with obs.span("driver.run",
                          strategy=type(self.strategy).__name__,
                          backend=ev.backend):
                while ((budget is None or n_proposed < budget) and
                       (sim_budget is None
                        or ev.fresh_evals() - fresh0 < sim_budget)):
                    ask = batch_size if budget is None else \
                        min(batch_size, budget - n_proposed)
                    round_span = obs.span("driver.round",
                                          round=self._round)
                    round_span.__enter__()
                    try:
                        batch = self._choose(ask)
                        if not batch:
                            break
                        n_proposed += len(batch)
                        batch_fresh0 = ev.fresh_evals()
                        bh0, bs0, bm0 = (ev.cache_hits, ev.store_hits,
                                         ev.cache_misses)
                        ev_t0 = time.perf_counter() if tel.enabled \
                            else 0.0
                        with obs.span("driver.evaluate",
                                      round=self._round, n=len(batch)):
                            eb = ev.evaluate_batch(batch)
                        ev_wall = time.perf_counter() - ev_t0 \
                            if tel.enabled else 0.0
                        fresh = np.zeros(len(eb), dtype=bool)
                        with obs.span("driver.observe",
                                      round=self._round):
                            for i, (schedule, key, t) in enumerate(eb):
                                self.strategy.observe(schedule, float(t))
                                if key not in seen:
                                    seen.add(key)
                                    fresh[i] = True
                                    schedules.append(schedule)
                                    times.append(float(t))
                            for sink in self.sinks:
                                sink.consume(eb, fresh)
                        n_fresh = int(np.count_nonzero(fresh))
                        if tel.enabled:
                            tel.counter("driver.proposed").add(len(batch))
                            tel.counter("driver.fresh").add(n_fresh)
                            tel.counter("driver.fresh_evals").add(
                                ev.fresh_evals() - batch_fresh0)
                            if len(eb) and float(np.min(eb.times)) < best:
                                best = float(np.min(eb.times))
                                tel.gauge("driver.best").set(best)
                            round_span.set(n=len(batch), n_fresh=n_fresh)
                            rounds_tel.append({
                                "round": self._round,
                                "n": len(batch),
                                "n_fresh": n_fresh,
                                "best": best if best < float("inf")
                                else None,
                                "evaluate_s": ev_wall,
                                "memory_hits": ev.cache_hits - bh0,
                                "store_hits": ev.store_hits - bs0,
                                "misses": ev.cache_misses - bm0,
                            })
                        if sim_budget is not None or budget is None:
                            if ev.fresh_evals() == batch_fresh0:
                                stalled += len(batch)
                                if stalled >= stall_limit:
                                    break
                            else:
                                stalled = 0
                    finally:
                        round_span.__exit__(None, None, None)
                    self._round += 1
        finally:
            if owns_evaluator:
                ev.close()

        return SearchResult(graph=getattr(self.space, "graph", None),
                            schedules=schedules,
                            times=times, n_proposed=n_proposed,
                            cache_hits=ev.cache_hits - hits0,
                            cache_misses=ev.cache_misses - misses0,
                            store_hits=ev.store_hits - store0,
                            space=self.space,
                            telemetry=rounds_tel)
