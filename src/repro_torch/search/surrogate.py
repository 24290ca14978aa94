"""Two-stage (surrogate-screened) search and the strategy portfolio.

On the card every evaluation is a gated measurement, the expensive
resource of a search. Two-stage evaluation spends it where it pays: a
cheap learned surrogate screens a large candidate pool, and only the
surrogate's top-k reach the evaluator. Everything here rides the
``SearchStrategy`` seam — the evaluator still owns measurement; the
surrogate only decides *which* proposals are worth it.

  * :class:`RidgeSurrogate` — ridge regression over the §IV-B
    order/stream feature vectors, trained online from ``observe``d
    (schedule, time) pairs via the incremental
    :class:`repro_torch.core.features.FeatureBasis` (new schedules are
    absorbed without re-expanding the corpus).
  * The **surrogate registry** — :func:`make_surrogate` /
    :func:`register_surrogate` resolve surrogate models by name behind
    one protocol (``observe`` / ``predict`` / ``n_observations``,
    shared via :class:`repro_torch.rules.boost.OnlineSurrogateBase`).
    Built-ins: ``"ridge"`` (here) and ``"boost"``
    (:class:`repro_torch.rules.boost.GradientBoostedSurrogate`, regression
    trees on the same features — the nonlinear upgrade for spaces
    where makespan depends on feature interactions).
  * :class:`SurrogateGuided` — generates a candidate pool (uniform
    rollouts + elite prefix mutations through ``eligible_items``),
    scores the pool with the surrogate (``surrogate="ridge"|"boost"``
    or any protocol object), and proposes only the argmin top-k. Every
    screened→simulated pair is logged, so screening quality (Spearman
    rank correlation, relative error) is reportable.
  * :class:`PortfolioSearch` — greedy seeding → MCTS refinement →
    surrogate-guided exploitation behind the plain strategy protocol.

The JAX package's ``repro/search/surrogate.py`` with its imports
rewritten. The greedy phase scores prefixes under the analytic
:class:`~repro_torch.core.costmodel.Machine` (the H100's by default),
not on the card.
"""
from __future__ import annotations

import random

import numpy as np

from repro_torch.core.costmodel import Machine
from repro_torch.core.dag import Graph, Schedule
from repro_torch.core.features import Feature
from repro_torch.driver.acquisitions import resolve_acquisition
from repro_torch.rules.boost import (GradientBoostedSurrogate,
                                     OnlineSurrogateBase)
from repro_torch.search.mcts import MCTSSearch
from repro_torch.search.strategy import GreedyCostModel
from repro_torch.space.base import DesignSpace, as_space


# -- rank statistics ---------------------------------------------------------

def _average_ranks(x: np.ndarray) -> np.ndarray:
    """Ranks with ties sharing their average rank (Spearman convention)."""
    x = np.asarray(x, dtype=np.float64)
    uniq, inv, counts = np.unique(x, return_inverse=True,
                                  return_counts=True)
    ends = np.cumsum(counts)
    starts = ends - counts
    return (0.5 * (starts + ends - 1))[inv]


def spearman(a, b) -> float:
    """Spearman rank correlation; 0.0 on degenerate (constant) input."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.size != b.size:
        raise ValueError(f"length mismatch {a.size} != {b.size}")
    if a.size < 2:
        return 0.0
    ra = _average_ranks(a) - (a.size - 1) / 2.0
    rb = _average_ranks(b) - (b.size - 1) / 2.0
    denom = float(np.sqrt((ra * ra).sum() * (rb * rb).sum()))
    if denom == 0.0:
        return 0.0
    return float((ra * rb).sum() / denom)


# -- the surrogate models ----------------------------------------------------

class RidgeSurrogate(OnlineSurrogateBase):
    """Online ridge regression over order/stream feature vectors.

    Corpus bookkeeping and lazy geometric-backoff refits come from
    :class:`~repro_torch.rules.boost.OnlineSurrogateBase`; the fit solves
    the regularized normal equations on the constant-pruned feature
    matrix — in the dual (n×n) form when there are more features than
    observations, so wide spaces like ``halo3d_dag`` stay cheap. With
    no (or degenerate) data it predicts the observed mean.
    """

    def __init__(self, graph: "Graph | DesignSpace", l2: float = 1e-3,
                 refit_every: int = 8):
        super().__init__(graph, refit_every=refit_every)
        self.l2 = l2
        self._features: list[Feature] = []
        self._w: np.ndarray | None = None
        self._x_mean: np.ndarray | None = None
        self._y_mean = 0.0

    def _fit(self) -> None:
        self._fitted_n = len(self._times)
        y = np.asarray(self._times, dtype=np.float64)
        self._y_mean = float(y.mean()) if y.size else 0.0
        self._features, self._w, self._x_mean = [], None, None
        if y.size < 2:
            return
        fm = self.basis.matrix()
        if not fm.features:
            return  # all observations identical: mean is the best guess
        X = fm.X.astype(np.float64)
        self._features = fm.features
        self._x_mean = X.mean(axis=0)
        Xc = X - self._x_mean
        yc = y - self._y_mean
        n, d = X.shape
        lam = self.l2 * n
        if d <= n:
            self._w = np.linalg.solve(
                Xc.T @ Xc + lam * np.eye(d), Xc.T @ yc)
        else:  # dual form: identical w, but an n×n solve
            alpha = np.linalg.solve(Xc @ Xc.T + lam * np.eye(n), yc)
            self._w = Xc.T @ alpha

    def predict(self, schedules: list[Schedule]) -> np.ndarray:
        """Predicted times, one per schedule (refits if stale)."""
        if self._stale():
            self._fit()
        if self._w is None:
            return np.full(len(schedules), self._y_mean, dtype=np.float64)
        X = self.space.apply_features(schedules, self._features) \
            .astype(np.float64)
        return self._y_mean + (X - self._x_mean) @ self._w


# -- the surrogate registry --------------------------------------------------

SURROGATES: dict[str, type] = {}
"""Registry of surrogate factories: name -> ``cls(graph, **kwargs)``."""


def register_surrogate(name: str, factory: type) -> None:
    """Add a surrogate model to the :data:`SURROGATES` registry.

    Factories are called as ``factory(graph, **kwargs)`` and must
    return an object with the online-surrogate protocol:
    ``observe(schedule, time)``, ``predict(schedules) -> np.ndarray``,
    and ``n_observations``.
    """
    SURROGATES[name] = factory


register_surrogate("ridge", RidgeSurrogate)
register_surrogate("boost", GradientBoostedSurrogate)


def make_surrogate(graph: "Graph | DesignSpace",
                   surrogate: str = "ridge", **kwargs):
    """Construct a surrogate model by registry name."""
    try:
        factory = SURROGATES[surrogate]
    except KeyError:
        raise ValueError(
            f"unknown surrogate {surrogate!r}; registered: "
            f"{sorted(SURROGATES)}") from None
    return factory(graph, **kwargs)


# -- the two-stage strategy --------------------------------------------------

class SurrogateGuided:
    """Propose argmin-of-surrogate candidates from a screened pool.

    Each ``propose(k)`` builds a pool of ``pool_factor * k`` candidate
    schedules — uniform random rollouts mixed with *elite mutations*
    (truncate one of the best observed schedules at a random point and
    recomplete it randomly through ``eligible_items``, so every
    candidate is canonical by construction) — scores the pool with the
    ridge surrogate, and returns the ``k`` candidates with the lowest
    predicted time. Already-simulated schedules are excluded from the
    pool, so the downstream evaluator spends its simulations on new
    implementations.

    Until ``warmup`` observations have arrived the strategy proposes
    uniform rollouts (there is nothing to fit yet). Every prediction
    that reaches simulation is logged in ``screen_log`` as
    (predicted, simulated); :meth:`screening_quality` summarizes it.

    ``surrogate`` selects the screening model: a :data:`SURROGATES`
    registry name (``"ridge"`` default, ``"boost"`` for the
    gradient-boosted trees) with ``surrogate_kwargs`` forwarded to its
    factory, or a pre-built object implementing the protocol. The
    legacy ``refit_every`` argument forwards to any named surrogate
    (both built-ins share it via ``OnlineSurrogateBase``); ``l2`` is
    ridge-only and raises if combined with another name — never
    silently dropped.

    ``acquisition`` selects how the pool is ranked: a
    :data:`repro_torch.driver.ACQUISITIONS` registry name (``"argmin_topk"``
    default — rank purely by predicted time, the original behavior;
    ``"ucb"`` / ``"expected_improvement"`` add the surrogate's
    predictive uncertainty, which needs a model with
    ``predict_with_std`` such as ``"boost"``) with
    ``acquisition_kwargs`` forwarded to its factory, or a pre-built
    ``acq(surrogate, pool, best=) -> (scores, mu)`` callable. The
    strategy implements the
    :class:`~repro_torch.search.strategy.PoolSearchStrategy` protocol
    (``propose_pool`` / ``screen`` / ``pad``), so
    :class:`repro_torch.driver.SearchDriver` can also override the
    acquisition per run without touching strategy state.
    """

    def __init__(self, graph: "Graph | DesignSpace",
                 n_streams: int | None = None, seed: int = 0,
                 warmup: int = 32, pool_factor: int = 10,
                 elite_frac: float = 0.25, mutation_prob: float = 0.5,
                 l2: float | None = None, refit_every: int | None = None,
                 surrogate="ridge", surrogate_kwargs: dict | None = None,
                 acquisition="argmin_topk",
                 acquisition_kwargs: dict | None = None):
        if pool_factor < 1:
            raise ValueError("pool_factor must be >= 1")
        self.space = as_space(graph, n_streams)
        self.graph = getattr(self.space, "graph", None)
        self.n_streams = getattr(self.space, "n_streams", None)
        self.rng = random.Random(seed)
        self.warmup = warmup
        self.pool_factor = pool_factor
        self.elite_frac = elite_frac
        self.mutation_prob = mutation_prob
        if isinstance(surrogate, str):
            kwargs = dict(surrogate_kwargs or {})
            if l2 is not None:
                if surrogate != "ridge":
                    raise ValueError(
                        "l2 only applies to the ridge surrogate; use "
                        "surrogate_kwargs for model-specific options")
                kwargs.setdefault("l2", l2)
            if refit_every is not None:
                kwargs.setdefault("refit_every", refit_every)
            self.surrogate = make_surrogate(self.space, surrogate,
                                            **kwargs)
        else:
            if (surrogate_kwargs is not None or l2 is not None
                    or refit_every is not None):
                raise ValueError(
                    "surrogate_kwargs/l2/refit_every only apply when "
                    "surrogate is a registry name, not a pre-built "
                    "object")
            self.surrogate = surrogate
        self.acquisition = resolve_acquisition(acquisition,
                                               acquisition_kwargs)
        self._observed: dict[tuple, float] = {}     # canonical key -> time
        self._elites: list[tuple[float, Schedule]] = []
        self._pending: dict[tuple, float] = {}      # key -> predicted time
        self.n_screened = 0                         # surrogate-scored pool
        self.screen_log: list[tuple[float, float]] = []  # (pred, actual)

    # -- candidate generation ------------------------------------------
    def _mutate(self, elite: Schedule) -> Schedule:
        return self.space.mutate(elite, self.rng)

    def _candidate(self) -> Schedule:
        if self._elites and self.rng.random() < self.mutation_prob:
            _, elite = self.rng.choice(self._elites)
            return self._mutate(elite)
        return self.space.random_candidate(self.rng)

    def _pool(self, size: int) -> list[Schedule]:
        """Up to ``size`` novel candidates (deduped, not yet simulated)."""
        pool: list[Schedule] = []
        keys: set[tuple] = set()
        for _ in range(4 * size):
            if len(pool) >= size:
                break
            s = self._candidate()
            key = self.space.candidate_key(s)
            if key in keys or key in self._observed:
                continue
            keys.add(key)
            pool.append(s)
        return pool

    # -- pool protocol (PoolSearchStrategy) ----------------------------
    def propose_pool(self, budget: int) -> list[Schedule] | None:
        """The raw candidate pool one ``propose(budget)`` would screen.

        ``None`` while the surrogate is still warming up (nothing to
        fit — ``propose`` falls back to uniform rollouts), else up to
        ``pool_factor * budget`` novel candidates.
        """
        if budget <= 0 or self.surrogate.n_observations < self.warmup:
            return None
        return self._pool(self.pool_factor * budget)

    def best_observed(self) -> float | None:
        """Best simulated time seen so far (the EI incumbent)."""
        return self._elites[0][0] if self._elites else None

    def screen(self, pool: list[Schedule], budget: int,
               acquisition) -> list[Schedule]:
        """Rank ``pool`` with ``acquisition`` and keep the best ``budget``.

        Pools no larger than ``budget`` pass through unranked (space
        nearly exhausted: nothing to screen). Every chosen candidate's
        *predicted time* — the acquisition's ``mu``, never its score —
        is parked in the pending log so ``screening_quality()``
        compares predictions against simulation regardless of which
        acquisition ranked the pool.
        """
        if len(pool) <= budget:
            return list(pool)
        scores, preds = acquisition(self.surrogate, pool,
                                    best=self.best_observed())
        self.n_screened += len(pool)
        top = np.argsort(scores, kind="stable")[:budget]
        chosen = [pool[i] for i in top]
        for i in top:
            self._pending[self.space.candidate_key(pool[i])] = \
                float(preds[i])
        return chosen

    def pad(self, chosen: list[Schedule],
            budget: int) -> list[Schedule]:
        """Fill with uniform rollouts — never starve the search loop."""
        while len(chosen) < budget:
            chosen.append(self.space.random_candidate(self.rng))
        return chosen

    # -- strategy protocol ---------------------------------------------
    def propose(self, budget: int) -> list[Schedule]:
        if budget <= 0:
            return []
        pool = self.propose_pool(budget)
        if pool is None:  # warmup: nothing to fit yet
            return [self.space.random_candidate(self.rng)
                    for _ in range(budget)]
        return self.pad(self.screen(pool, budget, self.acquisition),
                        budget)

    def observe(self, schedule: Schedule, time: float) -> None:
        key = self.space.candidate_key(schedule)
        pred = self._pending.pop(key, None)
        if pred is not None:
            self.screen_log.append((pred, float(time)))
        if key in self._observed:
            # Re-proposed duplicate: the memoized evaluator returned the
            # same makespan, so training on it again only grows the
            # basis/refit cost without adding information.
            return
        self._observed[key] = float(time)
        self._elites.append((float(time), schedule))
        self._elites.sort(key=lambda e: e[0])
        n_elite = max(1, min(32, int(self.elite_frac
                                     * len(self._observed))))
        del self._elites[n_elite:]
        self.surrogate.observe(schedule, time)

    # -- reporting ------------------------------------------------------
    def screening_quality(self) -> dict:
        """Surrogate-vs-simulated accuracy over everything screened."""
        if not self.screen_log:
            return {"n_screened": self.n_screened, "n_compared": 0,
                    "spearman": 0.0, "mean_rel_err": float("nan")}
        pred, actual = map(np.asarray, zip(*self.screen_log))
        rel = np.abs(pred - actual) / np.maximum(actual, 1e-30)
        return {"n_screened": self.n_screened,
                "n_compared": len(self.screen_log),
                "spearman": spearman(pred, actual),
                "mean_rel_err": float(rel.mean())}


# -- the portfolio -----------------------------------------------------------

class PortfolioSearch:
    """Greedy seeding → MCTS refinement → surrogate exploitation.

    One strategy-protocol object that spends its proposal stream in
    three phases: ``seed_proposals`` epsilon-greedy constructions (fast
    good anchors for the surrogate), ``mcts_proposals`` of the paper's
    coverage-guided MCTS (diverse structure), then surrogate-guided
    two-stage exploitation for the rest of the budget. Every
    observation — whatever phase proposed it — feeds both the MCTS tree
    (via path materialization) and the surrogate's training set, so the
    exploitation phase starts from everything the earlier phases
    learned. ``**surrogate_kwargs`` reaches :class:`SurrogateGuided`,
    so ``PortfolioSearch(..., surrogate="boost")`` exploits with the
    gradient-boosted tree model (and ``acquisition="ucb"`` screens
    with it). The portfolio also speaks the
    :class:`~repro_torch.search.strategy.PoolSearchStrategy` protocol by
    delegating to its exploitation phase, so a driver-level
    acquisition override reaches the surrogate phase too.

    Budget accounting caveat: the greedy phase scores candidate
    extensions with *prefix* simulations of its own
    (``GreedyCostModel.n_prefix_sims``), which the evaluator's
    ``sim_budget`` meter does not see. For strict equal-simulation
    comparisons, pass
    ``seed_proposals=0``. The greedy phase also simulates under
    ``machine`` — when the evaluator runs a non-default machine, pass
    the same one here or the seeds will optimize the wrong objective.
    """

    def __init__(self, graph: Graph, n_streams: int,
                 machine: Machine | None = None, seed: int = 0,
                 seed_proposals: int = 16, mcts_proposals: int = 128,
                 **surrogate_kwargs):
        self.greedy = GreedyCostModel(graph, n_streams, machine=machine,
                                      seed=seed)
        self.mcts = MCTSSearch(graph, n_streams, seed=seed)
        self.surrogate = SurrogateGuided(graph, n_streams, seed=seed,
                                         **surrogate_kwargs)
        self.seed_proposals = seed_proposals
        self.mcts_proposals = mcts_proposals
        self._n = 0

    def propose(self, budget: int) -> list[Schedule]:
        b1 = self.seed_proposals
        b2 = self.seed_proposals + self.mcts_proposals
        while True:
            if self._n < b1:
                batch = self.greedy.propose(min(budget, b1 - self._n))
                if not batch:
                    self._n = b1
                    continue
            elif self._n < b2:
                batch = self.mcts.propose(min(budget, b2 - self._n))
                if not batch:  # tiny space fully explored by MCTS
                    self._n = b2
                    continue
            else:
                batch = self.surrogate.propose(budget)
            self._n += len(batch)
            return batch

    def observe(self, schedule: Schedule, time: float) -> None:
        self.mcts.observe(schedule, time)
        self.surrogate.observe(schedule, time)

    # -- pool protocol: delegate to the exploitation phase -------------
    def propose_pool(self, budget: int) -> list[Schedule] | None:
        """``None`` through the greedy/MCTS phases (those proposals are
        never screened), then the surrogate phase's raw pool — so an
        acquisition-overriding :class:`repro_torch.driver.SearchDriver`
        screens exactly the proposals the built-in acquisition would
        have. Phase progress is tracked by ``propose``, which the
        driver still calls whenever this returns ``None``."""
        if self._n < self.seed_proposals + self.mcts_proposals:
            return None
        return self.surrogate.propose_pool(budget)

    def screen(self, pool: list[Schedule], budget: int,
               acquisition) -> list[Schedule]:
        return self.surrogate.screen(pool, budget, acquisition)

    def pad(self, chosen: list[Schedule],
            budget: int) -> list[Schedule]:
        return self.surrogate.pad(chosen, budget)

    def screening_quality(self) -> dict:
        return self.surrogate.screening_quality()
