"""Gradient-boosted tree surrogate on the pairwise features (§IV-B).

The ridge surrogate in :mod:`repro_torch.search.surrogate` is linear
in the order/stream features, while the
makespan of a schedule depends on feature *interactions* (an ordering
only matters on the critical path the stream assignment creates). Tree
ensembles are the standard answer for this class of cost model (OptiML;
Penney & Chen's survey), and the vectorized split kernel in
:mod:`repro_torch.rules.trees` makes them cheap: one :class:`~
repro_torch.rules.trees.Presort` of the feature matrix serves every boosting
round.

:class:`GradientBoostedSurrogate` implements the same online protocol
as ``RidgeSurrogate`` (``observe`` / ``predict`` / ``n_observations``)
— both now share :class:`OnlineSurrogateBase`, the corpus/refit
bookkeeping — and registers under the name ``"boost"`` in the
:data:`repro_torch.search.surrogate.SURROGATES` registry, so
``SurrogateGuided(surrogate="boost")`` / ``PortfolioSearch`` screen
with it unchanged.

This module deliberately imports nothing from :mod:`repro_torch.search`
(the dependency points search -> rules, never back). The JAX package's
``repro/rules/boost.py`` with its imports rewritten.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dag import Graph, Schedule
from repro_torch.core.features import Feature
from repro_torch.rules.trees import Presort, RegressionTree, forest_leaf_values
from repro_torch.space.base import DesignSpace, as_space


class OnlineSurrogateBase:
    """Corpus + refit bookkeeping shared by the online surrogates.

    Observations accumulate into the design space's incremental
    feature basis (:class:`~repro_torch.core.features.FeatureBasis` for
    schedule spaces, the threshold basis for parameter grids);
    subclasses implement
    ``_fit`` (rebuild the model from the whole corpus) and are refit
    lazily — on the first ``predict`` after the corpus has grown past a
    geometric-backoff threshold. Each refit rebuilds the feature matrix
    for the whole corpus, so refitting every k observations would make
    cumulative featurization cost quadratic on long runs; waiting for
    ~25% corpus growth past the ``refit_every`` floor keeps it linear
    (amortized) while the model stays fresh.
    """

    def __init__(self, graph: "Graph | DesignSpace",
                 refit_every: int = 8):
        self.space = as_space(graph)
        self.graph = getattr(self.space, "graph", None)
        self.refit_every = max(1, refit_every)
        self.basis = self.space.feature_basis()
        self._times: list[float] = []
        self._fitted_n = -1          # observation count at last fit

    @property
    def n_observations(self) -> int:
        return len(self._times)

    def observe(self, schedule: Schedule, time: float) -> None:
        self.basis.add([schedule])
        self._times.append(float(time))

    def _stale(self) -> bool:
        if self._fitted_n < 0:
            return True
        wait = max(self.refit_every, self._fitted_n // 4)
        return len(self._times) - self._fitted_n >= wait

    def _fit(self) -> None:
        raise NotImplementedError


class GradientBoostedSurrogate(OnlineSurrogateBase):
    """Least-squares gradient boosting over order/stream features.

    Stagewise additive model: start from the mean observed time, then
    repeatedly fit a small :class:`~repro_torch.rules.trees.RegressionTree`
    to the residuals and add ``learning_rate`` times its prediction.
    All rounds of one refit share a single :class:`Presort` (the
    feature matrix is fixed within a fit; only residuals change), so a
    full refit is one argsort plus ``n_estimators`` passes of the
    vectorized split kernel. Boosting stops early when a round's tree
    cannot split or the training MSE stops improving.

    With no (or degenerate) data it predicts the observed mean —
    exactly the ridge surrogate's fallback contract.
    """

    def __init__(self, graph: Graph, n_estimators: int = 200,
                 learning_rate: float = 0.05, max_leaf_nodes: int = 8,
                 max_depth: int | None = None, refit_every: int = 8,
                 tol: float = 1e-5):
        super().__init__(graph, refit_every=refit_every)
        if n_estimators < 1:
            raise ValueError("n_estimators must be >= 1")
        if not 0.0 < learning_rate <= 1.0:
            raise ValueError("learning_rate must be in (0, 1]")
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_leaf_nodes = max_leaf_nodes
        self.max_depth = max_depth
        self.tol = tol
        self._trees: list[RegressionTree] = []
        self._features: list[Feature] = []
        self._y_mean = 0.0

    def _fit(self) -> None:
        self._fitted_n = len(self._times)
        y = np.asarray(self._times, dtype=np.float64)
        self._y_mean = float(y.mean()) if y.size else 0.0
        self._trees, self._features = [], []
        if y.size < 2:
            return
        fm = self.basis.matrix()
        if not fm.features:
            return  # all observations identical: mean is the best guess
        X = fm.X.astype(np.float64)
        self._features = fm.features
        ps = Presort(X)
        F = np.full(y.size, self._y_mean)
        mse = float(np.mean((y - F) ** 2))
        for _ in range(self.n_estimators):
            t = RegressionTree(max_leaf_nodes=self.max_leaf_nodes,
                               max_depth=self.max_depth).fit(
                                   X, y - F, presort=ps)
            if t.n_leaves() < 2:
                break           # residuals carry no splittable signal
            F = F + self.learning_rate * t.predict(X)
            new_mse = float(np.mean((y - F) ** 2))
            self._trees.append(t)
            if mse - new_mse <= self.tol * mse:   # relative improvement
                break
            mse = new_mse

    def _leaf_matrix(self, schedules: list[Schedule]) -> np.ndarray:
        """(n_trees, n_schedules) per-tree leaf values, one descent."""
        X = self.space.apply_features(schedules, self._features) \
            .astype(np.float64)
        return forest_leaf_values(self._trees, X)

    def predict(self, schedules: list[Schedule]) -> np.ndarray:
        """Predicted times, one per schedule (refits if stale)."""
        if self._stale():
            self._fit()
        out = np.full(len(schedules), self._y_mean, dtype=np.float64)
        if not self._trees or not schedules:
            return out
        # One batched leaf-gather for the whole ensemble; the
        # accumulation stays sequential in boosting-round order, so
        # predictions are bit-identical to summing t.predict(X) per
        # round (each H row IS that round's t.predict(X)).
        for row in self._leaf_matrix(schedules):
            out += self.learning_rate * row
        return out

    def predict_with_std(self, schedules: list[Schedule]
                         ) -> tuple[np.ndarray, np.ndarray]:
        """(predicted time, predictive deviation) per schedule.

        The deviation is ensemble disagreement: treat each boosting
        round's scaled contribution ``c_t(x) = lr * h_t(x)`` as one of
        ``T`` votes on the total correction and report the deviation
        the sum would have if the votes were independent —
        ``sd(x) = sqrt(T * Var_t(c_t(x)))`` (the bagging-style proxy;
        cf. virtual ensembles for gradient boosting). Where every
        round lands ``x`` in leaves with similar values the model has
        settled (sd -> 0); rounds pulling in different directions —
        feature-space regions the corpus barely covers — inflate sd.
        Exactly zero deviation with fewer than two trees (or no data),
        so downstream acquisitions degrade to mean-ranking on a cold
        model. The mean equals :meth:`predict` bit-for-bit.
        """
        if self._stale():
            self._fit()
        n = len(schedules)
        mu = np.full(n, self._y_mean, dtype=np.float64)
        sd = np.zeros(n, dtype=np.float64)
        if not self._trees or not schedules:
            return mu, sd
        C = self.learning_rate * self._leaf_matrix(schedules)
        for row in C:             # same accumulation order as predict
            mu += row
        if C.shape[0] >= 2:
            sd = np.sqrt(C.shape[0]
                         * np.maximum(C.var(axis=0, ddof=1), 0.0))
        return mu, sd

    @property
    def n_trees(self) -> int:
        return len(self._trees)
