"""The surrogates (``search/surrogate.py``, ``rules/boost.py``), the
acquisitions and the two-stage strategies against the JAX package's
(tests/test_surrogate_search.py and the acquisition tests of
tests/test_driver.py mirrored). Both packages see the same schedules
(drawn from one seed) and the reference's analytic times, so every
prediction, score and proposal must be the reference's bit for bit."""
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.core.dag as rdag  # noqa: E402
import repro.driver as RD  # noqa: E402
import repro.engine as RE  # noqa: E402
import repro.search as RS  # noqa: E402
from repro.rules.trees import forest_leaf_values as r_forest  # noqa: E402
from repro.space.schedule import canonical_key as r_canonical_key  # noqa: E402,E501
import repro_torch.core as TC  # noqa: E402
import repro_torch.search as TS  # noqa: E402
from repro_torch.driver import make_acquisition, predict_with_std  # noqa: E402,E501
from repro_torch.rules.trees import forest_leaf_values  # noqa: E402
from repro_torch.space.schedule import canonical_key  # noqa: E402

R_MACHINE = RC.Machine()
T_MACHINE = TC.Machine(**dataclasses.asdict(R_MACHINE))


def corpus(dag, n, seed):
    """``n`` random schedules of ``dag`` in both packages (the same
    draws) and the reference's analytic times for them."""
    rg, tg = getattr(rdag, dag)(), getattr(TC, dag)()
    rs = [RS.random_schedule(rg, 2, random.Random(seed + i))
          for i in range(n)]
    ts = [TS.random_schedule(tg, 2, random.Random(seed + i))
          for i in range(n)]
    assert [canonical_key(s) for s in ts] == \
        [r_canonical_key(s) for s in rs]
    with RE.make_evaluator(rg, "vectorized") as ev:
        times = ev.evaluate(rs)
    return rg, tg, rs, ts, times


def trained(pkg_search, graph, schedules, times, name, **kw):
    sur = pkg_search.make_surrogate(graph, name, **kw)
    for s, t in zip(schedules, times):
        sur.observe(s, t)
    return sur


@pytest.fixture(scope="module")
def spmv_corpus():
    return corpus("spmv_dag", 500, 0)


@pytest.fixture(scope="module")
def halo_boosted():
    """A boosted ensemble on 150 halo3d schedules in each package, and
    an 80-schedule pool to score."""
    rg, tg = rdag.halo3d_dag(), TC.halo3d_dag()
    rng_r, rng_t = random.Random(0), random.Random(0)
    rs = [RS.random_schedule(rg, 2, rng_r) for _ in range(230)]
    ts = [TS.random_schedule(tg, 2, rng_t) for _ in range(230)]
    with RE.make_evaluator(rg, "vectorized") as ev:
        times = ev.evaluate(rs[:150])
    rsur = trained(RS, rg, rs[:150], times, "boost", n_estimators=40)
    tsur = trained(TS, tg, ts[:150], times, "boost", n_estimators=40)
    return rsur, tsur, rs[150:], ts[150:], min(times)


def test_spearman_equals_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = rng.integers(0, 6, size=30).astype(float)    # many ties
        b = a + rng.standard_normal(30)
        assert TS.spearman(a, b) == RS.spearman(a, b)
    assert TS.spearman([1, 2, 3], [3, 2, 1]) == pytest.approx(-1.0)
    assert TS.spearman([1, 1, 1], [1, 2, 3]) == 0.0
    with pytest.raises(ValueError, match="length"):
        TS.spearman([1, 2], [1])


def test_ridge_predictions_equal_reference(spmv_corpus):
    rg, tg, rs, ts, times = spmv_corpus
    r = trained(RS, rg, rs[:300], times[:300], "ridge")
    t = trained(TS, tg, ts[:300], times[:300], "ridge")
    got, want = t.predict(ts[300:]), r.predict(rs[300:])
    np.testing.assert_array_equal(got, want)
    assert TS.spearman(got, times[300:]) > 0.8


def test_surrogates_predict_the_mean_without_features():
    tg = TC.spmv_dag()
    s = TS.random_schedule(tg, 2, random.Random(0))
    for name in ("ridge", "boost"):
        sur = TS.make_surrogate(tg, name, refit_every=1)
        assert sur.predict([s]).tolist() == [0.0]
        sur.observe(s, 3.0)
        sur.observe(s, 5.0)
        np.testing.assert_allclose(sur.predict([s]), [4.0])
    mu, sd = predict_with_std(TS.RidgeSurrogate(tg), [s])
    assert sd.tolist() == [0.0]


def test_boosted_predictions_equal_reference(halo_boosted):
    rsur, tsur, rpool, tpool, _ = halo_boosted
    np.testing.assert_array_equal(tsur.predict(tpool), rsur.predict(rpool))
    (tmu, tsd), (rmu, rsd) = tsur.predict_with_std(tpool), \
        rsur.predict_with_std(rpool)
    np.testing.assert_array_equal(tmu, rmu)
    np.testing.assert_array_equal(tsd, rsd)
    np.testing.assert_array_equal(tmu, tsur.predict(tpool))
    assert tsur.n_trees == rsur.n_trees >= 2 and np.any(tsd > 0.0)
    X = tsur.space.apply_features(tpool, tsur._features).astype(np.float64)
    H = forest_leaf_values(tsur._trees, X)
    np.testing.assert_array_equal(H, r_forest(rsur._trees, X))
    for row, tree in zip(H, tsur._trees):
        np.testing.assert_array_equal(row, tree.predict(X))
    with pytest.raises(ValueError, match="at least one tree"):
        forest_leaf_values([], X)


@pytest.mark.parametrize("name,kw", [
    ("argmin_topk", {}), ("ucb", {"beta": 0.0}), ("ucb", {"beta": 2.0}),
    ("expected_improvement", {}),
    ("expected_improvement", {"xi": -0.05}),
    ("expected_improvement", {"xi": 1e-6, "relative": False})])
def test_acquisition_scores_equal_reference(halo_boosted, name, kw):
    rsur, tsur, rpool, tpool, best = halo_boosted
    ts, tmu = make_acquisition(name, **kw)(tsur, tpool, best=best)
    rs, rmu = RD.make_acquisition(name, **kw)(rsur, rpool, best=best)
    np.testing.assert_array_equal(ts, rs)
    np.testing.assert_array_equal(tmu, rmu)
    assert np.argsort(ts, kind="stable").tolist() == \
        np.argsort(rs, kind="stable").tolist()


class Stub:
    def __init__(self, mu, sd):
        self._mu, self._sd = np.asarray(mu, float), np.asarray(sd, float)

    def predict(self, pool):
        return self._mu

    def predict_with_std(self, pool):
        return self._mu, self._sd


def test_expected_improvement_ranks_mean_then_uncertainty():
    ei = make_acquisition("expected_improvement")
    pool = [None] * 3
    s, mu = ei(Stub([1.0, 2.0, 3.0], [0.5] * 3), pool, best=2.5)
    assert s[0] < s[1] < s[2]
    s, _ = ei(Stub([2.0] * 3, [0.1, 0.5, 1.0]), pool, best=2.0)
    assert s[2] < s[1] < s[0]
    s, _ = ei(Stub([3.0, 1.0, 2.0], [1.0] * 3), pool, best=None)
    np.testing.assert_array_equal(s, [3.0, 1.0, 2.0])
    # Zero-EI candidates rank by mean behind every positive-EI one.
    s, _ = ei(Stub([2.0, 5.0, 3.0, 4.0], [0.5, 0.0, 0.0, 0.0]),
              [None] * 4, best=2.5)
    assert np.argsort(s, kind="stable").tolist() == [0, 2, 3, 1]
    with pytest.raises(ValueError):
        make_acquisition("ucb", beta=-1.0)


def drive(strategy, times_of, budget, batch):
    """propose/observe by hand; the proposals' canonical keys."""
    seen = []
    while len(seen) < budget:
        batch_ = strategy.propose(min(batch, budget - len(seen)))
        if not batch_:
            break
        for s, t in zip(batch_, times_of(batch_)):
            strategy.observe(s, t)
        seen += [canonical_key(s) for s in batch_]
    return seen


@pytest.mark.parametrize("surrogate", ["ridge", "boost"])
def test_surrogate_guided_proposes_the_reference_sequence(surrogate):
    """On spmv_dag_fine, where the pool is worth screening: the same
    proposals, round by round, and the same screening log."""
    rg, tg = rdag.spmv_dag_fine(), TC.spmv_dag_fine()
    kw = dict(seed=0, warmup=20, surrogate=surrogate)
    if surrogate == "boost":
        kw["surrogate_kwargs"] = {"n_estimators": 20}
    r, t = RS.SurrogateGuided(rg, 2, **kw), TS.SurrogateGuided(tg, 2, **kw)
    ev = RE.make_evaluator(rg, "vectorized")
    assert drive(t, ev.evaluate, 80, 4) == drive(r, ev.evaluate, 80, 4)
    assert t.screen_log == r.screen_log and t.n_screened > 0
    assert t.screening_quality() == r.screening_quality()


def test_portfolio_proposes_the_reference_sequence():
    rg, tg = RC.spmv_dag(), TC.spmv_dag()
    kw = dict(seed=0, seed_proposals=4, mcts_proposals=8, warmup=12)
    r = RS.PortfolioSearch(rg, 2, machine=R_MACHINE, **kw)
    t = TS.PortfolioSearch(tg, 2, machine=T_MACHINE, **kw)
    ev = RE.make_evaluator(rg, "vectorized")
    assert drive(t, ev.evaluate, 40, 1) == drive(r, ev.evaluate, 40, 1)
    assert t.greedy.n_prefix_sims == r.greedy.n_prefix_sims > 0
    assert t.mcts.root.n_rollouts == r.mcts.root.n_rollouts == 40
    assert t.screening_quality() == r.screening_quality()


def test_greedy_cost_model_equals_reference():
    for dag in ("spmv_dag", "spmv_dag_fine"):
        rg, tg = getattr(rdag, dag)(), getattr(TC, dag)()
        r = RS.GreedyCostModel(rg, 2, machine=R_MACHINE, seed=1)
        t = TS.GreedyCostModel(tg, 2, machine=T_MACHINE, seed=1)
        assert [canonical_key(s) for s in t.propose(6)] == \
            [r_canonical_key(s) for s in r.propose(6)]
        assert t.n_prefix_sims == r.n_prefix_sims


def test_greedy_on_the_h100_model_at_the_papers_size():
    """Under the H100 Machine() every SpMV schedule at the paper's size
    has one makespan, so greedy's pick is a valid schedule at that
    makespan, chosen by prefix makespans and item order."""
    g = TC.spmv_dag(rows_per_rank=37_500, nnz_per_rank=375_000,
                    value_bytes=4)
    greedy = TS.GreedyCostModel(g, 2)
    (s,) = greedy.propose(1)
    TC.validate_schedule(g, s)
    every = {TC.makespan(g, x) for x in TC.enumerate_schedules(g, 2)}
    assert len({round(t * 1e12) for t in every}) == 1
    assert round(TC.makespan(g, s) * 1e12) == round(min(every) * 1e12)


def test_surrogate_registry_and_arguments():
    assert sorted(TS.SURROGATES) == sorted(RS.SURROGATES)
    tg = TC.spmv_dag()
    with pytest.raises(ValueError, match="unknown surrogate"):
        TS.make_surrogate(tg, "nope")
    with pytest.raises(ValueError, match="l2"):
        TS.SurrogateGuided(tg, 2, surrogate="boost", l2=1.0)
    with pytest.raises(ValueError, match="pre-built"):
        TS.SurrogateGuided(tg, 2, surrogate=TS.RidgeSurrogate(tg),
                           refit_every=3)
    with pytest.raises(ValueError, match="pool_factor"):
        TS.SurrogateGuided(tg, 2, pool_factor=0)


def test_portfolio_survives_an_exhausted_space():
    g = TC.Graph()
    g.add_op(TC.Op("k1", TC.OpKind.GPU, duration=2e-6))
    g.add_op(TC.Op("k2", TC.OpKind.GPU, duration=3e-6))
    g.add_edge("k1", "k2")
    g.finalize()
    n_space = len(list(TC.enumerate_schedules(g, 2)))
    port = TS.PortfolioSearch(g, 2, seed=0, seed_proposals=2,
                              mcts_proposals=10**6, warmup=4)
    res = TS.run_search(g, port, budget=50, backend="sim")
    assert res.n_proposed == 50 and len(res.schedules) == n_space
