"""MCTS and the search loop against the JAX package: fed the same
times (the reference's analytic makespan), the port visits the same
schedules in the same order and reports the same result."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.search as RS  # noqa: E402
from repro.space.schedule import canonical_key as r_canonical_key  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.engine.base import EvaluatorBase  # noqa: E402
from repro_torch.search import MCTSSearch, run_search  # noqa: E402
from repro_torch.search.pipeline import SearchResult, tie_key  # noqa: E402
from repro_torch.space.schedule import canonical_key  # noqa: E402


class TableEvaluator(EvaluatorBase):
    """Times looked up by canonical key (computed on the JAX side)."""

    backend = "table"

    def __init__(self, graph, table):
        super().__init__(graph)
        self.table = table
        self.measured: list[tuple] = []

    def _measure_batch(self, schedules, encoded=None):
        keys = [canonical_key(s) for s in schedules]
        self.measured += keys
        return [self.table[k] for k in keys]


@pytest.fixture(scope="module")
def makespans():
    rg = RC.spmv_dag()
    return {r_canonical_key(s): RC.makespan(rg, s)
            for s in RC.enumerate_schedules(rg, 2)}


@pytest.mark.parametrize("budget,batch_size,seed", [
    (200, 1, 0), (200, 1, 1), (60, 1, 2), (120, 4, 0), (150, 7, 3),
    (1000, 1, 0)])
def test_mcts_trajectory_matches_reference(makespans, budget, batch_size,
                                           seed):
    rg, tg = RC.spmv_dag(), TC.spmv_dag()
    ref = RS.run_search(rg, RS.MCTSSearch(rg, 2, seed=seed),
                        budget=budget, batch_size=batch_size)
    ev = TableEvaluator(tg, makespans)
    got = run_search(tg, MCTSSearch(tg, 2, seed=seed), ev, budget=budget,
                     batch_size=batch_size)
    assert [canonical_key(s) for s in got.schedules] == \
        [r_canonical_key(s) for s in ref.schedules]
    assert got.times == ref.times
    assert (got.n_proposed, got.cache_hits, got.cache_misses) == \
        (ref.n_proposed, ref.cache_hits, ref.cache_misses)
    rb, tb = ref.best(), got.best()
    assert r_canonical_key(rb[0]) == canonical_key(tb[0]) and rb[1] == tb[1]
    np.testing.assert_array_equal(got.times_array(), ref.times_array())
    # Each distinct schedule was measured once, in first-seen order.
    assert ev.measured == [canonical_key(s) for s in got.schedules]


def test_mcts_exhausts_the_space(makespans):
    tg = TC.spmv_dag()
    strategy = MCTSSearch(tg, 2, seed=0)
    res = run_search(tg, strategy, TableEvaluator(tg, makespans),
                     budget=1000)
    assert strategy.exhausted() and len(res.schedules) == 280
    assert res.n_proposed == 280 and strategy.propose(5) == []


def test_evaluator_memo_counts_hits_and_misses(makespans):
    tg = TC.spmv_dag()
    ev = TableEvaluator(tg, makespans)
    s = list(TC.enumerate_schedules(tg, 2))[:3]
    relabeled = TC.Schedule(tuple(
        TC.BoundOp(i.name, None if i.stream is None else 1 - i.stream)
        for i in s[0].items))
    t = ev.evaluate([s[0], s[1], s[0], relabeled, s[2]])
    assert t[0] == t[2] == t[3]
    assert (ev.cache_misses, ev.cache_hits, len(ev)) == (3, 2, 3)
    assert len(ev.measured) == 3


def test_best_breaks_ties_by_canonical_encoding():
    tg = TC.spmv_dag()
    s = list(TC.enumerate_schedules(tg, 2))[:3]
    res = SearchResult(tg, [s[2], s[1], s[0]], [1.0, 1.0, 2.0], 3, 0, 3)
    assert res.best()[0] == min(s[2], s[1], key=tie_key)
    with pytest.raises(ValueError):
        SearchResult(tg, [], [], 0, 0, 0).best()
