"""The port's copied core, space and rules modules against the JAX
package: the same DAGs, schedules, sync expansions, features, labels,
trees and rules, item for item."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
from repro.core import dag as rdag  # noqa: E402
from repro.space.schedule import canonical_key as r_canonical_key  # noqa: E402
from repro.space.schedule import eligible_items as r_eligible  # noqa: E402
from repro.space.schedule import random_schedule as r_random  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch import rules as TR  # noqa: E402
from repro_torch.space.schedule import (canonical_key, eligible_items,  # noqa: E402
                                        random_schedule)

BUILDERS = ["spmv_dag", "spmv_dag_fine", "halo3d_dag"]


def to_port(s):
    return TC.Schedule(tuple(TC.BoundOp(i.name, i.stream) for i in s.items))


def graphs(name):
    return getattr(rdag, name)(), getattr(TC, name)()


def items(expanded):
    return [(e.name, e.kind, e.stream, e.anchor, e.waits) for e in expanded]


@pytest.fixture(scope="module")
def spmv_space():
    rg, tg = RC.spmv_dag(), TC.spmv_dag()
    rs = list(RC.enumerate_schedules(rg, 2))
    times = np.array([RC.makespan(rg, s) for s in rs])
    return rg, tg, rs, [to_port(s) for s in rs], times


@pytest.mark.parametrize("name", BUILDERS)
def test_dag_identical(name):
    rg, tg = graphs(name)
    assert list(rg.ops) == list(tg.ops)
    for n, op in rg.ops.items():
        top = tg.ops[n]
        assert (op.kind.value, op.flops, op.bytes_hbm, op.comm_bytes,
                op.comm_role.value, op.duration) == \
            (top.kind.value, top.flops, top.bytes_hbm, top.comm_bytes,
             top.comm_role.value, top.duration)
        assert rg.preds[n] == tg.preds[n] and rg.succs[n] == tg.succs[n]
    assert rg.topological_order() == tg.topological_order()
    assert rg.gpu_ops() == tg.gpu_ops()


@pytest.mark.parametrize("n_streams", [1, 2, 3])
def test_enumerate_identical(n_streams):
    rg, tg = RC.spmv_dag(), TC.spmv_dag()
    r = [s.key() for s in RC.enumerate_schedules(rg, n_streams)]
    t = [s.key() for s in TC.enumerate_schedules(tg, n_streams)]
    assert r == t
    if n_streams == 2:
        assert len(t) == 280


def test_expand_identical_on_all_280(spmv_space):
    rg, tg, rs, ts, _ = spmv_space
    for r, t in zip(rs, ts):
        assert items(RC.expand(rg, r)) == items(TC.expand(tg, t))
        assert RC.expanded_names(rg, r) == TC.expanded_names(tg, t)
        assert r_canonical_key(r) == canonical_key(t)


def test_expanded_names_matches_expand(spmv_space):
    _, tg, _, ts, _ = spmv_space
    for t in ts:
        assert TC.expanded_names(tg, t) == \
            [e.name for e in TC.expand(tg, t)]


@pytest.mark.parametrize("name", BUILDERS)
@pytest.mark.parametrize("n_streams", [2, 3])
def test_random_schedules_and_moves_identical(name, n_streams):
    """Same RNG, same rollouts; same moves from every prefix; same
    expansion and validity on larger DAGs than the exhaustive one."""
    rg, tg = graphs(name)
    r_rng, t_rng = random.Random(5), random.Random(5)
    for _ in range(25):
        r = r_random(rg, n_streams, r_rng)
        t = random_schedule(tg, n_streams, t_rng)
        assert r.key() == t.key()
        TC.validate_schedule(tg, t)
        assert items(RC.expand(rg, r)) == items(TC.expand(tg, t))
        for cut in range(len(r.items)):
            assert [(b.name, b.stream) for b in
                    r_eligible(rg, list(r.items[:cut]), n_streams)] == \
                [(b.name, b.stream) for b in
                 eligible_items(tg, list(t.items[:cut]), n_streams)]


def test_canonicalize_streams_identical():
    rg, tg = RC.spmv_dag(), TC.spmv_dag()
    rng = random.Random(3)
    for _ in range(20):
        r = r_random(rg, 3, rng)
        relabeled = [RC.BoundOp(i.name, None if i.stream is None
                                else 7 - i.stream) for i in r.items]
        assert [(b.name, b.stream) for b in
                RC.canonicalize_streams(relabeled)] == \
            [(b.name, b.stream) for b in TC.canonicalize_streams(
                [TC.BoundOp(b.name, b.stream) for b in relabeled])]


@pytest.mark.parametrize("subset", ["all", "first_100", "random_60"])
def test_featurize_identical(spmv_space, subset):
    rg, tg, rs, ts, _ = spmv_space
    sel = {"all": list(range(len(rs))), "first_100": list(range(100)),
           "random_60": sorted(np.random.default_rng(4).choice(
               len(rs), 60, replace=False).tolist())}[subset]
    rf = RC.featurize(rg, [rs[i] for i in sel])
    tf = TC.featurize(tg, [ts[i] for i in sel])
    assert rf.names() == tf.names()
    np.testing.assert_array_equal(rf.X, tf.X)
    assert tf.X.dtype == np.int8


def test_featurize_degenerate_raises():
    tg = TC.spmv_dag()
    s = next(TC.enumerate_schedules(tg, 2))
    with pytest.raises(TC.DegenerateFeatureSpaceError):
        TC.featurize(tg, [s, s])


def _noisy(times, seed, sigma):
    if sigma == 0:
        return times
    rng = np.random.default_rng(seed)
    return times * (1.0 + sigma * rng.standard_normal(times.size))


@pytest.mark.parametrize("seed,sigma", [(0, 0.0), (1, 0.02), (2, 0.1)])
def test_label_times_identical(spmv_space, seed, sigma):
    from repro.rules.labels import label_times as r_label
    times = _noisy(spmv_space[4], seed, sigma)
    r, t = r_label(times), TR.label_times(times)
    for f in ("order", "sorted_times", "convolution", "boundaries",
              "labels"):
        np.testing.assert_array_equal(getattr(r, f), getattr(t, f))
    assert r.n_classes == t.n_classes
    assert r.class_ranges() == t.class_ranges()


@pytest.mark.parametrize("seed,sigma", [(0, 0.0), (1, 0.02), (2, 0.1)])
def test_algorithm1_same_tree_and_rules(spmv_space, seed, sigma):
    """The port's loop-splitter Algorithm 1 gives the reference's tree
    (vectorized splitter) and therefore the same rules text."""
    from repro.rules import rulesets as rrs
    from repro.rules.labels import label_times as r_label
    from repro.rules.trees import algorithm1 as r_alg1
    rg, _, rs, _, times = spmv_space
    times = _noisy(times, seed, sigma)
    fm = RC.featurize(rg, rs)
    y = r_label(times).labels
    rt, tt = r_alg1(fm.X, y), TR.algorithm1(fm.X, y)
    assert (rt.n_leaves(), rt.depth()) == (tt.n_leaves(), tt.depth())
    np.testing.assert_array_equal(rt.predict(fm.X), tt.predict(fm.X))
    assert rt.training_error(fm.X, y) == tt.training_error(fm.X, y)
    r_text = rrs.render_rules_table(rrs.rules_by_class(
        rrs.extract_rulesets(rt, fm.features)), top_k=5)
    t_feats = [TC.Feature(f.kind, f.u, f.v) for f in fm.features]
    t_text = TR.render_rules_table(TR.rules_by_class(
        TR.extract_rulesets(tt, t_feats)), top_k=5)
    assert r_text == t_text and "performance class" in t_text


def test_decision_tree_validates_inputs():
    with pytest.raises(ValueError):
        TR.DecisionTree(max_leaf_nodes=1)
    with pytest.raises(ValueError):
        TR.DecisionTree(4).fit(np.zeros((3, 2)), np.zeros(2))
