"""The whole of ``rules/trees.py`` and the out-of-core distill against
the JAX package's (tests/test_rules_trees.py and
tests/test_histogram_trees.py mirrored): dense classification and
regression trees equal the reference's; trees grown from blockwise
class-count histograms equal the dense tree on the exhaustive SpMV
space and on a small halo3d corpus; the HistogramSink's distill equals
the DatasetSink's and the reference's; ``decode_batch`` round-trips."""
import dataclasses

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # no hypothesis installed: the seeded fallback
    from _hypothesis_fallback import given, settings, strategies as st

torch = pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.core.dag as rdag  # noqa: E402
import repro.driver as RD  # noqa: E402
import repro.rules.trees as RT  # noqa: E402
import repro.search as RS  # noqa: E402
import repro_torch.core as TC  # noqa: E402
import repro_torch.rules as TR  # noqa: E402
import repro_torch.search as TS  # noqa: E402
from repro_torch.driver import (DatasetSink, HistogramSink,  # noqa: E402
                                SearchDriver)
from repro_torch.rules.trees import (ClassCountHistogram,  # noqa: E402
                                     HistogramGrower, Presort,
                                     RegressionTree,
                                     algorithm1_from_histograms,
                                     fit_from_histograms)
from repro_torch.space import as_space, demo_param_space  # noqa: E402

T_MACHINE = TC.Machine(**dataclasses.asdict(RC.Machine()))


def tree_signature(tree):
    """(feature, threshold) preorder + leaf stats: the whole structure."""
    out = []

    def walk(nd):
        if nd.is_leaf:
            out.append(("leaf", nd.n_samples, nd.majority_class()))
            return
        out.append((nd.feature, nd.threshold))
        walk(nd.left)
        walk(nd.right)

    walk(tree.root)
    return out


def blocks(X, block):
    """A re-callable block stream over a materialized matrix."""
    return lambda: (X[i:i + block] for i in range(0, len(X), block))


def random_dataset(rng, kind):
    n, d = int(rng.integers(8, 120)), int(rng.integers(1, 10))
    if kind == 0:                       # the paper's 0/1 features
        X = rng.integers(0, 2, size=(n, d)).astype(float)
    elif kind == 1:                     # small-cardinality ordinals
        X = rng.integers(0, 4, size=(n, d)).astype(float)
    elif kind == 2:                     # continuous
        X = np.round(rng.random((n, d)), 3)
    else:                               # mixed + constant columns
        X = np.concatenate(
            [rng.integers(0, 2, size=(n, d)).astype(float),
             np.round(rng.random((n, 2)), 3), np.ones((n, 1))], axis=1)
    return X, rng.integers(0, int(rng.integers(2, 5)), size=n)


# -- dense trees ------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.sampled_from([0, 1, 2, 3]))
def test_dense_trees_equal_reference(seed, kind):
    """Both splitters, with and without a max depth, the Algorithm-1
    sweep, and a regression tree on the same rows: the reference's
    trees."""
    rng = np.random.default_rng(seed)
    X, y = random_dataset(rng, kind)
    mln = int(rng.integers(2, 10))
    for splitter in ("vectorized", "loop"):
        for depth in (None, 3):
            got = TR.DecisionTree(mln, depth, splitter=splitter).fit(X, y)
            want = RT.DecisionTree(mln, depth, splitter=splitter).fit(X, y)
            assert tree_signature(got) == tree_signature(want)
            np.testing.assert_array_equal(got.predict(X), want.predict(X))
    tr, rr = TR.TreeSearchTrace([], [], []), RT.TreeSearchTrace([], [], [])
    got, want = TR.algorithm1(X, y, trace=tr), RT.algorithm1(X, y, trace=rr)
    assert tree_signature(got) == tree_signature(want)
    assert (tr.max_leaf_nodes, tr.errors) == (rr.max_leaf_nodes, rr.errors)
    target = rng.standard_normal(len(y))
    ps = Presort(X)
    got = RegressionTree(max_leaf_nodes=mln).fit(X, target, presort=ps)
    want = RT.RegressionTree(max_leaf_nodes=mln).fit(X, target)
    np.testing.assert_array_equal(got.predict(X), want.predict(X))
    assert (got.n_leaves(), got.depth()) == (want.n_leaves(), want.depth())


# -- histogram trees equal dense trees ---------------------------------------

def test_histogram_tree_equals_dense_on_the_exhaustive_spmv_space():
    """The 280 SpMV schedules labelled by the reference's makespans: the
    histogram path's Algorithm-1 sweep is the dense one, trial for
    trial, and both are the reference's."""
    g = TC.spmv_dag()
    scheds = list(TC.enumerate_schedules(g, 2))
    rg = RC.spmv_dag()
    times = np.array([RC.makespan(rg, s) for s in
                      RC.enumerate_schedules(rg, 2)])
    lab = TR.label_times(times)
    fm = TC.featurize(g, scheds)
    dense_trace = TR.TreeSearchTrace([], [], [])
    dense = TR.algorithm1(fm.X, lab.labels, trace=dense_trace)
    ooc_trace = TR.TreeSearchTrace([], [], [])
    ooc = algorithm1_from_histograms(blocks(fm.X, 64), lab.labels,
                                     trace=ooc_trace)
    assert tree_signature(dense) == tree_signature(ooc)
    np.testing.assert_array_equal(dense.predict(fm.X), ooc.predict(fm.X))
    assert (dense_trace.max_leaf_nodes, dense_trace.errors) == \
        (ooc_trace.max_leaf_nodes, ooc_trace.errors)
    ref = RT.algorithm1_from_histograms(blocks(fm.X, 64), lab.labels)
    assert tree_signature(ref) == tree_signature(ooc)


def test_histogram_tree_equals_dense_on_a_halo3d_corpus():
    """400 random halo3d schedules, max-depth-capped and through the
    whole sweep, one grower reused across it."""
    g = TC.halo3d_dag()
    res = TS.run_search(g, TS.RandomSearch(g, seed=0), budget=400,
                        batch_size=64, backend="vectorized",
                        machine=T_MACHINE)
    fm, lab, _ = res.dataset()
    X = np.asarray(fm.X, dtype=np.float64)
    dense = TR.DecisionTree(max_leaf_nodes=12, max_depth=6).fit(
        X, lab.labels)
    ooc = fit_from_histograms(blocks(fm.X, 57), lab.labels,
                              max_leaf_nodes=12, max_depth=6)
    assert tree_signature(dense) == tree_signature(ooc)
    np.testing.assert_array_equal(dense.predict(X), ooc.predict(X))
    grower = HistogramGrower(blocks(fm.X, 57), lab.labels)
    full = algorithm1_from_histograms(blocks(fm.X, 57), lab.labels,
                                      grower=grower)
    assert tree_signature(full) == tree_signature(
        TR.algorithm1(X, lab.labels))
    assert grower.training_error(full) == \
        full.training_error(X, lab.labels)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.sampled_from([0, 1, 2, 3]),
       st.integers(min_value=1, max_value=200))
def test_histogram_fit_invariant_to_block_size(seed, kind, block):
    rng = np.random.default_rng(seed)
    X, y = random_dataset(rng, kind)
    mln = int(rng.integers(2, 10))
    want = tree_signature(TR.DecisionTree(max_leaf_nodes=mln).fit(X, y))
    for b in {1, block, len(X)}:
        ooc = fit_from_histograms(blocks(X, b), y, max_leaf_nodes=mln)
        assert tree_signature(ooc) == want, b


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.sampled_from([0, 1, 2, 3]))
def test_histogram_subtraction_equals_a_fresh_scan(seed, kind):
    """Every frontier histogram, half of them made by ``parent - left``,
    equals a fresh scan of the rows that reach its node."""
    rng = np.random.default_rng(seed)
    X, y = random_dataset(rng, kind)
    grower = HistogramGrower(blocks(X, 13), y)
    tree = grower.fit(max_leaf_nodes=8)

    def path_mask(nd, target, mask):
        if nd is target:
            return mask
        if nd.left is None:
            return None
        col = X[:, nd.feature] <= nd.threshold
        got = path_mask(nd.left, target, mask & col)
        return got if got is not None else \
            path_mask(nd.right, target, mask & ~col)

    for nd in grower._frontier:
        if nd.hist is None:
            continue
        mask = path_mask(grower.root, nd, np.ones(len(X), dtype=bool))
        fresh = ClassCountHistogram(grower.values, grower.n_classes)
        fresh.add(X[mask], grower.y_enc[mask])
        np.testing.assert_array_equal(nd.hist.counts, fresh.counts)
    assert tree_signature(tree) == tree_signature(
        TR.DecisionTree(max_leaf_nodes=8).fit(X, y))
    empty = ClassCountHistogram(grower.values, grower.n_classes)
    one = ClassCountHistogram(grower.values, grower.n_classes)
    one.add(X[:1], grower.y_enc[:1])
    with pytest.raises(ValueError, match="sub-histogram"):
        empty.subtract(one)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_class_count_histogram_merge_equals_one_stream(seed):
    rng = np.random.default_rng(seed)
    d, k = int(rng.integers(1, 6)), int(rng.integers(2, 5))
    grids = [np.unique(np.round(rng.random(int(rng.integers(1, 5))), 2))
             for _ in range(d)]
    shards, single = [], ClassCountHistogram(grids, k)
    r_single = RT.ClassCountHistogram(grids, k)
    for _ in range(int(rng.integers(2, 5))):
        m = int(rng.integers(0, 40))
        X = np.stack([g[rng.integers(0, g.size, m)] for g in grids],
                     axis=1) if m else np.zeros((0, d))
        y = rng.integers(0, k, m).astype(np.int32)
        single.add(X, y)
        r_single.add(X, y)
        sh = ClassCountHistogram([np.unique(X[:, j]) if m else grids[j][:1]
                                  for j in range(d)], k)
        sh.add(X, y)
        shards.append(sh)
    np.testing.assert_array_equal(single.counts, r_single.counts)
    acc = shards[0]
    for sh in shards[1:]:
        acc = acc.merge(sh)
    onto = ClassCountHistogram(grids, k).merge(acc)
    np.testing.assert_array_equal(onto.counts, single.counts)


# -- the histogram sink -----------------------------------------------------

def assert_same_report(a, b):
    assert tree_signature(a.tree) == tree_signature(b.tree)
    assert a.training_error == b.training_error
    assert a.n_schedules == b.n_schedules
    assert [(r.class_label, r.rules, r.n_samples, r.pure)
            for r in a.rulesets] == \
        [(r.class_label, r.rules, r.n_samples, r.pure) for r in b.rulesets]
    assert (a.trace.max_leaf_nodes, a.trace.errors) == \
        (b.trace.max_leaf_nodes, b.trace.errors)
    assert a.render() == b.render()


def test_histogram_sink_distill_equals_dataset_sink_and_reference():
    """One driver run feeding both sinks on halo3d: the out-of-core
    distill is the dense one (the same pruned features, tree, rules and
    error) without a row of the matrix, and both are the reference's."""
    g, rg = TC.halo3d_dag(), rdag.halo3d_dag()
    ds, hs = DatasetSink(g), HistogramSink(g, block_rows=97)
    SearchDriver(g, TS.RandomSearch(g, seed=0), budget=300, batch_size=64,
                 backend="vectorized", machine=T_MACHINE,
                 sinks=[ds, hs]).run()
    r_hs = RD.HistogramSink(rg, block_rows=97)
    RD.SearchDriver(rg, RS.RandomSearch(rg, seed=0), budget=300,
                    batch_size=64, backend="vectorized",
                    sinks=[r_hs]).run()
    assert hs.n_rows == len(ds.schedules) == r_hs.n_rows
    assert hs.times == ds.times == r_hs.times
    assert hs.feature_list() == ds.matrix().features
    assert [(f.kind, f.u, f.v) for f in hs.feature_list()] == \
        [(f.kind, f.u, f.v) for f in r_hs.feature_list()]
    rd, rh = ds.distill(), hs.distill()
    assert_same_report(rd, rh)
    assert rh.feature_matrix.X.shape == (0, len(rh.feature_matrix.features))
    assert {"label", "featurize", "tree", "rules"} <= set(rh.stage_seconds)
    ref = r_hs.distill()
    assert tree_signature(ref.tree) == tree_signature(rh.tree)
    assert ref.render() == rh.render()


def test_histogram_sink_merge_equals_sequential_consume():
    g = TC.halo3d_dag()

    def run(seed, sink):
        SearchDriver(g, TS.RandomSearch(g, seed=seed), budget=150,
                     batch_size=64, backend="vectorized",
                     sinks=[sink]).run()

    h1, h2, both = HistogramSink(g), HistogramSink(g), HistogramSink(g)
    run(1, h1)
    run(2, h2)
    run(1, both)
    run(2, both)
    h1.merge(h2)
    assert h1.n_rows == both.n_rows and h1.times == both.times
    assert h1.histogram.hi == both.histogram.hi
    np.testing.assert_array_equal(h1.histogram.counts,
                                  both.histogram.counts)
    assert_same_report(h1.distill(), both.distill())
    with pytest.raises(TypeError):
        h1.merge(object())


def test_histogram_sink_on_a_param_space():
    sp = demo_param_space()
    ds, hs = DatasetSink(sp), HistogramSink(sp, block_rows=7)
    SearchDriver(sp, TS.ExhaustiveSearch(sp), budget=None, batch_size=8,
                 backend="sim", sinks=[ds, hs]).run()
    assert hs.n_rows == len(ds.schedules) == sp.n_candidates()
    assert_same_report(ds.distill(), hs.distill())


def test_distill_refuses_a_corpus_of_the_wrong_length():
    g = TC.halo3d_dag()
    hs = HistogramSink(g)
    SearchDriver(g, TS.RandomSearch(g, seed=0), budget=64, batch_size=16,
                 backend="vectorized", sinks=[hs]).run()
    hs.times = hs.times[:-1]
    with pytest.raises(ValueError, match="rows"):
        TR.distill(hs, histograms=hs)
    with pytest.raises(ValueError, match="not both"):
        TR.distill(hs, histograms=hs, features=object())


def test_decode_batch_round_trips():
    """decode_batch(encode_batch(c)) is the canonical candidate, from
    the (B, 2, N) rows and from the flat key bytes, for schedules and
    parameter grids, and equals the reference's decoding."""
    from repro.space.base import as_space as r_as_space
    g = TC.spmv_dag()
    sp, r_sp = as_space(g), r_as_space(RC.spmv_dag())
    scheds = list(TC.enumerate_schedules(g, 2))[:40]
    keys, enc = sp.encode_batch(scheds)
    assert sp.encode_batch(sp.decode_batch(enc))[0] == keys
    flat = np.stack([np.frombuffer(k, dtype=np.int32) for k in keys])
    assert sp.encode_batch(sp.decode_batch(flat))[0] == keys
    assert [[(i.name, i.stream) for i in s.items]
            for s in sp.decode_batch(enc)] == \
        [[(i.name, i.stream) for i in s.items]
         for s in r_sp.decode_batch(enc)]
    demo = demo_param_space()
    cands = list(demo.enumerate_candidates())
    assert demo.decode_batch(demo.encode_batch(cands)[1]) == cands
    with pytest.raises(ValueError, match="out of range"):
        demo.decode_batch(np.full((1, len(demo.dims)), 99, dtype=np.int32))
    uni = demo.feature_universe().add(cands)
    assert uni.candidate_features() == demo.all_features() and len(uni)
