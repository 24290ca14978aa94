"""The search driver (``driver/``), the run_search wrapper over it, the
acquisitions and the streaming sinks against the JAX package's
(tests/test_driver.py mirrored). Both packages search spmv_dag() under
the reference's TPU-like constants, passed to the port explicitly, so
every evaluation is the same float and every trajectory, chosen batch
and streamed dataset must be the reference's bit for bit."""
import dataclasses

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # no hypothesis installed: the seeded fallback
    from _hypothesis_fallback import given, settings, strategies as st

torch = pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.driver as RD  # noqa: E402
import repro.search as RS  # noqa: E402
from repro.space.schedule import canonical_key as r_canonical_key  # noqa: E402,E501
import repro_torch.core as TC  # noqa: E402
import repro_torch.engine as TE  # noqa: E402
import repro_torch.search as TS  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.rules import distill  # noqa: E402
from repro_torch.driver import (ACQUISITIONS, SINKS, DatasetSink,  # noqa: E402
                                SearchDriver, StreamingHistogram, TraceSink,
                                make_acquisition, make_sink)
from repro_torch.space.schedule import canonical_key  # noqa: E402

R_MACHINE = RC.Machine()
T_MACHINE = TC.Machine(**dataclasses.asdict(R_MACHINE))
POOL = {"n_workers": 2, "min_shard": 1}


def keys_of(schedules, key=canonical_key):
    return [key(s) for s in schedules]


def assert_same_result(ref, got):
    assert keys_of(got.schedules) == keys_of(ref.schedules, r_canonical_key)
    assert got.times == ref.times
    assert (got.n_proposed, got.cache_hits, got.cache_misses,
            got.store_hits) == (ref.n_proposed, ref.cache_hits,
                                ref.cache_misses, ref.store_hits)


# (strategy factory over a package's search module and graph, run kwargs)
STRATEGIES = {
    "mcts": (lambda S, g: S.MCTSSearch(g, 2, seed=3),
             dict(budget=90, batch_size=4)),
    "random_sim_budget": (lambda S, g: S.RandomSearch(g, 2, seed=1),
                          dict(budget=None, sim_budget=25, batch_size=1)),
    "random_stall": (lambda S, g: S.RandomSearch(g, 2, seed=2),
                     dict(budget=None, stall_limit=40, batch_size=8)),
    "exhaustive": (lambda S, g: S.ExhaustiveSearch(g, 2),
                   dict(budget=None, batch_size=16)),
    "surrogate": (lambda S, g: S.SurrogateGuided(g, 2, seed=0, warmup=16),
                  dict(budget=96, batch_size=8)),
}


@pytest.mark.parametrize("backend", ["sim", "vectorized"])
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_run_search_equals_reference(backend, strategy):
    """run_search through the port's driver: the reference's schedules,
    times and counters, for budget, sim_budget, stall and exhaustion
    stops alike."""
    make, kw = STRATEGIES[strategy]
    rg, tg = RC.spmv_dag(), TC.spmv_dag()
    ref = RS.run_search(rg, make(RS, rg), backend=backend, **kw)
    got = TS.run_search(tg, make(TS, tg), backend=backend,
                        machine=T_MACHINE, **kw)
    assert_same_result(ref, got)
    assert got.telemetry is None and ref.telemetry is None


def test_run_search_on_the_pool_equals_reference():
    """The pool backend (two workers, each importing torch) under the
    port's driver gives the reference's trajectories; the reference's
    analytic backends are bit-identical to each other, so its serial
    one stands for all three."""
    rg, tg = RC.spmv_dag(), TC.spmv_dag()
    for strategy in ("mcts", "surrogate"):
        make, kw = STRATEGIES[strategy]
        ref = RS.run_search(rg, make(RS, rg), backend="sim", **kw)
        got = TS.run_search(tg, make(TS, tg), backend="pool",
                            backend_kwargs=POOL, machine=T_MACHINE, **kw)
        assert_same_result(ref, got)


def test_run_search_shared_evaluator_replays_the_memo():
    """Against a shared, warmed evaluator the wrapper proposes the same
    sequence and reads back the memoized times: nothing is measured
    again, and the counters report this run's traffic only."""
    tg = TC.spmv_dag()
    ev = TE.make_evaluator(tg, "vectorized", machine=T_MACHINE)
    first = TS.run_search(tg, TS.MCTSSearch(tg, 2, seed=5), ev, budget=40,
                          batch_size=2)
    again = TS.run_search(tg, TS.MCTSSearch(tg, 2, seed=5), ev, budget=40,
                          batch_size=2)
    assert again.times == first.times and again.cache_misses == 0
    assert again.cache_hits == first.cache_hits + first.cache_misses
    assert keys_of(again.schedules) == keys_of(first.schedules)


def test_run_search_arguments():
    tg = TC.spmv_dag()
    ev = TE.make_evaluator(tg, "sim")
    with pytest.raises(ValueError, match="machine"):
        TS.run_search(tg, TS.RandomSearch(tg, 2), ev, budget=4,
                      machine=TC.Machine())
    with pytest.raises(ValueError, match="backend"):
        TS.run_search(tg, TS.RandomSearch(tg, 2), ev, budget=4,
                      backend="sim")
    with pytest.raises(ValueError, match="store"):
        TS.run_search(tg, TS.RandomSearch(tg, 2), ev, budget=4,
                      store_path="x.store")
    with pytest.raises(ValueError, match="acquisition"):
        SearchDriver(tg, TS.RandomSearch(tg, 2), budget=4,
                     acquisition_kwargs={"beta": 1.0})
    with pytest.raises(TypeError):
        TS.run_search(tg, TS.RandomSearch(tg, 2), ev, 4)
    with pytest.raises(TypeError):
        TS.run_search(tg, TS.RandomSearch(tg, 2), ev)


def test_driver_is_single_use():
    tg = TC.spmv_dag()
    drv = SearchDriver(tg, TS.RandomSearch(tg, 2, seed=0), budget=10,
                       backend="sim")
    drv.run()
    with pytest.raises(RuntimeError, match="single-use"):
        drv.run()


def test_driver_clamps_over_returning_screen():
    tg = TC.spmv_dag()

    class WholePool(TS.SurrogateGuided):
        def screen(self, pool, budget, acquisition):
            return list(pool)

    res = SearchDriver(tg, WholePool(tg, 2, seed=0, warmup=8), budget=40,
                       batch_size=4, backend="sim",
                       acquisition="argmin_topk").run()
    assert res.n_proposed == 40
    assert res.cache_hits + res.cache_misses == 40


def test_driver_argmin_topk_is_the_strategy_screening():
    """The driver's argmin_topk screening is the strategy's built-in
    one: identical results, screening logs and pool counters."""
    tg = TC.spmv_dag()
    a = TS.SurrogateGuided(tg, 2, seed=0, warmup=16)
    b = TS.SurrogateGuided(tg, 2, seed=0, warmup=16)
    assert isinstance(a, TS.PoolSearchStrategy)
    ra = TS.run_search(tg, a, budget=80, batch_size=4, backend="sim")
    rb = SearchDriver(tg, b, budget=80, batch_size=4, backend="sim",
                      acquisition="argmin_topk").run()
    assert keys_of(ra.schedules) == keys_of(rb.schedules)
    assert ra.times == rb.times
    assert a.screen_log == b.screen_log and a.n_screened == b.n_screened


@pytest.mark.parametrize("acq,kw,noise", [
    ("ucb", {"beta": 1.0}, 0.0),
    ("expected_improvement", {}, 0.0),
    ("ucb", {"beta": 1.0}, 0.05),
])
def test_acquisitions_choose_the_reference_batches(acq, kw, noise):
    """A boosted SurrogateGuided screened by the driver's acquisition:
    the same chosen batch in every round as the reference's driver, on
    two of the port's backends, with and without measurement noise."""
    def strat(S, g):
        return S.SurrogateGuided(g, 2, seed=0, warmup=16, surrogate="boost",
                                 surrogate_kwargs={"n_estimators": 20})

    noise_kw = {"noise_sigma": noise, "noise_seed": 7} if noise else None
    rg = RC.spmv_dag()
    r_trace = RD.TraceSink()
    r_strat = strat(RS, rg)
    ref = RD.SearchDriver(rg, r_strat, budget=72, batch_size=4,
                          backend="vectorized", backend_kwargs=noise_kw,
                          acquisition=acq, acquisition_kwargs=kw,
                          sinks=[r_trace]).run()
    for backend in ("sim", "vectorized"):
        tg = TC.spmv_dag()
        trace = TraceSink()
        t_strat = strat(TS, tg)
        got = SearchDriver(tg, t_strat, budget=72, batch_size=4,
                           backend=backend, backend_kwargs=noise_kw,
                           machine=T_MACHINE, acquisition=acq,
                           acquisition_kwargs=kw, sinks=[trace]).run()
        assert trace.key_stream() == r_trace.key_stream()
        assert [r["n_fresh"] for r in trace.rounds] == \
            [r["n_fresh"] for r in r_trace.rounds]
        assert got.times == ref.times
        assert t_strat.screen_log == r_strat.screen_log
        assert t_strat.screening_quality() == r_strat.screening_quality()


def test_portfolio_screened_by_the_driver_equals_reference():
    """PortfolioSearch hands the pool protocol to its surrogate phase:
    an acquisition override reaches it, as in the reference."""
    def port(S, g, machine):
        return S.PortfolioSearch(g, 2, machine=machine, seed=0,
                                 seed_proposals=2, mcts_proposals=8,
                                 warmup=12)

    rg, tg = RC.spmv_dag(), TC.spmv_dag()
    rp, tp = port(RS, rg, R_MACHINE), port(TS, tg, T_MACHINE)
    ref = RD.SearchDriver(rg, rp, budget=60, batch_size=4,
                          acquisition="ucb",
                          acquisition_kwargs={"beta": 1.0}).run()
    got = SearchDriver(tg, tp, budget=60, batch_size=4, backend="sim",
                       machine=T_MACHINE, acquisition="ucb",
                       acquisition_kwargs={"beta": 1.0}).run()
    assert_same_result(ref, got)
    assert tp.surrogate.n_screened == rp.surrogate.n_screened > 0
    assert tp.greedy.n_prefix_sims == rp.greedy.n_prefix_sims > 0


def test_dataset_sink_streams_the_reference_dataset():
    """The DatasetSink folded during the run equals the reference's sink
    and the result's own dataset: features, labels, times."""
    rg, tg = RC.spmv_dag(), TC.spmv_dag()
    r_sink, t_sink = RD.DatasetSink(rg), DatasetSink(tg)
    RD.SearchDriver(rg, RS.MCTSSearch(rg, 2, seed=0), budget=150,
                    batch_size=8, sinks=[r_sink]).run()
    res = SearchDriver(tg, TS.MCTSSearch(tg, 2, seed=0), budget=150,
                       batch_size=8, backend="vectorized",
                       machine=T_MACHINE, sinks=[t_sink]).run()
    (rf, rl, rt), (tf, tl, tt) = r_sink.dataset(), t_sink.dataset()
    assert [(f.kind, f.u, f.v) for f in tf.features] == \
        [(f.kind, f.u, f.v) for f in rf.features]
    np.testing.assert_array_equal(tf.X, rf.X)
    np.testing.assert_array_equal(tl.labels, rl.labels)
    np.testing.assert_array_equal(tt, rt)
    assert t_sink.n_consumed == r_sink.n_consumed
    np.testing.assert_array_equal(t_sink.histogram.counts,
                                  r_sink.histogram.counts)
    assert t_sink.histogram.hi == r_sink.histogram.hi
    ff, fl, ft = res.dataset()
    np.testing.assert_array_equal(ff.X, tf.X)
    np.testing.assert_array_equal(fl.labels, tl.labels)
    np.testing.assert_array_equal(ft, tt)
    # The streamed matrix goes straight to distill: no featurize stage.
    report = t_sink.distill()
    assert "featurize" not in report.stage_seconds
    assert report.render() == distill(res).render()


def test_dataset_sink_dedups_across_driver_runs():
    tg = TC.spmv_dag()
    sink = DatasetSink(tg)
    with TE.make_evaluator(tg, "sim") as ev:
        r1 = SearchDriver(tg, TS.RandomSearch(tg, 2, seed=0), ev,
                          budget=30, sinks=[sink]).run()
        SearchDriver(tg, TS.RandomSearch(tg, 2, seed=0), ev, budget=30,
                     sinks=[sink]).run()
    keys = keys_of(sink.schedules)
    assert len(keys) == len(set(keys)) == len(r1.schedules)
    assert sink.n_consumed == 60 and sink.histogram.n == len(keys)


def test_registries_match_reference():
    assert sorted(ACQUISITIONS) == sorted(RD.ACQUISITIONS)
    assert sorted(SINKS) == sorted(RD.SINKS)
    with pytest.raises(ValueError, match="unknown acquisition"):
        make_acquisition("nope")
    with pytest.raises(ValueError, match="unknown sink"):
        make_sink("nope", TC.spmv_dag())


def test_trace_sink_rounds_line_up_with_driver_spans():
    tg = TC.spmv_dag()
    trace = TraceSink()
    tel = obs.Telemetry()
    with obs.use(tel):
        res = SearchDriver(tg, TS.MCTSSearch(tg, 2, seed=0), budget=24,
                           batch_size=8, backend="sim",
                           sinks=[trace]).run()
    assert [r["round"] for r in trace.rounds] == [0, 1, 2]
    assert len(trace.key_stream()) == 24
    assert trace.key_stream(rounds=True)[8][0] == 1
    assert trace.rounds[-1]["best"] == min(res.times)
    assert tel.spans_by_name()["driver.round"]["count"] == 3


# -- the streaming histogram ------------------------------------------------

def test_streaming_histogram_matches_numpy_and_reference():
    rng = np.random.default_rng(0)
    batches = [rng.exponential(3e-5, size=int(rng.integers(1, 50)))
               for _ in range(12)]
    batches.append(np.array([0.0, 7.5e-4]))
    h, rh = StreamingHistogram(half_bins=16), RD.StreamingHistogram(16)
    for b in batches:
        h.add(b)
        rh.add(b)
    allv = np.concatenate(batches)
    counts, edges = np.histogram(allv, bins=h.n_bins, range=(0.0, h.hi))
    np.testing.assert_array_equal(h.counts, counts)
    np.testing.assert_array_equal(h.edges(), edges)
    np.testing.assert_array_equal(h.counts, rh.counts)
    assert h.hi == rh.hi and h.n == allv.size
    with pytest.raises(ValueError):
        h.add(np.array([-1.0]))


@settings(max_examples=25, deadline=None)
@given(st.lists(st.lists(st.floats(min_value=0.0, max_value=1e6),
                         min_size=0, max_size=30),
                min_size=1, max_size=6),
       st.integers(min_value=1, max_value=32))
def test_streaming_histogram_property(batches, half_bins):
    """Any batching of any non-negative values: the folded counts are
    np.histogram's over the final range, and merging per-batch
    histograms gives the single-stream one."""
    h = StreamingHistogram(half_bins=half_bins)
    merged = StreamingHistogram(half_bins=half_bins)
    for b in batches:
        h.add(np.asarray(b))
        one = StreamingHistogram(half_bins=half_bins)
        one.add(np.asarray(b))
        merged.merge(one)
    allv = np.asarray([v for b in batches for v in b], dtype=np.float64)
    if allv.size:
        counts, _ = np.histogram(allv, bins=h.n_bins, range=(0.0, h.hi))
        np.testing.assert_array_equal(h.counts, counts)
    assert h.hi == merged.hi
    np.testing.assert_array_equal(h.counts, merged.counts)
