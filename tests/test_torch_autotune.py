"""Kernel autotuning in the port: the DesignSpace/ParamSpace stack, the
evaluation store, the kernel wall-clock evaluator, MCTS over parameter
grids, and distill — held to the JAX package where both compute the
same thing, and run on the CPU (``device="cpu"``, the kernels' plain
versions) at tiny sizes."""
import os
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.search as RS  # noqa: E402
from repro.kernels import autotune as r_autotune  # noqa: E402
from repro.rules import distill as r_distill  # noqa: E402
from repro.space import demo_param_space as r_demo_space  # noqa: E402
from repro.space import ScheduleSpace as RScheduleSpace  # noqa: E402
import repro_torch.core as TC  # noqa: E402
import repro_torch.engine as E  # noqa: E402
from repro_torch.engine.base import EvaluatorBase  # noqa: E402
from repro_torch.engine.params import KernelWallclockEvaluator  # noqa: E402
from repro_torch.engine.store import (FINGERPRINT_SIZE, EvalStore,  # noqa: E402,E501
                                      store_fingerprint)
from repro_torch.kernels.autotune import (flash_attention_space,  # noqa: E402
                                          pack_space, spmv_mulsum_space)
from repro_torch.rules import distill  # noqa: E402
from repro_torch.rules.labels import Labeling  # noqa: E402
from repro_torch.search import (ExhaustiveSearch, MCTSSearch,  # noqa: E402
                                RandomSearch, SearchResult, run_search)
from repro_torch.space import (KernelRunner, ParamSpace,  # noqa: E402
                               ScheduleSpace, as_space, demo_param_space,
                               make_space)

CPU = "cpu"


def median_split(times: np.ndarray) -> Labeling:
    """Deterministic 2-class labeler (fast half / slow half): tiny
    wall-clock corpora rarely show the plateaus the paper's labeler keys
    on, so the distilled rules take the threshold-feature path
    deterministically."""
    order = np.argsort(times, kind="stable")
    s = times[order]
    cut = s.size // 2
    labels = np.empty(s.size, dtype=np.int64)
    labels[order] = (np.arange(s.size) >= cut).astype(np.int64)
    return Labeling(order=order, sorted_times=s,
                    convolution=np.zeros_like(s),
                    boundaries=np.array([cut - 1]),
                    labels=labels, n_classes=2)


def _demo_cost(space, candidate) -> float:
    return float(space.analytic_cost_fn(space.as_dict(candidate)))


def _spmv_grid(block_values=(32, 64)):
    return spmv_mulsum_space(n=128, k=4, block_values=block_values,
                             device=CPU)


class TableEvaluator(EvaluatorBase):
    """Times from a function of the candidate (the same numbers the JAX
    side sees); records what it measured."""

    backend = "table"

    def __init__(self, space, time_of):
        super().__init__(space)
        self.time_of = time_of
        self.measured: list = []

    def _measure_batch(self, candidates):
        self.measured += list(candidates)
        return [self.time_of(c) for c in candidates]


# -- the evaluation store (tests/test_engine_store.py) ------------------------

def _fp(tag: bytes = b"a") -> bytes:
    return (tag * FINGERPRINT_SIZE)[:FINGERPRINT_SIZE]


@pytest.fixture()
def store_path(tmp_path):
    return str(tmp_path / "eval.store")


def test_store_roundtrip_and_persistence(store_path):
    fp = _fp()
    with EvalStore(store_path) as st:
        assert len(st) == 0 and st.get(fp, b"k1") is None
        assert st.put_many(fp, [(b"k1", 1.5), (b"k2", 2.5)]) == 2
        assert st.get(fp, b"k1") == 1.5
        # Content-addressed: re-putting an existing key is a no-op.
        assert st.put_many(fp, [(b"k1", 9.9), (b"k3", 3.5)]) == 1
        assert st.get(fp, b"k1") == 1.5
    with EvalStore(store_path) as st2:     # fresh process semantics
        assert len(st2) == 3 and st2.n_truncated_bytes == 0
        assert [st2.get(fp, k) for k in (b"k1", b"k2", b"k3")] == \
            [1.5, 2.5, 3.5]


def test_store_file_format_is_the_reference_format(store_path):
    """Both packages read each other's files byte for byte."""
    from repro.engine.store import EvalStore as REvalStore
    fp = _fp(b"z")
    with EvalStore(store_path) as st:
        st.put_many(fp, [(b"port", 1.25)])
    with REvalStore(store_path) as rst:
        assert rst.get(fp, b"port") == 1.25
        rst.put_many(fp, [(b"jax", 2.5)])
    with EvalStore(store_path) as st:
        assert st.get(fp, b"jax") == 2.5 and len(st) == 2


@pytest.mark.parametrize("tail", ["half_record", "bad_checksum"])
def test_store_truncates_a_torn_tail(store_path, tail):
    fp = _fp()
    with EvalStore(store_path) as st:
        st.put_many(fp, [(b"good1", 1.0), (b"good2", 2.0)])
    size_ok = os.path.getsize(store_path)
    payload = fp + b"torn" + struct.pack("<d", 3.0)
    with open(store_path, "ab") as f:
        if tail == "half_record":           # a crashed writer
            rec = struct.pack("<I", len(payload)) + payload
            f.write(rec[:len(rec) - 7])
        else:
            f.write(struct.pack("<I", len(payload)) + payload +
                    struct.pack("<I", zlib.crc32(payload) ^ 0xFF))
    with EvalStore(store_path) as st:
        assert len(st) == 2 and st.get(fp, b"good1") == 1.0
        assert st.n_truncated_bytes > 0
    assert os.path.getsize(store_path) == size_ok   # tail cut off
    with EvalStore(store_path) as st:                # and it keeps working
        st.put(fp, b"good3", 3.0)
    assert EvalStore(store_path).get(fp, b"good3") == 3.0


def test_store_rejects_foreign_file_and_writes_after_close(tmp_path):
    path = tmp_path / "not-a-store"
    path.write_bytes(b"something else entirely")
    with pytest.raises(ValueError, match="magic"):
        EvalStore(path)
    st = EvalStore(tmp_path / "s")
    st.put(_fp(), b"k", 1.0)
    st.close()
    st.close()                              # idempotent
    assert st.get(_fp(), b"k") == 1.0       # reads keep working
    with pytest.raises(ValueError, match="closed"):
        st.put(_fp(), b"k2", 2.0)


def test_store_duplicate_records_first_wins(store_path):
    fp = _fp()
    a, b = EvalStore(store_path), EvalStore(store_path)
    a.put(fp, b"k", 1.0)
    b.put(fp, b"k", 2.0)                    # b has not seen a's record
    a.close(), b.close()
    with EvalStore(store_path) as st:
        assert len(st) == 1 and st.get(fp, b"k") == 1.0


def test_fingerprints_separate_spaces_grids_and_objectives():
    g1, g2 = TC.spmv_dag(), TC.spmv_dag_fine()
    fps = {store_fingerprint(g1, "a"), store_fingerprint(g2, "a"),
           store_fingerprint(g1, "b"),
           ScheduleSpace(g1).fingerprint("c"),
           _spmv_grid().fingerprint("a"),
           _spmv_grid((32,)).fingerprint("a"),
           spmv_mulsum_space(n=256, k=4, block_values=(32, 64),
                             device=CPU).fingerprint("a"),
           _spmv_grid().fingerprint("b")}
    assert len(fps) == 8 and all(len(f) == FINGERPRINT_SIZE for f in fps)
    assert ScheduleSpace(g1).fingerprint("a") == store_fingerprint(g1, "a")


# -- the kernel wall-clock evaluator (tests/test_kernel_autotune.py) ---------

def test_kernel_wallclock_dispatch_and_requirements():
    sp = _spmv_grid()
    ev = E.make_evaluator(sp, "wallclock", repeats=1, device=CPU)
    assert isinstance(ev, KernelWallclockEvaluator)
    no_runner = ParamSpace("bare", [("a", (1, 2))])
    with pytest.raises(ValueError, match="KernelRunner"):
        E.make_evaluator(no_runner, "wallclock", device=CPU)
    with pytest.raises(ValueError, match="compile_mode"):
        E.make_evaluator(sp, "wallclock", compile_mode="eager", device=CPU)
    with pytest.raises(ValueError, match="unknown evaluation backend"):
        E.make_evaluator(sp, "sim")
    g = TC.spmv_dag()
    assert E.make_evaluator(g, "wallclock", impls={}, env={},
                            reset=lambda: None, device=CPU).graph is g


@pytest.mark.parametrize("compile_mode", ["batch", "per_candidate"])
def test_kernel_sweep_measures_and_memoizes(compile_mode):
    sp = _spmv_grid()
    ev = E.make_evaluator(sp, "wallclock", repeats=2, device=CPU,
                          compile_mode=compile_mode)
    cands = list(sp.enumerate_candidates())
    times = ev.evaluate(cands)
    assert len(times) == 2 and all(t > 0.0 for t in times)
    assert ev.n_checked == 2                 # every candidate gated
    again = ev.evaluate(cands)
    assert again == times                    # memoized, not re-run
    assert ev.n_checked == 2
    assert ev.stats()["memory_hits"] == 2 and ev.fresh_evals() == 2


def _broken(honest, build, tag):
    return ParamSpace(honest.name, honest.dims,
                      runner=KernelRunner(build=build,
                                          reference=honest.runner.reference),
                      signature=honest.signature + tag)


def test_wallclock_gate_rejects_wrong_output_candidate():
    """A candidate with wrong outputs is rejected; in per_candidate mode
    the good candidates timed before it are salvaged (not re-run)."""
    honest = _spmv_grid(block_values=(16, 32, 64))
    bad_block = 64

    def build(params):
        run = honest.runner.build(params)
        if params["block_n"] != bad_block:
            return run
        return lambda: run() + 1.0           # wrong values, right shape
    broken = _broken(honest, build, ":broken")

    ev = E.make_evaluator(broken, "wallclock", repeats=1, device=CPU)
    with pytest.raises(AssertionError, match="value-correctness gate"):
        ev.evaluate([(16,), (32,), (bad_block,)])
    assert all(t > 0.0 for t in ev.evaluate([(16,), (32,)]))

    ev2 = E.make_evaluator(broken, "wallclock", repeats=1, device=CPU,
                           compile_mode="per_candidate")
    with pytest.raises(AssertionError, match="value-correctness gate"):
        ev2.evaluate([(16,), (32,), (bad_block,)])
    assert ev2.n_checked == 2
    banked = ev2.evaluate([(16,), (32,)])
    assert ev2.n_checked == 2                # served from salvage
    assert all(t > 0.0 for t in banked)
    assert ev2.cache_misses == 2             # salvage is metered as misses


def test_gate_error_names_the_candidate():
    honest = _spmv_grid(block_values=(32,))
    broken = _broken(honest, lambda p: lambda: torch.zeros(128), ":zeros")
    ev = E.make_evaluator(broken, "wallclock", repeats=1, device=CPU)
    with pytest.raises(AssertionError, match="block_n=32"):
        ev.evaluate([(32,)])


def test_check_values_off_skips_the_gate():
    honest = _spmv_grid(block_values=(32,))
    broken = _broken(honest, lambda p: lambda: torch.zeros(128),
                     ":unchecked")
    ev = E.make_evaluator(broken, "wallclock", repeats=1, device=CPU,
                          check_values=False)
    assert ev.evaluate([(32,)])[0] > 0.0
    assert ev.n_checked == 0


def test_platform_is_part_of_the_objective_key():
    sp = _spmv_grid()
    ev = E.make_evaluator(sp, "wallclock", repeats=3, warmup=2, device=CPU)
    assert ev.objective_key() == \
        "kernel-wallclock:platform=cpu:repeats=3:warmup=2"
    # compile_mode moves the first call around but measures the same
    # quantity: deliberately not in the key.
    ev2 = E.make_evaluator(sp, "wallclock", repeats=3, warmup=2,
                           device=CPU, compile_mode="per_candidate")
    assert ev2.objective_key() == ev.objective_key()
    assert ev2.store_fingerprint == ev.store_fingerprint
    ev3 = E.make_evaluator(sp, "wallclock", repeats=4, warmup=2, device=CPU)
    assert ev3.store_fingerprint != ev.store_fingerprint


def test_warm_kernel_search_replays_with_zero_measurements(
        tmp_path, monkeypatch):
    """The second ``run_search`` against a fresh evaluator performs zero
    measurements — all store hits — and replays the cold trajectory."""
    path = str(tmp_path / "kernels.store")

    def run():
        sp = _spmv_grid()                      # a fresh space each run
        return run_search(sp, MCTSSearch(sp, seed=2), budget=6,
                          batch_size=2, backend="wallclock",
                          backend_kwargs={"repeats": 1, "device": CPU},
                          store_path=path)

    cold = run()
    assert cold.cache_misses == 2 and cold.store_hits == 0
    assert len(cold.schedules) == 2

    def no_measuring(self, candidates):
        raise AssertionError("warm run called _measure_batch")
    monkeypatch.setattr(KernelWallclockEvaluator, "_measure_batch",
                        no_measuring)
    warm = run()
    assert warm.cache_misses == 0
    assert warm.store_hits == cold.cache_misses   # 100% store hits
    assert warm.cache_hits == cold.cache_hits
    assert warm.times == cold.times and warm.schedules == cold.schedules
    fa, la, ta = cold.dataset()
    fb, lb, tb = warm.dataset()
    assert ta.tobytes() == tb.tobytes()
    assert fa.X.tobytes() == fb.X.tobytes()
    assert np.array_equal(la.labels, lb.labels)


def test_different_grids_never_share_store_entries(tmp_path):
    path = str(tmp_path / "kernels.store")
    sp = _spmv_grid()
    with E.make_evaluator(sp, "wallclock", repeats=1, device=CPU,
                          store_path=path) as ev:
        ev.evaluate(list(sp.enumerate_candidates()))
        assert ev.cache_misses == 2
    other = spmv_mulsum_space(n=256, k=4, block_values=(32, 64), device=CPU)
    with E.make_evaluator(other, "wallclock", repeats=1, device=CPU,
                          store_path=path) as ev2:
        ev2.evaluate(list(other.enumerate_candidates()))
        assert (ev2.store_hits, ev2.cache_misses) == (0, 2)


def test_flash_attention_autotune_distills_block_size_rules(tmp_path):
    """A flash_attention sweep distils block-size design rules, and the
    warm re-run is 100% store hits."""
    path = str(tmp_path / "fa.store")

    def run():
        sp = flash_attention_space(batch=1, heads=1, seq=64, head_dim=16,
                                   block_values=(16, 32, 64), device=CPU)
        res = run_search(sp, ExhaustiveSearch(sp),
                         budget=sp.n_candidates(),
                         backend_kwargs={"repeats": 1, "device": CPU},
                         store_path=path)
        return sp, res

    sp, cold = run()
    assert len(cold.schedules) == sp.n_candidates() == 9
    assert cold.cache_misses == 9 and cold.store_hits == 0
    report = distill(cold, labeler=median_split)
    assert report.n_schedules == 9 and report.labeling.n_classes == 2
    assert report.rulesets and all(rs.rules for rs in report.rulesets)
    rule_dims = {r.feature.u for rs in report.rulesets for r in rs.rules}
    assert rule_dims and rule_dims <= {"block_q", "block_k"}
    text = report.render()
    assert "block_q" in text or "block_k" in text

    _, warm = run()
    assert (warm.store_hits, warm.cache_misses) == (9, 0)
    assert warm.times == cold.times


def test_pack_space_smallest_grid_round_trip():
    sp = pack_space(n=256, m=64, block_c_values=(32, 64), device=CPU)
    assert sp.n_candidates() == 2
    res = run_search(sp, ExhaustiveSearch(sp), budget=sp.n_candidates(),
                     backend_kwargs={"repeats": 1, "device": CPU})
    assert len(res.times) == 2 and min(res.times) > 0.0
    assert res.best()[0] in set(sp.enumerate_candidates())


def test_flash_attention_space_filters_non_divisor_blocks():
    sp = flash_attention_space(seq=64, block_values=(16, 48, 64),
                               device=CPU)
    assert dict(sp.dims)["block_q"] == (16, 64)
    with pytest.raises(ValueError, match="divides"):
        flash_attention_space(seq=64, block_values=(48,), device=CPU)


def test_registry_and_run_search_arguments():
    assert make_space("pack", n=64, m=8, device=CPU).signature.startswith(
        "pack:n=64:m=8")
    with pytest.raises(ValueError, match="unknown design space"):
        make_space("nope")
    sp = _spmv_grid()
    with pytest.raises(TypeError):
        as_space(sp, 2)
    with pytest.raises(TypeError):
        as_space("spmv")
    ev = E.make_evaluator(sp, "wallclock", repeats=1, device=CPU)
    with pytest.raises(ValueError, match="not both"):
        run_search(sp, ExhaustiveSearch(sp), ev, budget=2,
                   backend="wallclock")


# -- parity with the JAX package ----------------------------------------------

FACTORY_CASES = [
    ("flash_attention_space",
     dict(batch=1, heads=2, seq=64, head_dim=16, block_values=(16, 32, 64),
          seed=3), 1e-5),
    ("spmv_mulsum_space", dict(n=200, k=5, block_values=(64, 128),
                               seed=1), 1e-5),
    ("pack_space", dict(n=300, m=50, block_c_values=(64, 128), seed=2), 0.0),
]


@pytest.mark.parametrize("name,kwargs,tol", FACTORY_CASES)
def test_factories_draw_the_reference_instance(name, kwargs, tol):
    """Same arguments, same problem: the references agree (f32 1e-5 for
    the two sums, exact for the gather), and so do the grids and the
    signatures — except ``pack``'s TPU-only ``chunk`` dimension, which
    the port drops and its signature names."""
    r_sp = getattr(r_autotune, name)(interpret=True, **kwargs)
    t_sp = getattr(__import__("repro_torch.kernels.autotune",
                              fromlist=[name]), name)(device=CPU, **kwargs)
    ref = np.asarray(r_sp.runner.reference(), dtype=np.float32)
    got = t_sp.runner.reference().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    # A candidate's run computes the reference's values too.
    cand = next(iter(t_sp.enumerate_candidates()))
    np.testing.assert_allclose(
        t_sp.runner.build(t_sp.as_dict(cand))().numpy(), ref, rtol=0,
        atol=max(tol, 1e-5))
    if name == "pack_space":
        assert r_sp.dims[0] == t_sp.dims[0] and len(t_sp.dims) == 1
        assert [n for n, _ in r_sp.dims] == ["block_c", "chunk"]
        assert t_sp.signature == r_sp.signature + ":chunk=none(gather)"
    else:
        assert t_sp.dims == r_sp.dims
        assert t_sp.signature == r_sp.signature
    assert t_sp.name == r_sp.name


@pytest.mark.parametrize("make", [
    lambda pkg: pkg(),
    lambda pkg: pkg("renamed")])
def test_param_space_identity_and_features_match_reference(make):
    r_sp, t_sp = make(r_demo_space), make(demo_param_space)
    cands = list(t_sp.enumerate_candidates())
    assert cands == list(r_sp.enumerate_candidates())
    rk, renc = r_sp.encode_batch(cands)
    tk, tenc = t_sp.encode_batch(cands)
    assert rk == tk and np.array_equal(renc, tenc)
    assert [t_sp.describe(c) for c in cands] == \
        [r_sp.describe(c) for c in cands]
    assert [t_sp.tie_key(c) for c in cands] == \
        [r_sp.tie_key(c) for c in cands]
    assert [(f.kind, f.u, f.v) for f in t_sp.all_features()] == \
        [(f.kind, f.u, f.v) for f in r_sp.all_features()]
    subset = cands[::3]
    rfm, tfm = r_sp.featurize(subset), t_sp.featurize(subset)
    assert [(f.kind, f.u, f.v) for f in tfm.features] == \
        [(f.kind, f.u, f.v) for f in rfm.features]
    assert np.array_equal(tfm.X, rfm.X)
    assert [f.describe(v) for f in tfm.features for v in (0, 1)] == \
        [f.describe(v) for f in rfm.features for v in (0, 1)]
    np.testing.assert_array_equal(
        t_sp.apply_features(cands, tfm.features),
        r_sp.apply_features(cands, rfm.features))
    assert [_demo_cost(t_sp, c) for c in cands] == \
        [r_sp.analytic_cost(c, None, {}) for c in cands]


def test_schedule_space_encoding_matches_reference():
    rg, tg = RC.spmv_dag(), TC.spmv_dag()
    rs, ts = RScheduleSpace(rg, 2), ScheduleSpace(tg, 2)
    rsched = list(RC.enumerate_schedules(rg, 2))[:40]
    tsched = list(TC.enumerate_schedules(tg, 2))[:40]
    rk, renc = rs.encode_batch(rsched)
    tk, tenc = ts.encode_batch(tsched)
    assert rk == tk and np.array_equal(renc, tenc)
    assert ts.name == rs.name
    assert [ts.tie_key(s) for s in tsched] == [rs.tie_key(s) for s in rsched]


@pytest.mark.parametrize("budget,batch_size,seed", [
    (30, 1, 0), (30, 1, 5), (12, 3, 1), (60, 4, 2)])
def test_mcts_over_a_param_grid_matches_reference(budget, batch_size, seed):
    """Fed the same times (the demo grid's analytic cost), the port's
    MCTS visits the same candidates in the same order."""
    r_sp, t_sp = r_demo_space(), demo_param_space()
    ref = RS.run_search(r_sp, RS.MCTSSearch(r_sp, seed=seed),
                        budget=budget, batch_size=batch_size,
                        backend="sim")
    ev = TableEvaluator(t_sp, lambda c: _demo_cost(t_sp, c))
    strategy = MCTSSearch(t_sp, seed=seed)
    got = run_search(t_sp, strategy, ev, budget=budget,
                     batch_size=batch_size)
    assert got.schedules == ref.schedules and got.times == ref.times
    assert (got.n_proposed, got.cache_hits, got.cache_misses) == \
        (ref.n_proposed, ref.cache_hits, ref.cache_misses)
    assert got.best() == ref.best()
    assert ev.measured == got.schedules
    assert strategy.exhausted() == (len(got.schedules) == 30)


def test_random_and_exhaustive_strategies_match_reference():
    r_sp, t_sp = r_demo_space(), demo_param_space()
    rr = RS.RandomSearch(r_sp, seed=4).propose(25)
    assert RandomSearch(t_sp, seed=4).propose(25) == rr
    assert ExhaustiveSearch(t_sp).propose(100) == \
        RS.ExhaustiveSearch(r_sp).propose(100)
    rg, tg = RC.spmv_dag(), TC.spmv_dag()
    r_keys = [RScheduleSpace(rg).candidate_key(s)
              for s in RS.RandomSearch(rg, 2, seed=1).propose(10)]
    assert [ScheduleSpace(tg).candidate_key(s)
            for s in RandomSearch(tg, 2, seed=1).propose(10)] == r_keys


@pytest.mark.parametrize("labeler", ["default", "median"])
def test_distill_matches_reference_on_a_param_grid(labeler):
    r_sp, t_sp = r_demo_space(), demo_param_space()
    ref = RS.run_search(r_sp, RS.ExhaustiveSearch(r_sp), budget=None,
                        backend="sim")
    got = SearchResult(None, list(ref.schedules), list(ref.times),
                       ref.n_proposed, 0, len(ref.times), space=t_sp)
    kw = {} if labeler == "default" else {"labeler": median_split}
    r_rep = r_distill(ref, **kw)
    t_rep = distill(got, **kw)
    assert t_rep.render() == r_rep.render()
    assert t_rep.training_error == r_rep.training_error
    assert t_rep.summary() == r_rep.summary()
    assert t_rep.trace.max_leaf_nodes == r_rep.trace.max_leaf_nodes


def test_distill_matches_reference_on_schedules():
    """The schedule space through distill, with the Table-V accuracy on
    the full space and annotation against itself."""
    rg, tg = RC.spmv_dag(), TC.spmv_dag()
    rsched = list(RC.enumerate_schedules(rg, 2))
    tsched = list(TC.enumerate_schedules(tg, 2))
    times = np.array([RC.makespan(rg, s) for s in rsched])
    ref = RS.SearchResult(rg, rsched[::2], list(times[::2]), 140, 0, 140)
    got = SearchResult(tg, tsched[::2], list(times[::2]), 140, 0, 140)
    r_rep = r_distill(ref, full_space=(rsched, times), range_widen=0.01)
    t_rep = distill(got, full_space=(tsched, times), range_widen=0.01)
    assert t_rep.render() == r_rep.render()
    assert t_rep.class_range_acc == r_rep.class_range_acc
    t_again = distill(got, canonical=t_rep)
    r_again = r_distill(ref, canonical=r_rep)
    assert t_again.render() == r_again.render()
    fm, labels, t = got.dataset()
    rfm, rlabels, _ = ref.dataset()
    assert np.array_equal(fm.X, rfm.X)
    assert np.array_equal(labels.labels, rlabels.labels)


def test_reference_kernel_space_runs_in_interpret_mode_like_the_port():
    """The JAX factory's own candidates (interpret mode) and the port's
    plain path give the same values on one flash-attention instance."""
    kw = dict(batch=1, heads=1, seq=32, head_dim=16, block_values=(16, 32))
    r_sp = r_autotune.flash_attention_space(interpret=True, **kw)
    t_sp = flash_attention_space(device=CPU, **kw)
    for cand in t_sp.enumerate_candidates():
        r_out = np.asarray(r_sp.runner.build(r_sp.as_dict(cand))())
        t_out = t_sp.runner.build(t_sp.as_dict(cand))().numpy()
        np.testing.assert_allclose(t_out, r_out, rtol=0, atol=1e-5)
