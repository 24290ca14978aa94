"""The port's analytic backends against the JAX package: the machine
model (``core/costmodel.py``), ``sim``, ``vectorized`` and ``pool``,
the order-independent measurement noise, and the store fingerprint over
the machine (tests/test_batch_evaluator.py, tests/test_engine_vectorized.py
and tests/test_engine_pool.py mirrored). Under the reference's TPU
constants, passed in explicitly, every makespan is the reference's bit
for bit; the port's own default ``Machine`` is the H100's."""
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.core.dag as RD  # noqa: E402
import repro.engine as RE  # noqa: E402
import repro.search as RS  # noqa: E402
from repro.core.costmodel import op_durations as r_op_durations  # noqa: E402
from repro.engine.base import _noise_gauss as r_noise_gauss  # noqa: E402
from repro.space.schedule import canonical_key as r_canonical_key  # noqa: E402,E501
import repro_torch.core as TC  # noqa: E402
import repro_torch.engine as TE  # noqa: E402
from repro_torch.core.costmodel import op_durations  # noqa: E402
from repro_torch.engine.base import _noise_gauss  # noqa: E402
from repro_torch.engine.store import FINGERPRINT_SIZE, store_fingerprint  # noqa: E402,E501
from repro_torch.search import MCTSSearch, run_search  # noqa: E402
from repro_torch.space.schedule import (canonical_key,  # noqa: E402
                                        random_schedule)

# The reference's defaults (TPU v5e-like) and a custom machine, each as
# the reference's Machine and as the port's with the same fields.
R_CUSTOM = RC.Machine(flops_per_s=100e12, hbm_bytes_per_s=500e9,
                      launch_overhead_s=7e-6, sync_op_s=0.9e-6)
MACHINES = {"reference_default": RC.Machine(), "custom": R_CUSTOM}


def as_port(m) -> TC.Machine:
    return TC.Machine(**dataclasses.asdict(m))


@pytest.fixture(scope="module")
def spaces():
    rg, tg = RC.spmv_dag(), TC.spmv_dag()
    rs, ts = list(RC.enumerate_schedules(rg, 2)), \
        list(TC.enumerate_schedules(tg, 2))
    assert [r_canonical_key(s) for s in rs] == [canonical_key(s) for s in ts]
    return rg, rs, tg, ts


@pytest.fixture(scope="module")
def pools():
    """One two-worker pool per graph, shared by the tests below."""
    evs = {name: TE.make_evaluator(getattr(TC, name)(), "pool",
                                   n_workers=2, min_shard=1)
           for name in ("spmv_dag_fine", "halo3d_dag")}
    yield evs
    for ev in evs.values():
        ev.close()


# -- the machine model ----------------------------------------------------------

@pytest.mark.parametrize("which", sorted(MACHINES))
def test_simulate_bit_identical_to_reference(spaces, which):
    """All 280 schedules of spmv_dag(): the port's simulate under the
    reference's constants equals the reference's, == on floats."""
    rg, rs, tg, ts = spaces
    rm = MACHINES[which]
    got = [TC.simulate(tg, s, as_port(rm)).makespan for s in ts]
    assert got == [RC.simulate(rg, s, rm).makespan for s in rs]
    assert [TC.makespan(tg, s, as_port(rm)) for s in ts[:20]] == got[:20]


@pytest.mark.parametrize("which", sorted(MACHINES))
def test_op_durations_match_reference(which):
    rm = MACHINES[which]
    for name in ("spmv_dag", "spmv_dag_fine", "halo3d_dag"):
        assert op_durations(getattr(TC, name)(), as_port(rm)) == \
            r_op_durations(getattr(RD, name)(), rm)


def test_port_machine_is_the_h100_not_the_tpu():
    """The port's defaults describe the H100 port: the data sheet's
    float32 and HBM rates, and no field left at the reference's TPU
    value."""
    m, r = dataclasses.asdict(TC.Machine()), dataclasses.asdict(RC.Machine())
    assert list(m) == list(r)
    assert (m["flops_per_s"], m["hbm_bytes_per_s"]) == (67e12, 3.35e12)
    assert all(m[k] != r[k] for k in m), [k for k in m if m[k] == r[k]]
    assert all(v > 0 for v in m.values())


# -- the backends ---------------------------------------------------------------

@pytest.mark.parametrize("backend", ["sim", "vectorized", "pool"])
def test_backends_equal_reference_on_all_280(spaces, backend):
    rg, rs, tg, ts = spaces
    ref = RE.make_evaluator(rg, "sim").evaluate(rs)
    if backend == "pool":
        ev = TE.make_evaluator(tg, "pool", machine=as_port(RC.Machine()),
                               n_workers=2, min_shard=1)
    else:
        ev = TE.make_evaluator(tg, backend, machine=as_port(RC.Machine()))
    with ev:
        assert ev.evaluate(ts) == ref
        assert ev.cache_misses == 280 and ev.backend == backend


@pytest.mark.parametrize("dag,n_streams", [
    ("spmv_dag_fine", 2), ("spmv_dag_fine", 3), ("halo3d_dag", 2),
    ("halo3d_dag", 3)])
def test_vectorized_and_pool_equal_sim_on_seeded_samples(pools, dag,
                                                         n_streams):
    """Seeded random canonical schedules of the fine-grained SpMV and
    halo3d DAGs, under the port's H100 machine: vectorized == pool ==
    sim, and sim == the reference's simulate under the same constants."""
    g = getattr(TC, dag)()
    rng = random.Random(1000 * n_streams + len(dag))
    scheds = [random_schedule(g, n_streams, rng) for _ in range(24)]
    sim = TE.make_evaluator(g, "sim").evaluate(scheds)
    assert TE.make_evaluator(g, "vectorized").evaluate(scheds) == sim
    pooled = pools[dag]
    assert pooled.machine == TC.Machine()
    assert pooled.evaluate(scheds) == sim
    rg = getattr(RD, dag)()
    rm = RC.Machine(**dataclasses.asdict(TC.Machine()))
    r_scheds = [RC.Schedule(tuple(RC.BoundOp(i.name, i.stream)
                                  for i in s.items)) for s in scheds]
    assert [RC.makespan(rg, s, rm) for s in r_scheds] == sim


def test_run_search_vectorized_equals_reference_dataset():
    """run_search(backend="vectorized") under the reference's constants:
    the same schedules, times and labels as the reference's run for the
    same seed and budget, at batch size 16."""
    rg, tg = RC.spmv_dag(), TC.spmv_dag()
    ref = RS.run_search(rg, RS.MCTSSearch(rg, 2, seed=3), budget=120,
                        batch_size=16, backend="vectorized")
    got = run_search(tg, MCTSSearch(tg, 2, seed=3), budget=120,
                     batch_size=16, backend="vectorized",
                     machine=as_port(RC.Machine()))
    assert [canonical_key(s) for s in got.schedules] == \
        [r_canonical_key(s) for s in ref.schedules]
    assert got.times == ref.times
    _, lab, t = got.dataset()
    _, r_lab, r_t = ref.dataset()
    assert t.tobytes() == r_t.tobytes()
    assert np.array_equal(lab.labels, r_lab.labels)
    assert (got.cache_hits, got.cache_misses) == \
        (ref.cache_hits, ref.cache_misses)


def test_run_search_refuses_machine_with_an_evaluator():
    g = TC.spmv_dag()
    ev = TE.make_evaluator(g, "sim")
    with pytest.raises(ValueError, match="machine"):
        run_search(g, MCTSSearch(g, 2, seed=0), ev, budget=4,
                   machine=TC.Machine())
    res = run_search(g, MCTSSearch(g, 2, seed=0), budget=400,
                     backend="sim", machine=as_port(RC.Machine()))
    assert len(res.schedules) == 280
    assert res.best()[1] == min(RE.make_evaluator(RC.spmv_dag(), "sim")
                                .evaluate(list(RC.enumerate_schedules(
                                    RC.spmv_dag(), 2))))


def test_stats_parity_across_backends(spaces):
    """The same traffic gives the same {memory_hits, store_hits, misses}
    on sim, vectorized and pool (the reference's numbers)."""
    _, _, tg, ts = spaces
    traffic = ts[:25] + ts[5:15] + ts[:25]
    for ev in (TE.make_evaluator(tg, "sim"),
               TE.make_evaluator(tg, "vectorized"),
               TE.make_evaluator(tg, "pool", n_workers=2, min_shard=1)):
        with ev:
            ev.evaluate(traffic)
            st = ev.stats()
            assert (st["memory_hits"], st["store_hits"], st["misses"]) == \
                (35, 0, 25), ev.backend


def test_pool_close_is_reentrant_and_lazy():
    g = TC.spmv_dag_fine()
    ev = TE.make_evaluator(g, "pool", n_workers=2, min_shard=1)
    rng = random.Random(9)
    scheds = [random_schedule(g, 2, rng) for _ in range(16)]
    first = ev.evaluate(scheds)
    assert ev._pool is not None
    ev.close()
    ev.close()
    assert ev._pool is None
    hits = ev.cache_hits
    assert ev.evaluate(scheds) == first
    assert ev.cache_hits - hits == len(scheds)    # the cache outlives it
    ev.close()
    ev.__del__()


def test_analytic_backends_take_no_device_and_need_a_graph():
    g = TC.spmv_dag()
    for backend in ("sim", "vectorized", "pool"):
        with pytest.raises(TypeError):
            TE.make_evaluator(g, backend, device="cpu")
    from repro_torch.space import demo_param_space
    for backend in ("vectorized", "pool"):
        with pytest.raises(TypeError, match="Graph"):
            TE.make_evaluator(demo_param_space(), backend)


def test_unsupported_rendezvous_graph_raises():
    g = TC.Graph()
    g.add_op(TC.Op("PostRecv", TC.OpKind.CPU, comm_bytes=8.0,
                   comm_role=TC.CommRole.POST_RECV))
    g.add_op(TC.Op("WaitRecv", TC.OpKind.CPU,
                   comm_role=TC.CommRole.WAIT_RECV))
    g.finalize()
    with pytest.raises(ValueError, match="ancestor"):
        TE.make_evaluator(g, "vectorized")


def test_sim_on_a_parameter_grid_equals_reference():
    """A ParamSpace with an analytic cost runs under ``sim`` as in the
    reference."""
    from repro.space import demo_param_space as r_demo
    from repro_torch.space import demo_param_space
    sp, rsp = demo_param_space(), r_demo()
    cands = list(sp.enumerate_candidates())
    assert TE.make_evaluator(sp, "sim").evaluate(cands) == \
        RE.make_evaluator(rsp, "sim").evaluate(list(
            rsp.enumerate_candidates()))


def test_evaluate_one_matches_makespan(spaces):
    _, _, tg, ts = spaces
    ev = TE.make_evaluator(tg, "sim")
    assert ev.evaluate_one(ts[7]) == TC.makespan(tg, ts[7])


# -- measurement noise ----------------------------------------------------------

def test_noise_draws_equal_reference(spaces):
    """Same noise_seed, same draws: the port's noisy times are the
    reference's bit for bit, including the fresh draw on a cache hit."""
    rg, rs, tg, ts = spaces
    for key in (b"", b"\x00\x01", np.arange(14, dtype=np.int32).tobytes()):
        for draw in range(3):
            assert _noise_gauss(11, key, draw) == r_noise_gauss(11, key,
                                                                draw)
    batch = ts[:20] + ts[:5]
    got = TE.make_evaluator(tg, "sim", machine=as_port(RC.Machine()),
                            noise_sigma=0.05, noise_seed=11).evaluate(batch)
    ref = RE.make_evaluator(rg, "sim", noise_sigma=0.05,
                            noise_seed=11).evaluate(rs[:20] + rs[:5])
    assert got == ref
    assert got[:5] != got[20:]          # fresh noise on a hit


def test_noise_is_post_cache_and_order_independent(spaces):
    _, _, tg, ts = spaces
    batch = ts[:30]
    perm = list(range(len(batch)))
    random.Random(4).shuffle(perm)
    a = TE.make_evaluator(tg, "vectorized", noise_sigma=0.05, noise_seed=3)
    b = TE.make_evaluator(tg, "sim", noise_sigma=0.05, noise_seed=3)
    straight = a.evaluate(batch)
    assert b.evaluate([batch[i] for i in perm]) == \
        [straight[i] for i in perm]
    assert a.cache_misses == 30
    clean = TE.make_evaluator(tg, "sim").evaluate(batch)
    assert straight != clean
    assert all(abs(t / c - 1.0) < 0.5 for t, c in zip(straight, clean))


# -- the store fingerprint covers the machine -------------------------------------

@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(TC.Machine)])
def test_store_fingerprint_covers_every_machine_field(field):
    """Changing any one Machine field changes the analytic fingerprint
    (its durations too, where the field feeds them); equal fields give
    equal fingerprints."""
    g = TC.spmv_dag()
    base = TC.Machine()
    other = dataclasses.replace(base, **{field: getattr(base, field) * 1.5})
    fp = TE.make_evaluator(g, "sim", machine=base).store_fingerprint
    assert TE.make_evaluator(g, "vectorized",
                             machine=TC.Machine()).store_fingerprint == fp
    assert TE.make_evaluator(g, "sim",
                             machine=other).store_fingerprint != fp
    # The machine alone, at the same durations, moves it too.
    d = op_durations(g, base)
    assert store_fingerprint(g, other, d, "analytic") != \
        store_fingerprint(g, base, d, "analytic")
    assert len(fp) == FINGERPRINT_SIZE


def test_store_fingerprint_separates_analytic_and_measured(tmp_path):
    """sim and torch_wallclock never share a store address; a store
    warmed by sim replays through vectorized and pool with zero
    simulations, and not under another machine."""
    from repro_torch.spmv.distributed import from_reference
    from repro_torch.spmv.matrix import (band_matrix, partition,
                                         stack_partitions)
    g = TC.spmv_dag()
    A = band_matrix(n=256, nnz=1024, seed=0)
    x = np.random.default_rng(1).standard_normal(256).astype(np.float32)
    spmv = from_reference(stack_partitions(partition(A, 4)), x, "cpu")
    wall = TE.make_evaluator(g, "wallclock", impls=spmv.impls(),
                             env=spmv.env(), reset=spmv.poison,
                             device="cpu", store_tag=spmv.store_tag)
    sim = TE.make_evaluator(g, "sim")
    assert wall.store_fingerprint != sim.store_fingerprint
    path = str(tmp_path / "analytic.store")
    scheds = list(TC.enumerate_schedules(g, 2))[:40]
    with TE.make_evaluator(g, "sim", store_path=path) as cold:
        times = cold.evaluate(scheds)
    for backend, kw in (("vectorized", {}),
                        ("pool", {"n_workers": 2, "min_shard": 1})):
        with TE.make_evaluator(g, backend, store_path=path, **kw) as warm:
            assert warm.evaluate(scheds) == times
            assert (warm.cache_misses, warm.store_hits) == (0, 40)
    with TE.make_evaluator(g, "vectorized", store_path=path,
                           machine=as_port(RC.Machine())) as tpu:
        tpu.evaluate(scheds)
        assert (tpu.cache_misses, tpu.store_hits) == (40, 0)
