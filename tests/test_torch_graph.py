"""The compiled schedule runner on the CPU: ``jit_runner`` against the JAX
package's ``jit_runner`` on every schedule of the SpMV DAG, its refusal
of other inputs, ``host_wait``, the graph objective's key and store, and
the distributed SpMV's compiled step. Its CUDA-graph capture runs only
on a card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.engine.wallclock as RW  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.core.executor import (build_runner, host_wait,  # noqa: E402
                                       jit_runner)
from repro_torch.engine.wallclock import (ExecutorEvaluator,  # noqa: E402
                                          demo_spmv_impls)
from repro_torch.spmv.distributed import (DistributedSpmv,  # noqa: E402
                                          from_reference,
                                          make_distributed_spmv)
from repro_torch.spmv.matrix import (band_matrix, partition,  # noqa: E402
                                     stack_partitions)

G = TC.spmv_dag()
SCHEDULES = list(TC.enumerate_schedules(G, 2))
DEMO_OUTPUTS = ("sendbuf", "wire", "recvbuf", "sent", "xR", "yL", "yR")
N, NNZ, HB = 4096, 32768, 1024


def to_reference(s):
    return RC.Schedule(tuple(RC.BoundOp(i.name, i.stream) for i in s.items))


@pytest.fixture(scope="module")
def demo():
    g = RC.spmv_dag()
    return (demo_spmv_impls(G, device="cpu"), g, RW.demo_spmv_impls(g))


@pytest.fixture(scope="module")
def problem():
    A = band_matrix(n=N, nnz=NNZ, half_bandwidth=HB, seed=7)
    x = np.random.default_rng(8).standard_normal(N).astype(np.float32)
    return A, x, partition(A, 4)


def test_every_schedule_is_parametrised():
    assert len(SCHEDULES) == 280


@pytest.mark.parametrize("i", range(len(SCHEDULES)))
def test_jit_runner_matches_the_reference_jit_runner(demo, i):
    """Each output of the schedule's compiled runner, first call and a
    second, against the JAX package's ``jax.jit(build_runner(...))`` on
    its own demo op set (the same seeded bits). The copies and the
    exchange's sum are exact, so they are equal bit for bit; the
    products, and y = yL + yR, within the reference's own bound
    (``tests/test_executor.py``: 1e-6), taken of max |y|: the two
    frameworks sum a 16-term float32 product in their own order."""
    (impls, env), rg, (r_impls, r_env) = demo
    run = jit_runner(G, SCHEDULES[i], impls, "cpu")
    first, second = run(env), run(env)
    ref = RC.jit_runner(rg, to_reference(SCHEDULES[i]), r_impls)(r_env)
    ref = {**ref, "y": ref["yL"] + ref["yR"]}
    for out in (first, second):
        out["y"] = out["yL"] + out["yR"]
    for k in (*DEMO_OUTPUTS, "y"):
        want = np.asarray(ref[k])
        if k in ("yL", "yR", "y"):
            np.testing.assert_allclose(first[k].numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(first[k].numpy(), want,
                                          err_msg=k)
        np.testing.assert_array_equal(second[k].numpy(), first[k].numpy())


def test_host_wait_on_the_cpu_waits_on_nothing(problem):
    """An op on the CPU has no event to wait on: ``host_wait(None)``, the
    SpMV's WaitSend and WaitRecv, and the demo's WaitRecv return at once
    with their values."""
    assert host_wait(None) is None
    _, x, parts = problem
    spmv = from_reference(stack_partitions(parts), x, "cpu")
    assert DistributedSpmv.wait(None) is None
    assert spmv.wait_recv(None, spmv.halo) is spmv.halo
    impls, env = demo_spmv_impls(G, device="cpu")
    out = impls["WaitRecv"]({"wire": env["xL"], "recvbuf": env["xL"]})
    torch.testing.assert_close(out["xR"], 2 * env["xL"], rtol=0, atol=0)


def test_jit_runner_refuses_other_inputs():
    """The first call fixes the inputs' names, shapes and dtypes; another
    tensor of the same shape runs on its own values; ``release`` lets
    the next call fix them again."""
    impls, env = demo_spmv_impls(G, device="cpu")
    run = jit_runner(G, SCHEDULES[5], impls, "cpu")
    run(env)
    for bad in ({"xL": torch.zeros(8)},
                {"xL": env["xL"].double()},
                {"xL": env["xL"], "extra": env["xL"]},
                {}):
        with pytest.raises(ValueError):
            run(bad)
    other = {"xL": torch.arange(16, dtype=torch.float32)}
    want = build_runner(G, SCHEDULES[5], impls, "cpu")(other)
    got = run(other)
    for k in ("yL", "yR"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    run.release()
    assert run({"xL": torch.ones(16)})["yL"].shape == (16,)


def test_jit_runner_raises_without_cuda(monkeypatch):
    """``device=None`` means CUDA: without a card it raises, never runs
    on the CPU quietly."""
    impls, _ = demo_spmv_impls(G, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        jit_runner(G, SCHEDULES[0], impls)


def _evaluator(path, cuda_graph):
    impls, env = demo_spmv_impls(G, device="cpu")
    return ExecutorEvaluator(G, impls=impls, env=env, reset=lambda: None,
                             repeats=1, device="cpu", store_path=path,
                             cuda_graph=cuda_graph)


def test_graph_objective_has_its_own_key_and_store(tmp_path):
    """The graph objective's key differs from the eager one's only by
    ``:graph``; a store written under one answers nothing of the other,
    and answers its own."""
    path = str(tmp_path / "times.store")
    scheds = SCHEDULES[:6]
    with _evaluator(path, False) as eager:
        eager.evaluate(scheds)
    with _evaluator(path, True) as graph:
        graph.evaluate(scheds)
    assert eager.objective_key() != graph.objective_key()
    assert graph.objective_key().replace(":graph", "") == \
        eager.objective_key()
    assert (eager.cache_misses, eager.store_hits) == (6, 0)
    assert (graph.cache_misses, graph.store_hits) == (6, 0)
    assert graph.n_checked == 6
    for cuda_graph in (False, True):
        with _evaluator(path, cuda_graph) as again:
            again.evaluate(scheds)
        assert (again.cache_misses, again.store_hits) == (0, 6)


def test_graph_objective_gates_every_schedule_on_the_cpu():
    """Under ``cuda_graph=True`` every schedule's compiled runner is
    gated against the reference schedule's outputs."""
    impls, env = demo_spmv_impls(G, device="cpu")
    ev = ExecutorEvaluator(G, impls=impls, env=env, reset=lambda: None,
                           repeats=1, device="cpu", cuda_graph=True)
    times = ev.evaluate(SCHEDULES)
    assert ev.n_checked == len(times) == 280 and min(times) > 0


@pytest.mark.parametrize("seed", range(4))
def test_jit_runner_on_the_distributed_spmv(problem, seed):
    """The 4-rank SpMV's op set at n = 4,096: each of 5 seeded schedules'
    compiled runner gives the eager runner's outputs bit for bit, from
    poisoned buffers, on its first call and a second."""
    _, x, parts = problem
    spmv = from_reference(stack_partitions(parts), x, "cpu")
    rng = np.random.default_rng(seed)
    for i in rng.choice(len(SCHEDULES), 5, replace=False):
        spmv.poison()
        want = {k: build_runner(G, SCHEDULES[i], spmv.impls(), "cpu")(
            spmv.env())[k].clone() for k in ("yL", "yR")}
        run = jit_runner(G, SCHEDULES[i], spmv.impls(), "cpu")
        for _ in range(2):
            spmv.poison()
            got = run(spmv.env())
            for k, v in want.items():
                assert bool(torch.isfinite(v).all())
                torch.testing.assert_close(got[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("overlap_local", [True, False])
def test_make_distributed_spmv_run_and_replay_give_the_step(problem,
                                                           overlap_local):
    """``run(x)`` and ``run.replay()`` (the compiled step) give the eager
    ``run.step()``'s y bit for bit, and the oracle's within 1e-5."""
    A, x, parts = problem
    run = make_distributed_spmv(parts, "cpu", overlap_local=overlap_local)
    y = run(x)
    step, replay = run.step(), run.replay()
    want = (step["yL"] + step["yR"]).numpy()
    np.testing.assert_array_equal(y, want)
    np.testing.assert_array_equal((replay["yL"] + replay["yR"]).numpy(),
                                  want)
    ref = A.matvec(x)
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("cuda_graph", [False, True])
def test_evaluator_phases_are_spans_of_each_design(cuda_graph):
    """Under a registry each design measured is one ``engine.gate`` and
    one ``engine.timing`` (and, compiled, one ``executor.capture``)
    inside ``engine.measure``, each with the design's digest;
    ``engine.reference`` runs once, inside the first gate; and
    ``engine.gate_bytes`` is the bytes of every gated run's outputs."""
    from repro_torch import obs

    impls, env = demo_spmv_impls(G, device="cpu")
    ev = ExecutorEvaluator(G, impls=impls, env=env, reset=lambda: None,
                           repeats=2, warmup=2, device="cpu",
                           cuda_graph=cuda_graph)
    scheds = SCHEDULES[:5]
    ex = obs.MemoryExporter()
    tel = obs.Telemetry([ex])
    with obs.use(tel):
        ev.evaluate(scheds)
        ev.close()
    spans = tel.spans_by_name()
    n = len(scheds)
    assert spans["engine.gate"]["count"] == spans["engine.timing"][
        "count"] == n
    assert spans["engine.reference"]["count"] == 1
    assert spans.get("executor.capture", {}).get("count", 0) == \
        (n if cuda_graph else 0)
    assert spans.get("executor.release", {}).get("count", 0) == \
        (n if cuda_graph else 0)
    out_bytes = sum(4 * 16 for _ in DEMO_OUTPUTS)
    assert tel.counters()["engine.gate_bytes"] == (n + 1) * out_bytes
    begins = [e for e in ex.events if e["ph"] == "B"]
    measure = [e for e in begins if e["name"] == "engine.measure"]
    assert len(measure) == 1
    parent = {e["span_id"]: e for e in begins}
    designs = {}
    for e in begins:
        if e["name"] in ("engine.gate", "engine.timing", "executor.capture"):
            assert parent[e["parent_id"]]["name"] == "engine.measure"
            designs.setdefault(e["args"]["design"], []).append(e["name"])
        if e["name"] == "engine.reference":
            assert parent[e["parent_id"]]["name"] == "engine.gate"
    assert len(designs) == n
    phases = ["engine.gate", "engine.timing"]
    if cuda_graph:
        phases = ["executor.capture"] + phases
    assert all(got == phases for got in designs.values())
    # The measure's self time is its wall less its children's: the
    # phases and the releases of earlier designs' graphs (the last goes
    # at close, outside).
    ts = {(e["span_id"], e["ph"]): e["ts"] for e in ex.events
          if e["ph"] in "BE"}
    children = [e["span_id"] for e in begins
                if e["parent_id"] == measure[0]["span_id"]]
    assert len(children) == len(phases) * n + (n - 1 if cuda_graph else 0)
    inside_us = sum(ts[i, "E"] - ts[i, "B"] for i in children)
    assert spans["engine.measure"]["self_s"] == pytest.approx(
        spans["engine.measure"]["total_s"] - inside_us / 1e6, abs=1e-5)
