"""The port's last pieces of the JAX package's surface, held to it on the
CPU: the distributed SpMV's two orderings (their values against the JAX
package's are in ``tests/test_torch_slice.py``), ``demo_spmv_impls``,
``featurize_like`` and ``examples/torch_halo3d.py`` against
``examples/halo3d.py``."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.engine as RE  # noqa: E402
import repro.search as RS  # noqa: E402
import repro_torch.core as TC  # noqa: E402
import repro_torch.engine as TE  # noqa: E402
from repro_torch.core.sync import expanded_names  # noqa: E402
from repro_torch.engine.wallclock import reference_schedule  # noqa: E402
from repro_torch.spmv.distributed import (make_distributed_spmv,  # noqa: E402
                                          ordering)
from repro_torch.spmv.matrix import band_matrix, partition  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, NNZ, HB = 1024, 8192, 256


def to_port(s):
    return TC.Schedule(tuple(TC.BoundOp(i.name, i.stream) for i in s.items))


# -- the distributed SpMV ------------------------------------------------------

@pytest.fixture(scope="module")
def spmv_problem():
    A = band_matrix(n=N, nnz=NNZ, half_bandwidth=HB, seed=1)
    x = np.random.default_rng(2).standard_normal(N).astype(np.float32)
    return A, x


@pytest.mark.parametrize("overlap_local", [True, False])
def test_orderings_issue_the_local_multiply_where_the_reference_does(
        overlap_local):
    """The fast ordering issues yL after PostSend and PostRecv and before
    either wait; the slow one after the waits and yR. Both run every GPU
    op on stream 0 and differ from the executor's reference schedule
    only in order."""
    g = TC.spmv_dag()
    sched = ordering(g, overlap_local)
    names = expanded_names(g, sched)
    at = {n: names.index(n) for n in g.ops}
    if overlap_local:
        assert at["PostSend"] < at["yL"] and at["PostRecv"] < at["yL"]
        assert at["yL"] < at["WaitSend"] and at["yL"] < at["WaitRecv"]
    else:
        assert at["WaitSend"] < at["yR"] < at["yL"]
        assert at["WaitRecv"] < at["yR"]
    assert {i.stream for i in sched.items if i.name in g.gpu_ops()} == {0}
    assert sorted(sched.order()) == sorted(reference_schedule(g).order())


def test_plain_route_runs_plain_versions_on_the_cpu_buffers(spmv_problem):
    """use_kernel=False writes the same preallocated buffers as the
    kernel route, through the plain versions."""
    A, x = spmv_problem
    runs = [make_distributed_spmv(partition(A, 4), "cpu", use_kernel=uk)
            for uk in (True, False)]
    ys = [run(x) for run in runs]
    np.testing.assert_array_equal(ys[0], ys[1])
    for run in runs:
        env = run.step()
        assert env["yL"].data_ptr() == run.spmv.yL.data_ptr()
        assert env["yR"].data_ptr() == run.spmv.yR.data_ptr()


# -- demo_spmv_impls -------------------------------------------------------------

def _reference_op(impls, op, env):
    """One of the JAX package's token-threaded ops on ``env``."""
    import jax.numpy as jnp

    return impls[op](env, jnp.zeros((), jnp.float32))[0][op]


@pytest.mark.parametrize("n,seed", [(16, 0), (8, 3)])
def test_demo_inputs_are_the_reference_bits(n, seed):
    """xL from the env; AL and AR from each side's yL and yR on the
    identity (a product with one non-zero term is exact)."""
    r_impls, r_env = RE.demo_spmv_impls(RC.spmv_dag(), n=n, seed=seed)
    t_impls, t_env = TE.demo_spmv_impls(TC.spmv_dag(), n=n, seed=seed,
                                        device="cpu")
    np.testing.assert_array_equal(np.asarray(r_env["xL"]),
                                  t_env["xL"].numpy())
    eye_r, eye_t = np.eye(n, dtype=np.float32), torch.eye(n)
    for op, arg in (("yL", "xL"), ("yR", "xR")):
        np.testing.assert_array_equal(
            np.asarray(_reference_op(r_impls, op, {arg: eye_r})),
            t_impls[op]({arg: eye_t})[op].numpy())


def test_demo_wallclock_search_gates_every_schedule():
    """Every schedule of spmv_dag() at 2 streams through the CPU
    wall-clock evaluator; the reference schedule's outputs are the JAX
    package's within float32 rounding of a 16-term product (xR is xL:
    the demo's pack and exchange copy it)."""
    g = TC.spmv_dag()
    impls, env = TE.demo_spmv_impls(g, device="cpu")
    ev = TE.make_evaluator(g, "wallclock", impls=impls, env=env,
                           reset=lambda: None, device="cpu", repeats=1)
    scheds = list(TC.enumerate_schedules(g, 2))
    times = ev.evaluate(scheds)
    assert len(scheds) == ev.n_checked == 280
    assert all(t > 0 for t in times)
    r_impls, r_env = RE.demo_spmv_impls(RC.spmv_dag())
    ref = ev.reference_outputs()
    for op, arg in (("yL", "xL"), ("yR", "xR")):
        want = np.asarray(_reference_op(r_impls, op, {arg: r_env["xL"]}))
        np.testing.assert_allclose(ref[op], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


# -- featurize_like ----------------------------------------------------------------

@pytest.mark.parametrize("budget", [40, 120])
def test_featurize_like_on_an_mcts_subset_basis(budget):
    """Table V's evaluation: the whole space in the feature basis of an
    MCTS subset, equal to the JAX package's."""
    rg, tg = RC.spmv_dag(), TC.spmv_dag()
    res = RS.run_search(rg, RS.MCTSSearch(rg, 2, seed=0), budget=budget)
    every = list(RC.enumerate_schedules(rg, 2))
    r_basis = RC.featurize(rg, res.schedules)
    t_basis = TC.featurize(tg, [to_port(s) for s in res.schedules])
    assert r_basis.names() == t_basis.names()
    r_x = RC.featurize_like(rg, every, r_basis)
    t_x = TC.featurize_like(tg, [to_port(s) for s in every], t_basis)
    assert t_x.shape == (280, len(t_basis.features))
    np.testing.assert_array_equal(r_x, t_x)


# -- examples/torch_halo3d.py ------------------------------------------------------

NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e-?\d+)?")


def _example(name: str, *args: str) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, os.path.join(REPO, "examples",
                                                       name), *args],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_reference_machine_is_the_reference_defaults():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import torch_halo3d
    finally:
        sys.path.pop(0)
    assert dataclasses.asdict(torch_halo3d.REFERENCE_MACHINE) == \
        dataclasses.asdict(RC.Machine())


def test_halo3d_example_prints_the_reference_example():
    """Schedules explored, spread, times, the best schedule's sends
    before Inner, the classes and the rules table: the same text, and
    every number within 1e-9 relative."""
    ref = _example("halo3d.py", "--iters", "300")
    got = _example("torch_halo3d.py", "--machine", "reference",
                   "--iters", "300")
    assert NUMBER.sub("#", got) == NUMBER.sub("#", ref)
    want = [float(v) for v in NUMBER.findall(ref)]
    have = [float(v) for v in NUMBER.findall(got)]
    assert len(have) == len(want) and len(want) > 10
    for a, b in zip(have, want):
        assert abs(a - b) <= 1e-9 * max(abs(b), 1e-300)
    assert "explored 300 schedules" in got and "design rules:" in got


def test_halo3d_example_runs_on_the_h100_model():
    out = _example("torch_halo3d.py", "--iters", "60", "--streams", "2")
    assert out.startswith("3-D halo DAG: 39 vertices (13 GPU ops")
    assert "explored 60 schedules" in out and "design rules:" in out
