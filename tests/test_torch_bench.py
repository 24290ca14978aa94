"""The paper's measurement protocol (``core/bench.py``) against the JAX
package's, and ``ExecutorEvaluator(t_measure_s=...)`` on the CPU
through the plain kernels: the gate runs before any window is timed,
and the objective key names the protocol. On the card:
tests/test_torch_cuda.py."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bench as r_bench  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.core import bench  # noqa: E402
from repro_torch.engine import wallclock  # noqa: E402
from repro_torch.engine.wallclock import ExecutorEvaluator  # noqa: E402
from repro_torch.spmv.distributed import from_reference  # noqa: E402
from repro_torch.spmv.matrix import (band_matrix, partition,  # noqa: E402
                                     stack_partitions)

CPU = torch.device("cpu")


def counter():
    calls = []
    return calls, lambda: calls.append(time.perf_counter())


@pytest.mark.parametrize("min_samples", [1, 5])
def test_measure_makes_one_warmup_then_min_samples(min_samples):
    """With t_measure_s=0: one warm-up call, then exactly min_samples
    timed ones, as the reference's measure makes."""
    calls, fn = counter()
    r_calls, r_fn = counter()
    t = bench.measure(fn, t_measure_s=0.0, min_samples=min_samples)
    r_bench.measure(r_fn, t_measure_s=0.0, min_samples=min_samples)
    assert len(calls) == len(r_calls) == 1 + min_samples
    assert t >= 0.0
    assert bench.T_MEASURE_S == r_bench.T_MEASURE_S == 0.01


@pytest.mark.parametrize("min_samples", [1, 5])
def test_measure_cuda_counts_like_measure_on_the_cpu(min_samples):
    calls, fn = counter()
    bench.measure_cuda(fn, CPU, t_measure_s=0.0, min_samples=min_samples)
    assert len(calls) == 1 + min_samples


@pytest.mark.parametrize("measure", ["measure", "measure_cuda"])
def test_window_is_elapsed_over_samples(measure):
    """A 20 ms window of 1 ms calls: about 20 samples, each reported at
    about its own length (the warm-up call is not in the window)."""
    calls, _ = counter()

    def fn():
        calls.append(None)
        time.sleep(0.001)

    args = (fn,) if measure == "measure" else (fn, CPU)
    t = getattr(bench, measure)(*args, t_measure_s=0.02)
    assert 0.001 <= t < 0.005
    assert 5 <= len(calls) - 1 <= 21


@pytest.fixture(scope="module")
def spmv():
    A = band_matrix(n=2048, nnz=16384, seed=5)
    x = np.random.default_rng(6).standard_normal(2048).astype(np.float32)
    return from_reference(stack_partitions(partition(A, 4)), x, CPU)


def evaluator(spmv, **kw):
    return ExecutorEvaluator(TC.spmv_dag(), impls=spmv.impls(),
                             env=spmv.env(), reset=spmv.poison,
                             device=CPU, store_tag=spmv.store_tag, **kw)


def test_paper_protocol_gates_then_times(spmv, monkeypatch):
    """t_measure_s makes each of the repeats samples one measure_cuda
    window; every window starts after the schedule passed the gate, and
    the time is their median."""
    ev = evaluator(spmv, repeats=3, t_measure_s=0.002)
    windows = []

    def spy(fn, device, t_measure_s, min_samples=1):
        windows.append((ev.n_checked, device, t_measure_s))
        return [0.003, 0.001, 0.002][len(windows) - 1]

    monkeypatch.setattr(wallclock, "measure_cuda", spy)
    g = TC.spmv_dag()
    sched = list(TC.enumerate_schedules(g, 2))[17]
    assert ev.evaluate([sched]) == [0.002]
    assert windows == [(1, CPU, 0.002)] * 3


def test_paper_protocol_refuses_a_wrong_schedule_before_timing(spmv,
                                                               monkeypatch):
    """A schedule whose outputs differ from the reference's (here a yR
    that draws new values on every run) fails the gate, and no window is
    timed."""
    impls = spmv.impls()
    impls["yR"] = lambda env: {"yR": torch.rand(env["x"].shape)}
    ev = ExecutorEvaluator(TC.spmv_dag(), impls=impls, env=spmv.env(),
                           reset=spmv.poison, repeats=2, t_measure_s=0.001,
                           device=CPU)
    windows = []
    monkeypatch.setattr(wallclock, "measure_cuda",
                        lambda *a, **k: windows.append(a) or 1.0)
    sched = next(iter(TC.enumerate_schedules(TC.spmv_dag(), 2)))
    with pytest.raises(AssertionError, match="diverged"):
        ev.evaluate([sched])
    assert windows == []


def test_paper_protocol_measures_on_the_cpu(spmv):
    """Real windows through the plain kernels at n = 2,048: finite,
    positive, and two schedules kept apart."""
    ev = evaluator(spmv, repeats=2, t_measure_s=0.003)
    scheds = list(TC.enumerate_schedules(TC.spmv_dag(), 2))[:2]
    times = ev.evaluate(scheds)
    assert ev.n_checked == 2 and ev.cache_misses == 2
    assert all(np.isfinite(t) and 0.0 < t < 0.1 for t in times)


def test_objective_key_names_the_protocol(spmv):
    median, window = evaluator(spmv), evaluator(spmv, t_measure_s=0.01)
    assert ":t_measure=" not in median.objective_key()
    assert ":t_measure=0.01:" in window.objective_key()
    assert median.objective_key().startswith("torch_wallclock:cpu:")
    assert median.store_fingerprint != window.store_fingerprint
    assert evaluator(spmv, t_measure_s=0.05).store_fingerprint != \
        window.store_fingerprint
    with pytest.raises(ValueError, match="t_measure_s"):
        evaluator(spmv, t_measure_s=-1.0)
