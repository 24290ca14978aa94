"""What a stored time means in the port: schedule times are keyed on the
program an evaluator measures (``store_tag=``, which
``DistributedSpmv.store_tag`` supplies) and every measured time on the
build of the kernels (``:build=`` in the objective keys), so a shared
store never hands one program's or one build's times to another. On
the CPU, through the kernels' plain versions, at n <= 2,048."""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as C  # noqa: E402
import repro_torch.engine as E  # noqa: E402
from repro_torch.engine.wallclock import ExecutorEvaluator  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.autotune import spmv_mulsum_space  # noqa: E402
from repro_torch.spmv.distributed import from_reference  # noqa: E402
from repro_torch.spmv.matrix import (band_matrix, partition,  # noqa: E402
                                     stack_partitions)

N_SCHEDULES = 5


def _spmv(n, nnz, seed=0):
    A = band_matrix(n=n, nnz=nnz, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal(n).astype(
        np.float32)
    return from_reference(stack_partitions(partition(A, 4)), x, "cpu")


def _evaluate(spmv, path, tag=True):
    """Evaluate the first schedules of the SpMV DAG through a store at
    ``path``; the evaluator, after it closed its store."""
    g = C.spmv_dag()
    kw = {"store_tag": spmv.store_tag} if tag else {}
    with ExecutorEvaluator(g, impls=spmv.impls(), env=spmv.env(),
                           reset=spmv.poison, repeats=1, warmup=1,
                           device="cpu", store_path=path, **kw) as ev:
        scheds = list(C.enumerate_schedules(g, 2))[:N_SCHEDULES]
        ev.evaluate(scheds)
    return ev


@pytest.fixture(scope="module")
def small():
    return _spmv(1024, 8192)


def test_two_programs_on_one_store_do_not_share_times(small, tmp_path):
    """The fault this tag closes: without it the second program replays
    the first one's times; with it the second measures everything."""
    path = str(tmp_path / "schedules.store")
    first = _evaluate(small, path)
    assert (first.cache_misses, first.store_hits) == (N_SCHEDULES, 0)
    second = _evaluate(_spmv(2048, 32768), path)
    assert (second.cache_misses, second.store_hits) == (N_SCHEDULES, 0)
    assert second.store_fingerprint != first.store_fingerprint
    # The same two programs without tags alias, as the port's evaluator
    # did before it took store_tag=.
    untagged = str(tmp_path / "untagged.store")
    _evaluate(small, untagged, tag=False)
    aliased = _evaluate(_spmv(2048, 32768), untagged, tag=False)
    assert (aliased.cache_misses, aliased.store_hits) == (0, N_SCHEDULES)


def test_same_program_replays_warm_with_zero_measurements(small, tmp_path,
                                                          monkeypatch):
    path = str(tmp_path / "schedules.store")
    cold = _evaluate(small, path)
    assert cold.cache_misses == N_SCHEDULES

    def no_measuring(self, candidates):
        raise AssertionError("warm run called _measure_batch")
    monkeypatch.setattr(ExecutorEvaluator, "_measure_batch", no_measuring)
    warm = _evaluate(_spmv(1024, 8192), path)    # rebuilt: same tag
    assert (warm.cache_misses, warm.store_hits) == (0, N_SCHEDULES)
    assert warm.store_fingerprint == cold.store_fingerprint
    assert warm._cache == cold._cache


def test_tag_names_size_ranks_layout_and_operands(small):
    tag = small.store_tag
    for part in ("spmv:n=1024:nnz=8192:ranks=4:dtype=float32",
                 ":window=1024:block_n=256:slice_rows=32:operands="):
        assert part in tag
    assert _spmv(1024, 8192).store_tag == tag
    other_seed = _spmv(1024, 8192, seed=5).store_tag
    assert other_seed != tag
    assert other_seed.rsplit(":", 1)[0] == tag.rsplit(":", 1)[0]


def test_store_tag_goes_into_the_fingerprint(small):
    g = C.spmv_dag()

    def fp(**kw):
        return ExecutorEvaluator(g, impls=small.impls(), env=small.env(),
                                 reset=small.poison, device="cpu",
                                 **kw).store_fingerprint
    assert fp(store_tag="a") != fp(store_tag="b") != fp()
    assert fp(store_tag="a") == fp(store_tag="a")


@pytest.fixture
def copied_csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources that ``build`` reads instead."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    return csrc


def _flip_one_byte(path):
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 1
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("source", sorted(
    p.name for p in build.CSRC.iterdir()))
def test_source_hash_follows_every_kernel_source(copied_csrc, source):
    before = build.source_hash()
    assert before == build._build_dir().name
    _flip_one_byte(copied_csrc / source)
    after = build.source_hash()
    assert after != before and len(after) == 16
    assert build._build_dir().name == after


def test_rebuilt_kernels_change_both_evaluators_fingerprints(copied_csrc,
                                                             small):
    sp = spmv_mulsum_space(n=128, k=4, block_values=(32, 64), device="cpu")
    g = C.spmv_dag()

    def fingerprints():
        kern = E.make_evaluator(sp, "wallclock", repeats=1, device="cpu")
        sched = ExecutorEvaluator(g, impls=small.impls(), env=small.env(),
                                  reset=small.poison, device="cpu",
                                  store_tag=small.store_tag)
        for ev in (kern, sched):
            assert f":build={build.source_hash()}" in ev.objective_key()
        return kern.store_fingerprint, sched.store_fingerprint

    old = fingerprints()
    _flip_one_byte(copied_csrc / "ell_onehot.cu")
    new = fingerprints()
    assert new[0] != old[0] and new[1] != old[1]


def test_kernel_store_written_on_another_build_is_not_replayed(
        copied_csrc, tmp_path):
    path = str(tmp_path / "kernels.store")
    sp = spmv_mulsum_space(n=128, k=4, block_values=(32, 64), device="cpu")

    def sweep():
        with E.make_evaluator(sp, "wallclock", repeats=1, device="cpu",
                              store_path=path) as ev:
            ev.evaluate(list(sp.enumerate_candidates()))
        return ev.cache_misses, ev.store_hits

    assert sweep() == (2, 0)
    assert sweep() == (0, 2)
    _flip_one_byte(copied_csrc / "ell_spmv.cu")
    assert sweep() == (2, 0)
