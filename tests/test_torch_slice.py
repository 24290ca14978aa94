"""The slice as a whole on the CPU: the port's 4-rank SpMV against the
JAX package's shard_map SpMV, every schedule of the SpMV DAG through the
executor and the value gate, the quickstart chain, and entry points
that refuse to fall back to the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as C  # noqa: E402
from repro_torch.core.executor import build_runner, op_impl, run_items  # noqa: E402,E501
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.engine.wallclock import (ExecutorEvaluator,  # noqa: E402
                                          reference_schedule)
from repro_torch.kernels.spmv.ops import (BLOCK_N, WINDOW,  # noqa: E402
                                          row_lengths, unsliced)
from repro_torch.spmv.distributed import (from_reference,  # noqa: E402
                                          make_distributed_spmv)
from repro_torch.spmv.matrix import (band_matrix, partition,  # noqa: E402
                                     stack_partitions)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, NNZ, HB = 1024, 8192, 256


@pytest.fixture(scope="module")
def problem():
    A = band_matrix(n=N, nnz=NNZ, half_bandwidth=HB, seed=1)
    x = np.random.default_rng(2).standard_normal(N).astype(np.float32)
    return A, x, partition(A, 4)


# (overlap_local, use_kernel): the JAX package's make_distributed_spmv
# options, each also make_distributed_spmv's of the port.
DIST_CASES = [(True, True), (True, False), (False, True), (False, False)]


@pytest.fixture(scope="module")
def jax_ys(problem, tmp_path_factory):
    """The JAX package's shard_map SpMV over 4 CPU devices in each of
    ``DIST_CASES``, from one subprocess (the device count is fixed
    before JAX starts)."""
    A, x, _ = problem
    tmp = tmp_path_factory.mktemp("dist")
    np.save(tmp / "x.npy", x)
    code = f"""
import numpy as np, jax
from jax.sharding import Mesh
from repro.spmv.matrix import band_matrix, partition, stack_partitions
from repro.spmv.distributed import make_distributed_spmv
A = band_matrix(n={N}, nnz={NNZ}, half_bandwidth={HB}, seed=1)
x = np.load({str(tmp / "x.npy")!r})
st = stack_partitions(partition(A, 4))
mesh = Mesh(np.array(jax.devices()[:4]), ("ranks",))
for ol, uk in {DIST_CASES!r}:
    run = make_distributed_spmv(mesh, use_kernel=uk, overlap_local=ol)
    y = run(st["local_vals"], st["local_cols"], st["remote_vals"],
            st["remote_cols"], x.reshape(4, -1))
    np.save({str(tmp)!r} + f"/y_{{ol}}_{{uk}}.npy", np.asarray(y).reshape(-1))
"""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=560)
    assert out.returncode == 0, out.stderr[-4000:]
    return {c: np.load(tmp / f"y_{c[0]}_{c[1]}.npy") for c in DIST_CASES}


def test_four_rank_spmv_matches_jax_shard_map(problem, jax_ys):
    A, x, parts = problem
    y_jax = jax_ys[True, True]
    y = make_distributed_spmv(parts, device="cpu")(x)
    ref = A.matvec(x)
    scale = np.abs(ref).max()
    assert np.abs(y - y_jax).max() / scale < 1e-5
    assert np.abs(y - ref).max() / scale < 1e-5


@pytest.mark.parametrize("overlap_local,use_kernel", DIST_CASES)
def test_orderings_and_plain_route_match_jax_shard_map(
        problem, jax_ys, overlap_local, use_kernel):
    """Each of the JAX package's (overlap_local, use_kernel) cases
    against the port's, within 1e-5 of max |y|."""
    A, x, parts = problem
    run = make_distributed_spmv(parts, "cpu", use_kernel=use_kernel,
                                overlap_local=overlap_local)
    y = run(x)
    ref = jax_ys[overlap_local, use_kernel]
    scale = np.abs(ref).max()
    assert np.abs(y - ref).max() / scale < 1e-5
    assert np.abs(y - A.matvec(x)).max() / scale < 1e-5
    assert run.spmv.use_kernel is use_kernel


def test_from_reference_layout(problem):
    """The sorted-slice operands, built from the very arrays the JAX
    package's shard_map consumes: un-permuted they are those arrays
    stacked K-major with rank-offset columns; each perm is a permutation
    that keeps every BLOCK_N-row CTA block inside one WINDOW-row window
    and sorts its rows longest first; slice_k is each 32-row slice's
    widest row."""
    A, x, parts = problem
    st = stack_partitions(parts)
    spmv = from_reference(st, x, "cpu")
    r_n, m, _ = st["local_vals"].shape
    n = r_n * m
    for part, key, width in ((spmv.local, "local", m),
                             (spmv.remote, "remote", 2 * m)):
        vals_t, cols_t, slice_k, perm = part
        k = st[f"{key}_vals"].shape[2]
        assert vals_t.shape == (k, n) and cols_t.dtype == torch.int32
        assert perm.dtype == slice_k.dtype == torch.int32
        p = perm.long()
        assert torch.equal(torch.sort(p).values, torch.arange(n))
        for b0 in range(0, n, BLOCK_N):
            assert len(set((p[b0:b0 + BLOCK_N] // WINDOW).tolist())) == 1
        rv, rc = unsliced(part)
        for r in range(r_n):
            np.testing.assert_array_equal(rv[:, r * m:(r + 1) * m].numpy(),
                                          st[f"{key}_vals"][r].T)
            np.testing.assert_array_equal(
                rc[:, r * m:(r + 1) * m].numpy(),
                st[f"{key}_cols"][r].T + r * width)
        length = row_lengths(vals_t)
        for b0 in range(0, n, BLOCK_N):
            seg = length[b0:b0 + BLOCK_N]
            assert bool((seg[:-1] >= seg[1:]).all())
        assert slice_k.tolist() == [int(length[i:i + 32].max())
                                    for i in range(0, n, 32)]
    assert not torch.equal(spmv.local.perm, spmv.remote.perm)
    with pytest.raises(ValueError):
        from_reference(st, x[:-4], "cpu")


def _evaluator(problem, **kw):
    A, x, parts = problem
    spmv = from_reference(stack_partitions(parts), x, "cpu")
    g = C.spmv_dag()
    ev = ExecutorEvaluator(g, impls=spmv.impls(), env=spmv.env(),
                           reset=spmv.poison, device="cpu", **kw)
    return g, spmv, ev


def test_every_schedule_passes_the_gate(problem):
    A, x, _ = problem
    g, _, ev = _evaluator(problem, repeats=1, warmup=1)
    scheds = list(C.enumerate_schedules(g, 2))
    times = ev.evaluate(scheds)
    assert len(scheds) == 280 and ev.n_checked == 280
    assert all(t > 0 for t in times)
    ref = ev.reference_outputs()
    y = ref["yL"].astype(np.float64) + ref["yR"]
    oracle = A.matvec(x)
    assert np.abs(y - oracle).max() / np.abs(oracle).max() < 1e-5
    assert ev.objective_key().startswith("torch_wallclock:cpu:")


def test_gate_catches_a_skipped_exchange(problem):
    """With PostSend's halo copies left out, the poisoned halo reaches
    yR and the gate fails; the intact impls pass."""
    g, _, ev = _evaluator(problem)
    items = C.expand(g, reference_schedule(g))
    ev.check(run_items(g, items, ev.impls, "cpu"), "intact")
    broken = dict(ev.impls,
                  PostSend=op_impl(lambda buf: None, ["sendbuf"], ["sent"]))
    with pytest.raises(AssertionError, match="diverged"):
        ev.check(run_items(g, items, broken, "cpu"), "without copies")
    assert ev.n_checked == 1


def test_quickstart_chain_yields_rules(capsys):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import torch_quickstart
    finally:
        sys.path.pop(0)
    torch_quickstart.main(["--device", "cpu", "--n", str(N), "--nnz",
                           str(NNZ), "--iters", "120", "--repeats", "2"])
    out = capsys.readouterr().out
    assert "torch_wallclock:cpu" in out
    assert "passed the value gate" in out
    assert "## performance class 1" in out


def test_entry_points_raise_without_cuda(problem, monkeypatch):
    """device=None means CUDA; without a card it raises, never runs on
    the CPU quietly."""
    A, x, parts = problem
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = C.spmv_dag()
    st = stack_partitions(parts)
    cpu = from_reference(st, x, "cpu")
    calls = [
        lambda: resolve_device(),
        lambda: from_reference(st, x),
        lambda: make_distributed_spmv(parts),
        lambda: build_runner(g, reference_schedule(g), cpu.impls()),
        lambda: ExecutorEvaluator(g, impls=cpu.impls(), env=cpu.env(),
                                  reset=cpu.poison),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # The dry run builds on the meta device when it asks for it; a
    # device type the port does not run on still raises.
    assert resolve_device("meta") == torch.device("meta")
    with pytest.raises(ValueError):
        resolve_device("mps")
