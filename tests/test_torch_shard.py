"""The distributed SpMV with one process per rank on the CPU.

The port's ``spmv/distributed.py`` (``halo_exchange``, ``spmv_shard``,
``make_rank_spmv``) runs on R gloo ranks, one process each, beside the
JAX package's ``make_distributed_spmv`` and ``_halo_exchange`` under
``shard_map`` over the first R of 4 host devices, for R in 1, 2 and 4
and the reference's four (overlap_local, use_kernel) cases; the
reference's kernel runs in interpret mode, as its own tests run it. The
matrix is ``tests/test_torch_slice.py``'s. Each halo is held to the
reference's bit for bit, each y within 1e-5 of max |y| of the
reference's and of the float64 oracle, and at 4 ranks the runner's y
to the one-process ``make_distributed_spmv``'s bit for bit: both sum a
row's slots in k order, and the slots one layout reads past a row's
length hold 0. The refusals run on the same ranks (``torch.cuda``'s
answers replaced where a card is pretended).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.spmv.distributed import make_distributed_spmv  # noqa: E402
from repro_torch.spmv.matrix import band_matrix, partition  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, NNZ, HB = 1024, 8192, 256
WORLDS = (1, 2, 4)
# (overlap_local, use_kernel): the JAX package's make_distributed_spmv
# options, each also make_rank_spmv's and spmv_shard's.
CASES = [(True, True), (True, False), (False, True), (False, False)]
PROBLEM = f"""
A = band_matrix(n={N}, nnz={NNZ}, half_bandwidth={HB}, seed=1)
x = np.random.default_rng(2).standard_normal({N}).astype(np.float32)
CASES = {CASES!r}
"""

REFERENCE = r"""
import sys
import numpy as np, jax
from jax.sharding import Mesh, PartitionSpec as P
from repro.dist.compat import shard_map
from repro.spmv.distributed import AXIS, _halo_exchange, make_distributed_spmv
from repro.spmv.matrix import band_matrix, partition, stack_partitions
""" + PROBLEM + r"""
out = sys.argv[1]
for world in (1, 2, 4):
    mesh = Mesh(np.array(jax.devices()[:world]), (AXIS,))
    st = stack_partitions(partition(A, world))
    xb = x.reshape(world, -1)
    for ol, uk in CASES:
        run = make_distributed_spmv(mesh, use_kernel=uk, overlap_local=ol)
        y = run(st["local_vals"], st["local_cols"], st["remote_vals"],
                st["remote_cols"], xb)
        np.save(f"{out}/y_{world}_{ol}_{uk}.npy", np.asarray(y).reshape(-1))
    halo = shard_map(lambda b: _halo_exchange(b[0])[None], mesh=mesh,
                     in_specs=P(AXIS), out_specs=P(AXIS),
                     check_vma=False)(xb)
    np.save(f"{out}/halo_{world}.npy", np.asarray(halo))
"""

RANKS = r"""
import dataclasses, sys, tempfile
import numpy as np, torch, torch.distributed as dist, torch.multiprocessing as mp
from repro_torch.spmv.matrix import band_matrix, partition
""" + PROBLEM + r"""

def refused(fn):
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "nothing raised"


def pretend_cards(count):
    # What torch.cuda answers on a machine with ``count`` cards.
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: count


def work(rank, world, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.spmv.distributed import (AXIS, halo_exchange,
                                              make_rank_spmv, spmv_shard)
    part = partition(A, world)[rank]
    m = part.m
    xb = x[rank * m:(rank + 1) * m]
    halo, works = halo_exchange(torch.from_numpy(xb.copy()))
    for w in works:
        w.wait()
    res = {"halo": halo.numpy()}
    ops = [torch.from_numpy(a) for a in (part.local.vals, part.local.cols,
                                         part.remote.vals, part.remote.cols)]
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=(AXIS,))
    for ol, uk in CASES:
        res[f"shard_{ol}_{uk}"] = spmv_shard(
            *ops, torch.from_numpy(xb.copy()), use_kernel=uk,
            overlap_local=ol).numpy()
        res[f"runner_{ol}_{uk}"] = make_rank_spmv(
            part, mesh, "cpu", use_kernel=uk, overlap_local=ol)(xb)
    other = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    res["no_card"] = refused(lambda: make_rank_spmv(part, mesh))
    res["wrong_axis"] = refused(lambda: make_rank_spmv(part, other, "cpu"))
    res["wrong_part"] = refused(lambda: make_rank_spmv(
        dataclasses.replace(part, n_ranks=world + 1), mesh, "cpu"))
    is_available, device_count = torch.cuda.is_available, \
        torch.cuda.device_count
    try:
        pretend_cards(world - 1)
        res["more_ranks_than_cards"] = refused(
            lambda: make_rank_spmv(part, mesh, "cuda"))
        pretend_cards(world)
        res["cpu_mesh_for_a_card"] = refused(
            lambda: make_rank_spmv(part, mesh, "cuda"))
    finally:
        torch.cuda.is_available = is_available
        torch.cuda.device_count = device_count
    np.savez(f"{out}/{rank}.npz", **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    world, out = int(sys.argv[1]), sys.argv[2]
    mp.spawn(work, args=(world, tempfile.mkdtemp() + "/store", out),
             nprocs=world)
"""

REFUSALS = {
    "no_card": "RuntimeError: CUDA is not available",
    "wrong_axis": "ValueError: the mesh's dimensions are ('data',)",
    "wrong_part": "ValueError: rank ",
    "more_ranks_than_cards": "RuntimeError: a group of ",
    "cpu_mesh_for_a_card": "ValueError: the mesh is on cpu, the data on cuda",
}


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference (one JAX process over 4 host devices) and the
    port's ranks (one spawn of R gloo processes for each R), all started
    together; each writes its arrays as .npy/.npz files."""
    tmp = tmp_path_factory.mktemp("shard")
    procs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp)], cwd=tmp,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    for world in WORLDS:
        (tmp / f"ranks{world}").mkdir()
        script = tmp / f"ranks{world}.py"
        script.write_text(RANKS)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(world),
             str(tmp / f"ranks{world}")], cwd=tmp, env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    ref = {f.stem: np.load(f) for f in tmp.glob("*.npy")}
    ranks = {world: [dict(np.load(tmp / f"ranks{world}" / f"{r}.npz"))
                     for r in range(world)] for world in WORLDS}
    return ref, ranks


@pytest.fixture(scope="module")
def problem():
    A = band_matrix(n=N, nnz=NNZ, half_bandwidth=HB, seed=1)
    x = np.random.default_rng(2).standard_normal(N).astype(np.float32)
    return A, x


@pytest.mark.parametrize("world", WORLDS)
def test_halo_equals_the_reference_bit_for_bit(runs, world):
    ref, ranks = runs
    for rank, res in enumerate(ranks[world]):
        np.testing.assert_array_equal(res["halo"], ref[f"halo_{world}"][rank],
                                      err_msg=f"rank {rank} of {world}")


@pytest.mark.parametrize("world", WORLDS)
def test_halo_slots_hold_the_neighbours_blocks(runs, problem, world):
    """[left block, right block], left as the reference's shift i -> i+1
    has it; in a world of two both are the one peer's, and each arrives
    (a swapped tag would leave gloo waiting), in a world of one both are
    the rank's own."""
    _, x = problem
    blocks = x.reshape(world, -1)
    for rank, res in enumerate(runs[1][world]):
        np.testing.assert_array_equal(
            res["halo"], np.concatenate([blocks[(rank - 1) % world],
                                         blocks[(rank + 1) % world]]))


def _y(ranks, key) -> np.ndarray:
    return np.concatenate([res[key] for res in ranks])


@pytest.mark.parametrize("form", ["shard", "runner"])
@pytest.mark.parametrize("overlap_local,use_kernel", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_y_matches_the_reference(runs, problem, world, overlap_local,
                                 use_kernel, form):
    """spmv_shard's and make_rank_spmv's y on every rank, within 1e-5 of
    max |y| of the reference's shard_map y and of the float64 oracle."""
    A, x = problem
    ref, ranks = runs
    want = ref[f"y_{world}_{overlap_local}_{use_kernel}"]
    got = _y(ranks[world], f"{form}_{overlap_local}_{use_kernel}")
    assert got.dtype == np.float32 and got.shape == (N,)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-5
    assert np.abs(got - A.matvec(x)).max() / scale < 1e-5


@pytest.mark.parametrize("overlap_local,use_kernel", CASES)
def test_four_ranks_equal_the_one_process_spmv(runs, problem, overlap_local,
                                               use_kernel):
    """At R = 4 the runners' y, gathered, is the one-process
    make_distributed_spmv's bit for bit."""
    A, x = problem
    one = make_distributed_spmv(partition(A, 4), "cpu",
                                use_kernel=use_kernel,
                                overlap_local=overlap_local)(x)
    np.testing.assert_array_equal(
        _y(runs[1][4], f"runner_{overlap_local}_{use_kernel}"), one)


@pytest.mark.parametrize("refusal", sorted(REFUSALS))
def test_the_runner_refuses(runs, refusal):
    """A card asked for where there is none; a mesh whose dimension is
    not AXIS; another rank's part; more ranks than cards; a CPU mesh for
    data on a card: each raises on every rank of every world."""
    for world in WORLDS:
        for rank, res in enumerate(runs[1][world]):
            said = str(res[refusal])
            assert said.startswith(REFUSALS[refusal]), (world, rank, said)
