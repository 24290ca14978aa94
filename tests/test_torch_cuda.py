"""Card-only checks of the port: each hand-written kernel against its
plain PyTorch version, the launch counters, and the two race checks (a
removed sync must fail the value gate). Skipped without a CUDA device;
on the card: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.pack import kernel as pack_k  # noqa: E402
from repro_torch.kernels.pack.ops import pack, pack_plain  # noqa: E402
from repro_torch.kernels.spmv import kernel as spmv_k  # noqa: E402
from repro_torch.kernels.spmv.ops import ell_matvec, ell_spmv_plain  # noqa: E402,E501
from repro_torch.spmv.distributed import from_reference  # noqa: E402
from repro_torch.spmv.matrix import (band_matrix, partition,  # noqa: E402
                                     stack_partitions)

pytestmark = pytest.mark.cuda

# chip_smoke.py lives at the repository root, which pytest does not put
# on sys.path by itself (tests/ is not a package).
REPO_ROOT = str(Path(__file__).resolve().parents[1])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def small_spmv(dev):
    A = band_matrix(n=4096, nnz=32768, half_bandwidth=1024, seed=3)
    x = np.random.default_rng(4).standard_normal(4096).astype(np.float32)
    return A, x, from_reference(stack_partitions(partition(A, 4)), x, dev)


@pytest.mark.parametrize("n,k,dtype", [
    (64, 1, torch.float32), (300, 7, torch.float32),
    (1024, 16, torch.bfloat16), (2048, 5, torch.bfloat16)])
def test_ell_spmv_kernel_matches_plain(dev, n, k, dtype):
    rng = np.random.default_rng(n + k)
    vals = torch.from_numpy(rng.standard_normal((n, k)).astype(
        np.float32)).to(dev, dtype)
    cols = torch.from_numpy(rng.integers(0, n, (n, k)).astype(
        np.int32)).to(dev)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        dev, dtype)
    before = spmv_k.ell_spmv.launches
    out = ell_matvec(vals, cols, x)
    assert spmv_k.ell_spmv.launches == before + 1
    plain = ell_spmv_plain(vals.T, cols.T, x)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert float((out - plain).abs().max() / plain.abs().max()) <= tol


@pytest.mark.parametrize("n,m,dtype", [
    (128, 64, torch.float32), (1000, 333, torch.float32),
    (4096, 1024, torch.bfloat16)])
def test_pack_kernel_matches_plain(dev, n, m, dtype):
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        dev, dtype)
    idx = rng.integers(0, n, m).astype(np.int32)
    idx[::5] = -1
    idx[1::9] = n + 3
    idx_t = torch.from_numpy(idx).to(dev)
    before = pack_k.pack.launches
    out = pack(x, idx_t)
    assert pack_k.pack.launches == before + 1
    assert torch.equal(out, pack_plain(x, idx_t))


def test_comm_stream_never_aliases_schedule_streams(small_spmv):
    """The executor draws its streams from the normal-priority pool;
    the comm stream comes from the high-priority one, so no runner's
    stream can be the comm stream (which would hide a missing sync)."""
    _, _, spmv = small_spmv
    handles = {torch.cuda.Stream().cuda_stream for _ in range(96)}
    assert spmv.comm.cuda_stream not in handles


def test_distributed_spmv_on_card(small_spmv):
    from repro_torch.spmv.distributed import make_distributed_spmv
    A, x, _ = small_spmv
    y = make_distributed_spmv(partition(A, 4), "cuda")(x)
    ref = A.matvec(x)
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-4


def test_removed_syncs_are_caught_by_the_gate(small_spmv, dev):
    """Pack delayed and CES-b4-PostSend removed; a producer/consumer pair
    on two streams with its CSWE removed: both fail the value gate, and
    both pass intact (chip_smoke.py's race phase)."""
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    import chip_smoke
    _, _, spmv = small_spmv
    checks = chip_smoke.phase_race(spmv, dev)["checks"]
    assert [c["dropped"] for c in checks] == ["CES-b4-PostSend",
                                             "CSWE-b4-C"]
    assert all(c["caught"] for c in checks)
