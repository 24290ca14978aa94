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


# -- flash attention and the narrow-band SpMV -----------------------------------

ATTN_CASES = [((2, 3, 256, 64), (2, 3, 256, 64), torch.float32, True),
              ((1, 2, 300, 64), (1, 2, 300, 64), torch.float32, True),
              ((2, 2, 256, 128), (2, 2, 256, 128), torch.bfloat16, True),
              ((1, 2, 64, 48), (1, 2, 64, 48), torch.float32, True),
              ((1, 2, 128, 64), (1, 2, 256, 64), torch.float32, False),
              ((1, 1, 128, 64), (1, 1, 384, 64), torch.float32, True)]


@pytest.mark.parametrize("q_shape,kv_shape,dtype,causal", ATTN_CASES)
def test_flash_attention_kernel_matches_plain(dev, q_shape, kv_shape,
                                              dtype, causal):
    """tests/test_kernels.py:118-156's cases: the kernel behind mha's
    padding against the plain version behind the same padding (the CPU
    path); f32 2e-5, bf16 3e-2 (bf16 outputs)."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ops import mha
    rng = np.random.default_rng(sum(q_shape))
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in (q_shape, kv_shape, kv_shape)]
    before = fa_k.flash_attention.launches
    out = mha(*(torch.from_numpy(a).to(dev, dtype) for a in arrays),
              causal=causal)
    torch.cuda.synchronize()
    assert fa_k.flash_attention.launches == before + 1
    plain = mha(*(torch.from_numpy(a).to(dtype) for a in arrays),
                causal=causal)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    assert float((out.float().cpu() - plain.float()).abs().max()) <= tol


def test_flash_attention_every_grid_block_pair_launches(dev):
    """Every (block_q, block_k) of the autotune grid launches at D = 128
    in float32 and computes the plain version's values."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ops import attention_plain
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(2, 256, 128, device=dev, generator=g)
               for _ in range(3))
    plain = attention_plain(q, k, v, causal=True, scale=128 ** -0.5)
    for bq in (16, 32, 64, 128):
        for bk in (16, 32, 64, 128):
            out = fa_k.flash_attention(q, k, v, torch.empty_like(q),
                                       causal=True, block_q=bq, block_k=bk,
                                       scale=128 ** -0.5)
            torch.cuda.synchronize()
            assert float((out - plain).abs().max()) <= 2e-5, (bq, bk)


@pytest.mark.parametrize("n,k,hb,block_r", [
    (256, 4, 32, 64), (512, 8, 64, 128), (384, 3, 48, 128),
    (300, 5, 40, 128)])
def test_ell_onehot_kernel_matches_plain(dev, n, k, hb, block_r):
    from repro_torch.kernels.spmv.ops import ell_matvec_onehot
    rng = np.random.default_rng(n)
    offs = rng.integers(-hb, hb + 1, size=(n, k))
    cols = ((np.arange(n)[:, None] + offs) % n).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    before = spmv_k.ell_onehot.launches
    out = ell_matvec_onehot(*(torch.from_numpy(a).to(dev)
                              for a in (vals, cols, x)), hb, block_r)
    torch.cuda.synchronize()
    assert spmv_k.ell_onehot.launches == before + 1
    plain = ell_matvec_onehot(*(torch.from_numpy(a)
                                for a in (vals, cols, x)), hb, block_r)
    torch.testing.assert_close(out.cpu(), plain, rtol=1e-5, atol=1e-5)


def test_a_refused_launch_raises(dev):
    """The C side refuses a head dim it was not built for; the wrapper
    turns the returned CUDA error into an exception, nothing is hidden."""
    from repro_torch.kernels import build
    fn = build.declare(build.library("flash_attention"),
                       "flash_attention_f32", 4, 7, 1)
    x = torch.zeros(1, 128, 96, device=dev)
    err = fn(x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(), 1,
             128, 128, 96, 128, 128, 1, 0.1,
             torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check(err, "flash_attention")
