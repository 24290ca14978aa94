"""The port's kernel entry points (CPU path) against the JAX package's
Pallas kernels in interpret mode, on the reference sweep's inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.pack import ops as pack_ops  # noqa: E402
from repro.kernels.spmv import ops as spmv_ops  # noqa: E402
from repro.spmv.matrix import band_matrix as jax_band_matrix  # noqa: E402
from repro_torch.kernels.pack import kernel as tpack_k  # noqa: E402
from repro_torch.kernels.pack import ops as tpack  # noqa: E402
from repro_torch.kernels.spmv import kernel as tspmv_k  # noqa: E402
from repro_torch.kernels.spmv import ops as tspmv  # noqa: E402
from repro_torch.spmv.matrix import band_matrix  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str) -> float:
    # bf16 inputs: the two frameworks round the inputs identically but
    # sum in different orders; f32: summation order only.
    return 2e-2 if dtype == "bfloat16" else 1e-5


def _ell_inputs(n, k):
    rng = np.random.default_rng(n + k)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    cols = rng.integers(0, n, size=(n, k)).astype(np.int32)
    x = rng.standard_normal(n).astype(np.float32)
    return vals, cols, x


SWEEP = [(64, 1, "float32"), (300, 7, "float32"), (512, 8, "float32"),
         (1024, 16, "bfloat16"), (2048, 5, "bfloat16")]


@pytest.mark.parametrize("n,k,dtype", SWEEP)
def test_ell_matvec_matches_jax_kernel(n, k, dtype):
    vals, cols, x = _ell_inputs(n, k)
    jdt, tdt = DTYPES[dtype]
    jax_out = np.asarray(spmv_ops.ell_matvec(
        jnp.asarray(vals, jdt), jnp.asarray(cols), jnp.asarray(x, jdt)))
    ref = np.asarray(spmv_ops.ell_matvec_ref(
        jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x)))
    out = tspmv.ell_matvec(torch.from_numpy(vals).to(tdt),
                           torch.from_numpy(cols),
                           torch.from_numpy(x).to(tdt))
    assert out.dtype == torch.float32 and out.shape == (n,)
    scale = np.abs(ref).max() + 1e-6
    assert np.abs(out.numpy() - jax_out).max() / scale < _tol(dtype)
    assert np.abs(out.numpy() - ref).max() / scale < _tol(dtype)


@pytest.mark.parametrize("n,k,dtype", SWEEP)
def test_ell_matvec_t_into_preallocated_out(n, k, dtype):
    vals, cols, x = _ell_inputs(n, k)
    _, tdt = DTYPES[dtype]
    vt = torch.from_numpy(vals.T.copy()).to(tdt)
    ct = torch.from_numpy(cols.T.copy())
    out = torch.full((n,), float("nan"))
    got = tspmv.ell_matvec_t(vt, ct, torch.from_numpy(x).to(tdt), out=out)
    assert got is out
    ref = tspmv.ell_matvec_ref(torch.from_numpy(vals).to(tdt).float(),
                               torch.from_numpy(cols),
                               torch.from_numpy(x).to(tdt).float())
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_ell_matvec_ref_matches_jax_ref():
    vals, cols, x = _ell_inputs(300, 7)
    ref = np.asarray(spmv_ops.ell_matvec_ref(
        jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x)))
    got = tspmv.ell_matvec_ref(torch.from_numpy(vals),
                               torch.from_numpy(cols), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_paper_matrix_generator_identical_and_matvec():
    """Reduced paper band matrix: the copied generator gives the same
    arrays, and the port's SpMV agrees with the f64 oracle and the
    JAX kernel."""
    A = band_matrix(n=2048, nnz=16384, half_bandwidth=512, seed=7)
    B = jax_band_matrix(n=2048, nnz=16384, half_bandwidth=512, seed=7)
    np.testing.assert_array_equal(A.vals, B.vals)
    np.testing.assert_array_equal(A.cols, B.cols)
    x = np.random.default_rng(1).standard_normal(2048).astype(np.float32)
    y = tspmv.ell_matvec(torch.from_numpy(A.vals), torch.from_numpy(A.cols),
                         torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, A.matvec(x), rtol=1e-4, atol=1e-4)
    y_jax = np.asarray(spmv_ops.ell_matvec(
        jnp.asarray(B.vals), jnp.asarray(B.cols), jnp.asarray(x)))
    np.testing.assert_allclose(y, y_jax, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,m,dtype,pad", [
    (128, 64, "float32", False), (1000, 333, "float32", False),
    (4096, 1024, "float32", False), (1000, 333, "float32", True),
    (4096, 1024, "bfloat16", True)])
def test_pack_matches_jax_kernel(n, m, dtype, pad):
    rng = np.random.default_rng(m)
    x = rng.standard_normal(n).astype(np.float32)
    idx = rng.integers(0, n, size=m).astype(np.int32)
    if pad:  # the JAX kernel's -1 padding: those slots give 0
        idx[::7] = -1
    jdt, tdt = DTYPES[dtype]
    jax_out = np.asarray(pack_ops.pack(jnp.asarray(x, jdt),
                                       jnp.asarray(idx)).astype(jnp.float32))
    out = tpack.pack(torch.from_numpy(x).to(tdt), torch.from_numpy(idx))
    assert out.dtype == tdt
    np.testing.assert_array_equal(out.float().numpy(), jax_out)
    if not pad:
        np.testing.assert_array_equal(
            out.float().numpy(),
            tpack.pack_ref(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(idx)).float().numpy())


def test_pack_out_of_range_gives_zero_and_fills_out():
    x = torch.arange(1.0, 11.0)
    idx = torch.tensor([0, 9, -1, 10, 3], dtype=torch.int32)
    out = torch.full((5,), float("nan"))
    got = tpack.pack(x, idx, out=out)
    assert got is out
    assert out.tolist() == [1.0, 10.0, 0.0, 0.0, 4.0]


def test_cpu_path_never_counts_a_launch():
    s0, p0 = tspmv_k.ell_spmv.launches, tpack_k.pack.launches
    vals, cols, x = _ell_inputs(64, 3)
    tspmv.ell_matvec(torch.from_numpy(vals), torch.from_numpy(cols),
                     torch.from_numpy(x))
    tpack.pack(torch.from_numpy(x), torch.arange(8, dtype=torch.int32))
    assert (tspmv_k.ell_spmv.launches, tpack_k.pack.launches) == (s0, p0)


@pytest.mark.parametrize("case", ["cpu_tensors", "dtype", "shape"])
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(case):
    """The launch wrappers check their arguments before any build or
    launch, so these raise here without a card."""
    vt = torch.zeros(3, 8)
    ct = torch.zeros(3, 8, dtype=torch.int32)
    x, out = torch.zeros(8), torch.zeros(8)
    idx = torch.zeros(4, dtype=torch.int32)
    if case == "cpu_tensors":
        with pytest.raises(ValueError, match="CUDA"):
            tspmv_k.ell_spmv(vt, ct, x, out)
        with pytest.raises(ValueError, match="CUDA"):
            tpack_k.pack(x, idx, torch.zeros(4))
    elif case == "dtype":
        with pytest.raises(TypeError):
            tspmv_k.ell_spmv(vt.double(), ct, x.double(), out)
        with pytest.raises(TypeError):
            tspmv_k.ell_spmv(vt, ct.long(), x, out)
        with pytest.raises(TypeError):
            tpack_k.pack(x, idx.long(), torch.zeros(4))
    else:
        with pytest.raises(ValueError):
            tspmv_k.ell_spmv(vt, ct[:2], x, out)
        with pytest.raises(ValueError):
            tspmv_k.ell_spmv(vt, ct, x, torch.zeros(7))
        with pytest.raises(ValueError):
            tpack_k.pack(x, idx, torch.zeros(5))
