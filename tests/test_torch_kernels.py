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


# -- the narrow-band (one-hot) SpMV ---------------------------------------------

def _band_inputs(n, k, hb):
    rng = np.random.default_rng(n)
    offs = rng.integers(-hb, hb + 1, size=(n, k))
    cols = ((np.arange(n)[:, None] + offs) % n).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return vals, cols, x


@pytest.mark.parametrize("n,k,hb,block_r", [
    (256, 4, 32, 64), (512, 8, 64, 128), (384, 3, 48, 128)])
def test_ell_matvec_onehot_matches_jax_kernel(n, k, hb, block_r):
    """tests/test_kernels.py:41-58's cases; rtol 2e-5, atol 1e-4 (float32
    sums in the same k order, the gather exact in both)."""
    vals, cols, x = _band_inputs(n, k, hb)
    jax_out = np.asarray(spmv_ops.ell_matvec_onehot(
        jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x),
        half_bandwidth=hb, block_r=block_r))
    out = tspmv.ell_matvec_onehot(torch.from_numpy(vals),
                                  torch.from_numpy(cols),
                                  torch.from_numpy(x), hb, block_r)
    assert out.dtype == torch.float32 and out.shape == (n,)
    np.testing.assert_allclose(out.numpy(), jax_out, rtol=2e-5, atol=1e-4)
    ref = (vals.astype(np.float64) * x.astype(np.float64)[cols]).sum(1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=1e-4)


def test_onehot_agrees_on_paper_matrix():
    """tests/test_kernels.py:61-72: the reduced paper band matrix."""
    A = band_matrix(n=2048, nnz=16384, half_bandwidth=512, seed=7)
    x = np.random.default_rng(1).standard_normal(2048).astype(np.float32)
    y = tspmv.ell_matvec_onehot(torch.from_numpy(A.vals),
                                torch.from_numpy(A.cols),
                                torch.from_numpy(x), 512, 128).numpy()
    np.testing.assert_allclose(y, A.matvec(x), rtol=1e-4, atol=1e-4)
    y_jax = np.asarray(spmv_ops.ell_matvec_onehot(
        jnp.asarray(A.vals), jnp.asarray(A.cols), jnp.asarray(x),
        half_bandwidth=512, block_r=128))
    np.testing.assert_allclose(y, y_jax, rtol=2e-5, atol=1e-4)


def test_onehot_rows_not_a_multiple_of_block_r():
    """n = 300, block_r = 128: the port pads the rows and wrap-pads x far
    enough for the last block's window, and matches the float64 oracle.
    The JAX wrapper slices the last window past the end of its padded x,
    where ``dynamic_slice`` clamps the start, so its last block reads a
    shifted window: a fault of the reference (ROADMAP Queue 3)."""
    n, k, hb, block_r = 300, 5, 40, 128
    vals, cols, x = _band_inputs(n, k, hb)
    ref = (vals.astype(np.float64) * x.astype(np.float64)[cols]).sum(1)
    out = tspmv.ell_matvec_onehot(torch.from_numpy(vals),
                                  torch.from_numpy(cols),
                                  torch.from_numpy(x), hb, block_r)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=1e-4)
    jax_out = np.asarray(spmv_ops.ell_matvec_onehot(
        jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x),
        half_bandwidth=hb, block_r=block_r))
    err = np.abs(jax_out - ref)
    assert err[:256].max() < 1e-4          # the full blocks agree
    assert err[256:].max() > 1e-2          # the clamped last window


def test_onehot_operands_keep_the_window_relative_contract():
    """Columns become slots of each block's window of wrap-padded x; a
    slot outside [0, W) gives 0, as a one-hot row with no match did."""
    n, k, hb, block_r = 256, 3, 16, 64
    vals, cols, x = _band_inputs(n, k, hb)
    tv, tc, tx = (torch.from_numpy(a) for a in (vals, cols, x))
    vt, cwt, xp = tspmv.onehot_operands(tv, tc, tx, hb, block_r)
    window = 2 * hb + block_r
    assert vt.shape == cwt.shape == (k, n) and cwt.dtype == torch.int32
    assert xp.shape == (n + 2 * hb,)
    assert int(cwt.min()) >= 0 and int(cwt.max()) < window
    np.testing.assert_array_equal(xp.numpy(),
                                  x[(np.arange(n + 2 * hb) - hb) % n])
    rows = np.arange(n)
    np.testing.assert_array_equal(
        xp.numpy()[rows // block_r * block_r + cwt.numpy()], x[cols.T])
    y = tspmv.ell_onehot_plain(vt, cwt, xp, window, block_r)
    cut = cwt.clone()
    cut[0, :7] = window                    # outside the window
    cut[1, :5] = -1
    y_cut = tspmv.ell_onehot_plain(vt, cut, xp, window, block_r)
    drop = np.zeros(n)
    drop[:7] += vals[:7, 0] * x[cols[:7, 0]]
    drop[:5] += vals[:5, 1] * x[cols[:5, 1]]
    np.testing.assert_allclose((y - y_cut).numpy(), drop, rtol=1e-5,
                               atol=1e-5)


def test_onehot_wrapper_rejects_what_the_kernel_does_not_take():
    vt = torch.zeros(2, 256)
    ct = torch.zeros(2, 256, dtype=torch.int32)
    xp = torch.zeros(512)
    out = torch.zeros(256)
    with pytest.raises(ValueError, match="CUDA"):
        tspmv_k.ell_onehot(vt, ct, xp, out, 300, 128)
    with pytest.raises(ValueError, match="shared memory"):
        tspmv_k.ell_onehot(vt, ct, torch.zeros(70000), out, 60000, 128)
    with pytest.raises(ValueError, match="multiple"):
        tspmv_k.ell_onehot(vt, ct, xp, out, 300, 96)
    with pytest.raises(TypeError):
        tspmv_k.ell_onehot(vt.bfloat16(), ct, xp, out, 300, 128)
    with pytest.raises(ValueError, match="threads"):
        tspmv_k.ell_onehot(vt, ct, xp, out, 300, 2048)
    o0 = tspmv_k.ell_onehot.launches
    tspmv.ell_matvec_onehot(torch.zeros(64, 2), torch.zeros(
        64, 2, dtype=torch.int32), torch.zeros(64), 8, 32)
    assert tspmv_k.ell_onehot.launches == o0   # the CPU path never launches


def test_block_arguments_reach_the_wrappers():
    """block_n / block_c are the autotune grids' launch arguments: the
    CPU path ignores them, the kernel wrappers check them."""
    vals, cols, x = _ell_inputs(300, 7)
    tv, tc, tx = (torch.from_numpy(a) for a in (vals, cols, x))
    base = tspmv.ell_matvec(tv, tc, tx)
    for bn in (64, 512):
        assert torch.equal(tspmv.ell_matvec(tv, tc, tx, block_n=bn), base)
    idx = torch.arange(0, 300, 7, dtype=torch.int32)
    assert torch.equal(tpack.pack(tx, idx, block_c=64), tx[idx.long()])
    with pytest.raises(ValueError, match="threads"):
        tspmv_k.ell_spmv(tv.T.contiguous(), tc.T.contiguous(), tx,
                         torch.zeros(300), block_n=0)
    with pytest.raises(ValueError, match="threads"):
        tpack_k.pack(tx, idx, torch.zeros(idx.shape), block_c=4096)
