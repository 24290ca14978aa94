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
from repro_torch.spmv.distributed import DistributedSpmv  # noqa: E402
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


@pytest.mark.parametrize("m,offset,dtype", [
    (1, 0, "float32"), (7, 0, "bfloat16"), (333, 1, "float32"),
    (1001, 3, "float32"), (4099, 3, "bfloat16"), (2050, 2, "float32")])
def test_pack_into_views_matches_jax_kernel(m, offset, dtype):
    """pack at ragged m, from an idx and into an out that are views
    ``offset`` elements into their buffers, with -1 and past-the-end
    indices (the card tests' cases): the JAX kernel's values, nothing
    written before the view."""
    n = 4096
    rng = np.random.default_rng(m + offset)
    x = rng.standard_normal(n).astype(np.float32)
    ids = rng.integers(0, n, m + offset).astype(np.int32)
    ids[offset::5] = -1
    ids[offset + 1::9] = n + 3
    jdt, tdt = DTYPES[dtype]
    jax_out = np.asarray(pack_ops.pack(
        jnp.asarray(x, jdt), jnp.asarray(ids[offset:])).astype(jnp.float32))
    buf = torch.full((m + offset,), float("nan"), dtype=tdt)
    got = tpack.pack(torch.from_numpy(x).to(tdt),
                     torch.from_numpy(ids)[offset:], out=buf[offset:])
    np.testing.assert_array_equal(got.float().numpy(), jax_out)
    assert bool(buf[:offset].isnan().all())


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


# -- the sorted-slice layout (SELL-32-window) ---------------------------------

def _ragged_inputs(n, k, seed=0):
    """Row lengths uniform in 0..K: slots past a row's length hold 0 with
    a valid column (row mod n), as spmv/matrix.py:partition leaves them."""
    rng = np.random.default_rng(seed + n + k)
    length = rng.integers(0, k + 1, size=n)
    live = np.arange(k)[None, :] < length[:, None]
    vals = np.where(live, rng.standard_normal((n, k)), 0.0).astype(
        np.float32)
    cols = np.where(live, rng.integers(0, n, size=(n, k)),
                    np.arange(n)[:, None] % n).astype(np.int32)
    x = rng.standard_normal(n).astype(np.float32)
    return vals, cols, x, length


SLICED_SWEEP = [(300, 1, "float32"), (2500, 7, "float32"),
                (3000, 16, "float32"), (77, 7, "float32"),
                (1100, 7, "bfloat16"), (3000, 16, "bfloat16"),
                (2050, 1, "bfloat16")]


@pytest.mark.parametrize("n,k,dtype", SLICED_SWEEP)
def test_sliced_layout_matches_jax_kernel(n, k, dtype):
    """sliced_operands plus the kernel's plain version against the JAX
    package's ell_matvec (Pallas in interpret mode) and its ref, on
    ragged rows; N is not a multiple of 32 or of the 1,024-row window,
    and spans one to three windows."""
    vals, cols, x, length = _ragged_inputs(n, k)
    jdt, tdt = DTYPES[dtype]
    jax_out = np.asarray(spmv_ops.ell_matvec(
        jnp.asarray(vals, jdt), jnp.asarray(cols), jnp.asarray(x, jdt)))
    ref = np.asarray(spmv_ops.ell_matvec_ref(
        jnp.asarray(vals, jdt).astype(jnp.float32), jnp.asarray(cols),
        jnp.asarray(x, jdt).astype(jnp.float32)))
    s = tspmv.sliced_operands(torch.from_numpy(vals.T.copy()).to(tdt),
                              torch.from_numpy(cols.T.copy()))
    out = torch.full((n,), float("nan"))
    tspmv.ell_matvec_t(s.vals_t, s.cols_t, torch.from_numpy(x).to(tdt),
                       out=out, slice_k=s.slice_k, perm=s.perm)
    scale = np.abs(ref).max() + 1e-6
    assert np.abs(out.numpy() - jax_out).max() / scale < _tol(dtype)
    assert np.abs(out.numpy() - ref).max() / scale < _tol(dtype)
    # Fewer slots read than the padded layout, never fewer than the rows
    # need.
    slots = int(s.slice_k.sum()) * tspmv_k.SLICE_ROWS
    assert length.sum() <= slots <= k * (n + 31) // 32 * 32


@pytest.mark.parametrize("n,k", [(3000, 7), (2500, 16), (77, 1)])
def test_sliced_layout_sorts_inside_windows(n, k):
    """perm keeps each row inside its window and orders it longest first
    (stably); slice_k is each slice's widest row; the sorted arrays are
    the original columns of vals_t/cols_t."""
    vals, cols, _, length = _ragged_inputs(n, k)
    vt, ct = torch.from_numpy(vals.T.copy()), torch.from_numpy(cols.T.copy())
    s = tspmv.sliced_operands(vt, ct)
    window = tspmv.WINDOW
    p = s.perm.long()
    assert s.perm.dtype == s.slice_k.dtype == torch.int32
    tspmv.check_permutation(s.perm, n)
    assert torch.equal(p // window, torch.arange(n) // window)
    assert torch.equal(tspmv.row_lengths(vt), torch.from_numpy(length))
    ls = torch.from_numpy(length)[p]
    for w0 in range(0, n, window):
        seg, ps = ls[w0:w0 + window], p[w0:w0 + window]
        assert bool((seg[:-1] >= seg[1:]).all())
        tie = seg[:-1] == seg[1:]
        assert bool((ps[:-1][tie] < ps[1:][tie]).all())
    rows = tspmv_k.SLICE_ROWS
    want = [int(ls[i:i + rows].max()) for i in range(0, n, rows)]
    assert s.slice_k.tolist() == want
    assert torch.equal(s.vals_t, vt[:, p]) and torch.equal(s.cols_t, ct[:, p])


def test_sliced_plain_reads_no_slot_past_the_slice_width():
    """The plain version computes the kernel's function: slots at or past
    slice_k are not read, so garbage there (NaN values, columns outside
    x) changes nothing; within the width it is the padded product,
    scattered through perm."""
    vals, cols, x, _ = _ragged_inputs(300, 7)
    s = tspmv.sliced_operands(torch.from_numpy(vals.T.copy()),
                              torch.from_numpy(cols.T.copy()))
    tx = torch.from_numpy(x)
    want = tspmv.ell_spmv_plain(torch.from_numpy(vals.T.copy()),
                                torch.from_numpy(cols.T.copy()), tx)
    width = s.slice_k.long().repeat_interleave(tspmv_k.SLICE_ROWS)[:300]
    dead = torch.arange(7)[:, None] >= width
    vt = torch.where(dead, float("nan"), s.vals_t)
    ct = torch.where(dead, 10 ** 6, s.cols_t)
    got = tspmv.ell_matvec_t(vt, ct, tx, slice_k=s.slice_k, perm=s.perm)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", [
    "block_n_48", "block_n_100", "slice_k_length", "slice_k_dtype",
    "perm_length", "perm_dtype", "perm_not_a_permutation",
    "distributed_bad_perm", "shapes"])
def test_sliced_layout_rejects_what_the_kernel_does_not_take(case):
    """The wrapper checks block_n (a multiple of 32: a warp is one slice)
    and the layout's types and lengths before any build or launch, so
    these raise here without a card; a perm that is not a permutation is
    refused at set-up (the wrapper cannot read it without a sync)."""
    vals, cols, x, _ = _ragged_inputs(100, 5)
    s = tspmv.sliced_operands(torch.from_numpy(vals.T.copy()),
                              torch.from_numpy(cols.T.copy()))
    tx, out = torch.from_numpy(x), torch.zeros(100)

    def launch(**kw):
        args = dict(block_n=256, slice_k=s.slice_k, perm=s.perm)
        args.update(kw)
        tspmv_k.ell_spmv(s.vals_t, s.cols_t, tx, out, **args)

    bad_perm = s.perm.clone()
    bad_perm[3] = bad_perm[4]
    expect = {
        "block_n_48": (ValueError, "multiple of 32",
                       lambda: launch(block_n=48)),
        "block_n_100": (ValueError, "multiple of 32",
                        lambda: launch(block_n=100)),
        "slice_k_length": (ValueError, "slice_k",
                           lambda: launch(slice_k=s.slice_k[:-1])),
        "slice_k_dtype": (TypeError, "slice_k",
                          lambda: launch(slice_k=s.slice_k.long())),
        "perm_length": (ValueError, "perm",
                        lambda: launch(perm=s.perm[:-1])),
        "perm_dtype": (TypeError, "perm", lambda: launch(perm=s.perm.float())),
        "perm_not_a_permutation": (
            ValueError, "permutation",
            lambda: tspmv.check_permutation(bad_perm, 100)),
        "distributed_bad_perm": (
            ValueError, "permutation",
            lambda: DistributedSpmv(s._replace(perm=bad_perm), s, tx, 4)),
        "shapes": (ValueError, "one \\(K, N\\) shape",
                   lambda: tspmv.sliced_operands(s.vals_t,
                                                 s.cols_t[:, :-1])),
    }
    exc, match, call = expect[case]
    with pytest.raises(exc, match=match):
        call()
    # The same layout with valid arguments reaches the CUDA check.
    with pytest.raises(ValueError, match="CUDA"):
        launch()


@pytest.mark.parametrize("n,group_rows", [(5000, 1250), (2050, 512),
                                          (3000, 3000)])
def test_deal_blocks_cycles_groups_and_keeps_the_product(n, group_rows):
    """deal_blocks moves whole BLOCK_N-row blocks (rows, slices and perm
    together), so the product is unchanged bit for bit; consecutive full
    blocks cycle through the row groups while every group has blocks
    left; the partial last block stays last."""
    vals, cols, x, _ = _ragged_inputs(n, 7)
    s = tspmv.sliced_operands(torch.from_numpy(vals.T.copy()),
                              torch.from_numpy(cols.T.copy()))
    d = tspmv.deal_blocks(s, group_rows)
    block_n = tspmv.BLOCK_N
    tx = torch.from_numpy(x)
    want = tspmv.ell_matvec_t(*s[:2], tx, slice_k=s.slice_k, perm=s.perm)
    got = tspmv.ell_matvec_t(*d[:2], tx, slice_k=d.slice_k, perm=d.perm)
    assert torch.equal(got, want)
    tspmv.check_permutation(d.perm, n)
    rows = tspmv_k.SLICE_ROWS
    length = tspmv.row_lengths(d.vals_t)
    assert d.slice_k.tolist() == [int(length[i:i + rows].max())
                                  for i in range(0, n, rows)]
    full = n // block_n
    starts = [int(torch.nonzero(s.perm == d.perm[b * block_n])[0])
              for b in range(full)]
    assert all(b0 % block_n == 0 for b0 in starts)
    assert sorted(starts) == [b * block_n for b in range(full)]
    groups = [b0 // group_rows for b0 in starts]
    n_groups = len(set(groups))
    left = {g: groups.count(g) for g in set(groups)}
    for b, g in enumerate(groups):
        if b % n_groups == 0 and min(left.values()) > 0:
            cycle = groups[b:b + n_groups]
            assert sorted(cycle) == sorted(left), (b, cycle)
        left[g] -= 1
    if n % block_n:
        assert torch.equal(d.perm[full * block_n:], s.perm[full * block_n:])

