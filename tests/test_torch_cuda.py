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


@pytest.mark.parametrize("n,k,dtype", [
    (64, 1, torch.float32), (300, 7, torch.float32),
    (512, 8, torch.float32), (1024, 16, torch.bfloat16),
    (2500, 5, torch.bfloat16)])
@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_ell_spmv_slices_match_plain(dev, n, k, dtype, layout):
    """The warp-per-slice kernel on ragged rows, with every row read to K
    or in sorted slices (slice_k and perm), at block_n 32, 96 and 256,
    against its plain version; the sliced result is the padded one bit
    for bit (the skipped slots hold 0, the sum order is kept)."""
    from repro_torch.kernels.spmv.ops import ell_matvec_t, sliced_operands
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    from chip_smoke import ragged_ell
    vals, cols, x = ragged_ell(n, k, np.random.default_rng(n + k))
    vt = torch.from_numpy(vals.T.copy()).to(dev, dtype)
    ct = torch.from_numpy(cols.T.copy()).to(dev)
    xt = torch.from_numpy(x).to(dev, dtype)
    padded = ell_matvec_t(vt, ct, xt)
    if layout == "sliced":
        s = sliced_operands(vt, ct)
        args, kw = (s.vals_t, s.cols_t, xt), {"slice_k": s.slice_k,
                                              "perm": s.perm}
    else:
        args, kw = (vt, ct, xt), {}
    plain = ell_spmv_plain(*args, **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for block_n in (32, 96, 256):
        before = spmv_k.ell_spmv.launches
        out = torch.full((n,), float("nan"), device=dev)
        ell_matvec_t(*args, out=out, block_n=block_n, **kw)
        torch.cuda.synchronize()
        assert spmv_k.ell_spmv.launches == before + 1
        assert bool(torch.isfinite(out).all())
        assert float((out - plain).abs().max() /
                     plain.abs().max()) <= tol
        assert torch.equal(out, padded)


@pytest.mark.parametrize("m,offset,dtype,block_c", [
    (1, 0, torch.float32, 256), (7, 0, torch.bfloat16, 256),
    (333, 1, torch.float32, 256), (1001, 0, torch.float32, 100),
    (4099, 3, torch.bfloat16, 128), (4099, 0, torch.bfloat16, 64),
    (150_001, 2, torch.float32, 256), (150_000, 0, torch.float32, 256)])
def test_pack_kernel_ragged_and_misaligned(dev, m, offset, dtype, block_c):
    """Pack at ragged m (not a multiple of 4 or 8, nor of block_c), into
    an out and from an idx that are views ``offset`` elements into their
    buffers (off 16-byte alignment), at block_c not a power of two, with
    -1 and past-the-end padding: the bits of pack_plain, nothing written
    before the view."""
    rng = np.random.default_rng(m + offset)
    n = 4096
    xs = rng.standard_normal(n).astype(np.float32)
    xs[5] = -0.0
    x = torch.from_numpy(xs).to(dev, dtype)
    ids = rng.integers(0, n, m + offset).astype(np.int32)
    ids[offset::5] = -1
    ids[offset + 1::9] = n + 3
    idx = torch.from_numpy(ids).to(dev)[offset:]
    buf = torch.full((m + offset,), float("nan"), dtype=dtype, device=dev)
    before = pack_k.pack.launches
    got = pack(x, idx, out=buf[offset:], block_c=block_c)
    torch.cuda.synchronize()
    assert pack_k.pack.launches == before + 1
    words = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(words), pack_plain(x, idx).view(words))
    assert bool(buf[:offset].isnan().all())


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


# -- the paper's measurement protocol and the runner's owned events ------------

def test_measure_cuda_times_a_device_sleep(dev):
    """measure_cuda of a ~25 ms device sleep returns within 20% of the
    sleep's CUDA-event time: the window waits for the device work its
    samples enqueued."""
    from repro_torch.core.bench import measure_cuda
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    from chip_smoke import SLEEP_CYCLES

    def sleep():
        torch.cuda._sleep(SLEEP_CYCLES)

    sleep()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    sleep()
    end.record()
    end.synchronize()
    slept_s = start.elapsed_time(end) * 1e-3
    assert 0.01 < slept_s < 0.1
    got = measure_cuda(sleep, dev, t_measure_s=0.1)
    assert abs(got - slept_s) <= 0.2 * slept_s


def test_paper_protocol_gates_and_times_a_schedule(dev):
    """ExecutorEvaluator(t_measure_s=...) at n = 2,048: the gate runs,
    then repeats windows are timed; the key names the protocol."""
    import repro_torch.core as C
    from repro_torch.engine import ExecutorEvaluator
    A = band_matrix(n=2048, nnz=16384, seed=5)
    x = np.random.default_rng(6).standard_normal(2048).astype(np.float32)
    spmv = from_reference(stack_partitions(partition(A, 4)), x, dev)
    g = C.spmv_dag()
    ev = ExecutorEvaluator(g, impls=spmv.impls(), env=spmv.env(),
                           reset=spmv.poison, repeats=3, t_measure_s=0.005,
                           device=dev, store_tag=spmv.store_tag)
    sched = next(iter(C.enumerate_schedules(g, 2)))
    before = spmv_k.ell_spmv.launches
    (t,) = ev.evaluate([sched])
    assert ev.n_checked == 1 and 0.0 < t < 0.005
    # 3 windows of >= 5 ms of runs, two products a run: many launches.
    assert spmv_k.ell_spmv.launches - before > 2 * 3 * 2
    assert ":t_measure=0.005:" in ev.objective_key()


def test_owned_events_survive_back_to_back_runs(small_spmv):
    """The runner records its own events again on every run: 100 runs of
    a two-stream schedule back to back leave yL and yR as the first
    run's, bit for bit."""
    import repro_torch.core as C
    from repro_torch.core.executor import build_runner
    _, _, spmv = small_spmv
    g = C.spmv_dag()
    sched = next(s for s in C.enumerate_schedules(g, 2)
                 if len({i.stream for i in s.items} - {None}) == 2)
    run = build_runner(g, sched, spmv.impls(), "cuda")
    spmv.poison()
    first = {k: v.clone() for k, v in run(spmv.env()).items()
             if k in ("yL", "yR")}
    torch.cuda.synchronize()
    for _ in range(100):
        out = run(spmv.env())
    torch.cuda.synchronize()
    for k, v in first.items():
        assert bool(torch.isfinite(v).all())
        assert torch.equal(out[k], v), k


def _driver_on_card(spmv, dev, sinks, budget, sim_budget):
    import repro_torch.core as C
    from repro_torch import obs
    from repro_torch.driver import SearchDriver
    from repro_torch.engine import ExecutorEvaluator
    from repro_torch.search import SurrogateGuided
    g = C.spmv_dag()
    ev = ExecutorEvaluator(g, impls=spmv.impls(), env=spmv.env(),
                           reset=spmv.poison, repeats=5, warmup=2,
                           device=dev, store_tag=spmv.store_tag)
    strat = SurrogateGuided(g, 2, seed=0, warmup=16, surrogate="boost",
                            surrogate_kwargs={"n_estimators": 20})
    tel = obs.Telemetry()
    with obs.use(tel):
        res = SearchDriver(g, strat, ev, budget=budget, batch_size=4,
                           sim_budget=sim_budget,
                           acquisition="expected_improvement",
                           sinks=sinks).run()
    return ev, strat, tel, res


def test_driver_over_measured_schedules(small_spmv, dev):
    """The search driver at n = 4,096 on the card: a boosted surrogate
    screened by expected improvement, every measured schedule gated,
    the kernels launched, and the spans of every layer recorded."""
    _, _, spmv = small_spmv
    before = spmv_k.ell_spmv.launches, pack_k.pack.launches
    ev, strat, tel, res = _driver_on_card(spmv, dev, ["telemetry"],
                                          None, 40)
    assert 40 <= res.cache_misses == ev.n_checked <= 43
    assert spmv_k.ell_spmv.launches > before[0]
    assert pack_k.pack.launches > before[1]
    assert all(np.isfinite(t) and t > 0.0 for t in res.times)
    spans = tel.spans_by_name()
    assert {"driver.run", "driver.round", "driver.propose",
            "driver.evaluate", "driver.observe", "engine.batch",
            "engine.measure"} <= set(spans)
    assert spans["driver.acquire"]["count"] > 0 and strat.n_screened > 0
    assert spans["engine.measure"]["total_s"] <= \
        spans["driver.evaluate"]["total_s"]
    assert tel.counters()["sink.consumed"] == res.n_proposed


def test_histogram_distill_equals_dense_on_measured_times(small_spmv, dev):
    """The out-of-core distill of the measured corpus is the dense one:
    the same features, tree, rules and error."""
    from repro_torch.driver import DatasetSink, HistogramSink
    import repro_torch.core as C
    _, _, spmv = small_spmv
    g = C.spmv_dag()
    ds, hs = DatasetSink(g), HistogramSink(g, block_rows=50)
    _, _, _, res = _driver_on_card(spmv, dev, [ds, hs], 120, None)
    assert hs.times == ds.times == res.times
    dense, ooc = ds.distill(), hs.distill()
    assert hs.feature_list() == ds.matrix().features
    assert dense.render() == ooc.render()
    assert dense.training_error == ooc.training_error
    assert [(r.class_label, r.rules, r.n_samples) for r in dense.rulesets] \
        == [(r.class_label, r.rules, r.n_samples) for r in ooc.rulesets]


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


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_every_grid_block_pair_launches(dev, d):
    """Every (block_q, block_k) of the autotune grid launches at both
    head dims in float32 and computes the plain version's values."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ops import attention_plain
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(2, 256, d, device=dev, generator=g)
               for _ in range(3))
    plain = attention_plain(q, k, v, causal=True, scale=d ** -0.5)
    for bq in (16, 32, 64, 128):
        for bk in (16, 32, 64, 128):
            out = fa_k.flash_attention(q, k, v, torch.empty_like(q),
                                       causal=True, block_q=bq, block_k=bk,
                                       scale=d ** -0.5)
            torch.cuda.synchronize()
            assert float((out - plain).abs().max()) <= 2e-5, (bq, bk)


@pytest.mark.parametrize("sq,skv,bq,bk,d", [(96, 384, 32, 128, 128),
                                            (192, 256, 64, 128, 64),
                                            (48, 192, 16, 64, 128)])
def test_flash_attention_causal_more_keys_than_queries(dev, sq, skv, bq,
                                                       bk, d):
    """Right-aligned causal masking straight through the kernel, with
    Skv > Sq: query i sees keys j <= i + Skv - Sq, so the diagonal
    crosses tiles at an offset that is not a multiple of the blocks."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ops import attention_plain
    rng = np.random.default_rng(sq + skv)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n, d)).astype(
        np.float32)).to(dev) for n in (sq, skv, skv))
    out = fa_k.flash_attention(q, k, v, torch.empty_like(q), causal=True,
                               block_q=bq, block_k=bk, scale=d ** -0.5)
    torch.cuda.synchronize()
    plain = attention_plain(q, k, v, causal=True, scale=d ** -0.5)
    assert float((out - plain).abs().max()) <= 2e-5


@pytest.mark.parametrize("n,k,hb,block_r", [
    (256, 4, 32, 64), (512, 8, 64, 128), (384, 3, 48, 128),
    (300, 5, 40, 128)] + [
    # K = 1..16 are template instances and 17 the runtime loop; an odd hb
    # leaves a window that is not a multiple of 16 bytes (its tail words
    # come by plain loads), and block_r = 33 starts windows at every
    # offset from a 16-byte boundary (head words too).
    (2148, k, 37, block_r) for k in (1, 10, 16, 17)
    for block_r in (32, 128, 1024, 33)])
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


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_ell_onehot_out_of_window_slot_adds_nothing_next_to_inf(dev, shift):
    """Columns just outside the window, where Inf lies on both sides of
    it and at its first and last word, add exactly nothing: a kernel
    that read them, or clamped them and multiplied by 0, gives Inf or
    NaN. ``shift`` floats into its buffer, x_pad starts at every offset
    from a 16-byte boundary."""
    from repro_torch.kernels.spmv.kernel import ell_onehot
    from repro_torch.kernels.spmv.ops import ell_onehot_plain
    k, block_r, window = 10, 128, 2 * 37 + 128
    rng = np.random.default_rng(shift)
    cols = rng.integers(1, window - 1, size=(k, block_r)).astype(np.int32)
    cols[1, ::3] = -1
    cols[2, ::5] = window
    cols[3, ::7] = -4
    cols[4, ::11] = window + 3
    vals = rng.standard_normal((k, block_r)).astype(np.float32)
    buf = np.full(window + 16, np.inf, np.float32)
    x_pad = buf[4 + shift:4 + shift + window]
    x_pad[1:-1] = rng.standard_normal(window - 2)
    vt, ct = torch.from_numpy(vals).to(dev), torch.from_numpy(cols).to(dev)
    xp = torch.from_numpy(buf).to(dev)[4 + shift:4 + shift + window]
    assert xp.data_ptr() % 16 == 4 * shift % 16
    out = torch.full((block_r,), float("nan"), device=dev)
    ell_onehot(vt, ct, xp, out, window, block_r)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    plain = ell_onehot_plain(vt.cpu(), ct.cpu(), torch.from_numpy(x_pad),
                             window, block_r)
    torch.testing.assert_close(out.cpu(), plain, rtol=1e-5, atol=1e-5)


def test_ell_onehot_paper_band_is_the_k_order_fma_sum(dev):
    """At the paper's n and nnz on a band of half-width 512 (K = 10,
    W = 1,280, 586 CTAs), y against the float32 sum in k order of each
    slot's fused multiply-add, the arithmetic of the kernel. The
    reference rounds each FMA through float64 (the product is exact
    there, the sum rounded twice), so it may differ from the card's
    single rounding in a last bit: held within 1e-6 of max |y|, with
    the count of equal entries in the message."""
    from repro_torch.kernels.spmv.kernel import ell_onehot
    from repro_torch.kernels.spmv.ops import onehot_operands
    hb, block_r, n = 512, 256, 150_000
    A = band_matrix(n=n, nnz=1_500_000, half_bandwidth=hb, seed=0)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    vt, cwt, xp = onehot_operands(torch.from_numpy(A.vals),
                                  torch.from_numpy(A.cols),
                                  torch.from_numpy(x), hb, block_r)
    window = 2 * hb + block_r
    assert vt.shape == (10, 150_016)
    out = torch.empty(vt.shape[1], device=dev)
    ell_onehot(vt.to(dev), cwt.to(dev), xp.to(dev), out, window, block_r)
    torch.cuda.synchronize()
    v, c, xpn = vt.numpy(), cwt.numpy().astype(np.int64), xp.numpy()
    start = np.arange(v.shape[1]) // block_r * block_r
    acc = np.zeros(v.shape[1], np.float32)
    for k in range(v.shape[0]):
        valid = (c[k] >= 0) & (c[k] < window)
        g = xpn[start + np.clip(c[k], 0, window - 1)].astype(np.float64)
        fma = (acc.astype(np.float64) + v[k].astype(np.float64) * g
               ).astype(np.float32)
        acc = np.where(valid, fma, acc)
    got = out.cpu().numpy()
    equal = int((got.view(np.int32) == acc.view(np.int32)).sum())
    rel = float(np.abs(got - acc).max() / np.abs(acc).max())
    assert rel <= 1e-6, f"rel {rel}, {equal} of {acc.size} equal"


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


# -- the dense serving path ------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 3e-2)])
def test_lm_prefill_kernel_route_matches_plain(dev, dtype, tol):
    """The reduced qwen config on the card: prefill through the flash
    kernel (one launch per layer) against the plain streaming route on
    the same weights; the logits within tol x max |plain logit|, the
    decode steps within the same of the kernel route's forward."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.models.model import LM
    cfg = dataclasses.replace(get_reduced("qwen2.5-32b"), dtype=dtype)
    m = LM(cfg, device=dev, seed=0)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 100))).to(dev)
    before = fa_k.flash_attention.launches
    flash, caches = m.prefill(tok[:, :97], 104)
    torch.cuda.synchronize()
    assert fa_k.flash_attention.launches == before + cfg.n_layers
    plain, _ = m.prefill(tok[:, :97], 104, attention="plain")
    assert fa_k.flash_attention.launches == before + cfg.n_layers
    assert bool(torch.isfinite(flash).all())
    scale = float(plain.float().abs().max())
    assert float((flash.float() - plain.float()).abs().max()) <= tol * scale
    with torch.inference_mode():
        fwd = m(tok)
    for i in range(97, 100):
        step, caches = m.decode_step(tok[:, i:i + 1], i, caches)
        err = float((step[:, 0].float() - fwd[:, i].float()).abs().max())
        assert err <= tol * float(fwd[:, i].float().abs().max())


def test_generate_on_card_gives_the_cpu_tokens(dev):
    """Greedy tokens of the reduced granite config in float32 on the card
    equal those of the same weights on the CPU."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import Engine
    cfg = dataclasses.replace(get_reduced("granite-3-8b"), dtype="float32")
    on_card = LM(cfg, device=dev, seed=2)
    on_cpu = LM(cfg, device="cpu", seed=3)
    on_cpu.load_state_dict({k: v.cpu()
                            for k, v in on_card.state_dict().items()})
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (3, 40))
    got = Engine(on_card, t_max=56).generate(
        torch.from_numpy(prompts).to(dev), 12)
    want = Engine(on_cpu, t_max=56).generate(torch.from_numpy(prompts), 12)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "rwkv6-3b",
                                  "jamba-v0.1-52b", "whisper-tiny",
                                  "internvl2-2b"])
def test_generate_on_card_gives_the_cpu_tokens_for_every_family(dev, arch):
    """Greedy tokens of each non-dense family's reduced config in
    float32 on the card (flash prefill where attention is causal, the
    Mamba and RWKV recurrences, MoE dispatch, the encoder and the VLM
    prefix) equal those of the same weights and frontend on the CPU."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import Engine
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    on_card = LM(cfg, device=dev, seed=2)
    on_cpu = LM(cfg, device="cpu", seed=3)
    on_cpu.load_state_dict({k: v.cpu()
                            for k, v in on_card.state_dict().items()})
    rng = np.random.default_rng(4)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 40)))
    front = None
    if cfg.frontend is not None:
        front = torch.from_numpy(rng.standard_normal(
            (3, cfg.frontend.n_positions, cfg.frontend.d_frontend)).astype(
            np.float32))
    t_max = on_cpu.n_front + 56
    got = Engine(on_card, t_max=t_max).generate(
        prompts.to(dev), 12, frontend=None if front is None else front.to(dev))
    want = Engine(on_cpu, t_max=t_max).generate(prompts, 12, frontend=front)
    assert torch.equal(got.cpu(), want)


def test_mha_refuses_a_cuda_operand_that_needs_grad(dev):
    """The kernel has no backward: under grad it raises, naming the
    plain route, instead of returning an output without a grad_fn."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ops import mha
    q = torch.randn(1, 2, 128, 64, device=dev, requires_grad=True)
    before = fa_k.flash_attention.launches
    with pytest.raises(RuntimeError, match="plain"):
        mha(q, q.detach(), q.detach())
    assert fa_k.flash_attention.launches == before
    with torch.no_grad():
        out = mha(q, q, q)
    assert fa_k.flash_attention.launches == before + 1
    assert out.grad_fn is None and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "moonshot-v1-16b-a3b",
                                  "deepseek-moe-16b", "jamba-v0.1-52b",
                                  "rwkv6-3b", "whisper-tiny",
                                  "internvl2-2b"])
def test_lm_loss_gradients_on_card_equal_the_cpu(dev, arch):
    """A reduced config on the card and on the CPU with one set of
    weights. qwen2.5-32b in bf16 activations (4 x 64 tokens): loss
    within 2e-2 relative, each gradient within 0.3 of its norm (the
    bf16 bound of tests/test_torch_train.py). The non-dense families in
    f32 activations at 4 x 96 tokens, so that Mamba runs three
    checkpointed chunks and RWKV three blocks (rwkv_chunk=32), with
    whisper's and internvl2's frontends: loss within 1e-5 relative, each
    gradient within 1e-3 of its max |g| (the f32 bound of
    tests/test_torch_train_families.py). The flash route refuses a
    backward."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.models.model import LM
    cfg = get_reduced(arch)
    dense = cfg.family == "dense"
    if not dense:
        cfg = dataclasses.replace(cfg, dtype="float32")
    cpu = LM(cfg, device="cpu", seed=0)
    card = LM(cfg, device=dev, seed=1)
    card.load_state_dict(cpu.state_dict())
    batch = batch_for(DataConfig(seq_len=64 if dense else 96,
                                 global_batch=4, vocab=cfg.vocab), 0, cfg)
    chunk = 32 if cfg.family == "ssm" else None
    out = []
    for m in (cpu, card):
        m.requires_grad_(True)
        loss, _ = m.loss(batch, attention="plain", rwkv_chunk=chunk)
        out.append((float(loss.detach()), torch.autograd.grad(
            loss, list(m.parameters()))))
    tol = 2e-2 if dense else 1e-5
    assert abs(out[1][0] - out[0][0]) <= tol * abs(out[0][0])
    for name, g_cpu, g_card in zip(dict(cpu.named_parameters()),
                                   out[0][1], out[1][1]):
        g_cpu, g_card = g_cpu.float(), g_card.cpu().float()
        if dense:
            err = float((g_card - g_cpu).norm())
            assert err <= 0.3 * float(g_cpu.norm()), name
        else:
            err = float((g_card - g_cpu).abs().max())
            assert err <= 1e-3 * float(g_cpu.abs().max()), (name, err)
    if any(d.kind == "attn" and d.causal for d in card.descs):
        with pytest.raises(RuntimeError, match="no backward"):
            card.loss(batch, rwkv_chunk=chunk)


def test_mamba_backward_holds_the_state_once_a_chunk(dev):
    """jamba-v0.1-52b's Mamba mixer at full width (d_inner 8,192, N 16),
    1 x 1,024 tokens in bf16 under a layer checkpoint: the chunked loop
    (8 checkpointed chunks of 128) stays within the bound chip_smoke.py
    derives (12 f32 (B, S, d_inner) tensors, the chunks' states and one
    chunk's steps), the flat loop exceeds it (4 (B, d_inner, N) f32
    tensors a step), and both give the same gradients."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.configs import get_config
    from repro_torch.models import mamba
    from repro_torch.models import params as prm
    cfg = get_config("jamba-v0.1-52b")
    specs = mamba.mamba_specs(cfg)
    p = prm.Params(specs, device=dev, dtype=torch.float32)
    prm.init(p, specs, torch.Generator(device=dev).manual_seed(0))
    p.requires_grad_(True)
    b, s = 1, 1024
    di, n = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    w = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)

    def run():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        y = checkpoint(lambda t: mamba.mamba_forward(p, t, cfg)[0], x,
                       use_reentrant=False)
        grads = torch.autograd.grad((y.float() * w).sum(),
                                    list(p.parameters()))
        torch.cuda.synchronize()
        return grads, torch.cuda.max_memory_allocated() - base

    c = mamba.chunk_len(s)
    state = b * di * n * 4
    bound = 12 * b * s * di * 4 + (s // c) * state + 8 * c * state
    chunked, peak_chunked = run()
    flat_len = mamba.chunk_len
    mamba.chunk_len = lambda _s: 1
    try:
        flat, peak_flat = run()
    finally:
        mamba.chunk_len = flat_len
    assert c == 128 and peak_chunked <= bound < peak_flat, \
        (peak_chunked, bound, peak_flat)
    for a, f in zip(chunked, flat):
        assert torch.equal(a, f)


def test_three_train_steps_on_card(dev):
    """make_train_step on the card at the reduced smollm config, the
    same batch three times: finite losses that fall."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import make_train_step
    cfg = get_reduced("smollm-360m")
    m = LM(cfg, device=dev, seed=0)
    opt = AdamW(learning_rate=3e-3)
    params = dict(m.named_parameters())
    state = opt.init(params)
    step = make_train_step(m, opt)
    batch = lm_batch(DataConfig(seq_len=32, global_batch=4,
                                vocab=cfg.vocab), 0)
    losses = []
    for _ in range(3):
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
    assert all(np.isfinite(losses)) and losses[2] < losses[0], losses
    assert params["final_norm"].device.type == "cuda"


# -- the distribution layer on one card ----------------------------------------

DIST_CARD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/src")
import torch
import chip_smoke as cs
from repro_torch.configs import get_reduced
res = cs.dist_card(torch.device("cuda"), backend="nccl",
                   cfg=get_reduced("qwen2.5-32b"), seq=64)
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def dist_card_reduced():
    """chip_smoke.py's dist card part at the reduced qwen config, in a
    process of its own (it makes a one-rank NCCL default group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import json
    import subprocess

    out = subprocess.run([sys.executable, "-c", DIST_CARD, REPO_ROOT],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_one_by_one_mesh_train_step_equals_make_train_step(
        dist_card_reduced):
    res = dist_card_reduced
    assert res["loss_bit_equal"] and res["params_unequal"] == 0
    assert res["flops_rel_diff"] <= res["flops_tol"]


def test_compressed_psum_mean_on_nccl_equals_the_cpu(dist_card_reduced):
    assert dist_card_reduced["compress"]["bit_equal_to_cpu"]
