"""Card-only checks of the port: each hand-written kernel against its
plain PyTorch version, the launch counters, the two race checks (a
removed sync must fail the value gate), and the paths that run the
kernels: the search, serving, training and distribution layers at
reduced sizes. Skipped without a CUDA device; on the card:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``."""
import json
import subprocess
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

REPO_ROOT = str(Path(__file__).resolve().parents[1])
# The children that tests run in processes of their own.
CARD_CHILD = str(Path(__file__).resolve().parent / "card_child.py")
SLEEP_CYCLES = 50_000_000      # ~25 ms of device sleep (delays a producer)


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


def ragged_ell(n, k, rng):
    """Row lengths uniform in 0..K, slots past a row's length 0 with a
    valid column (the layout spmv/matrix.py:partition leaves)."""
    length = rng.integers(0, k + 1, size=n)
    live = np.arange(k)[None, :] < length[:, None]
    vals = np.where(live, rng.standard_normal((n, k)), 0.0).astype(
        np.float32)
    cols = np.where(live, rng.integers(0, n, size=(n, k)),
                    np.arange(n)[:, None]).astype(np.int32)
    return vals, cols, rng.standard_normal(n).astype(np.float32)


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


def test_distributed_orderings_with_the_kernels_are_bit_equal(small_spmv):
    """The JAX package's two orderings run the same kernels on the same
    operands, so y is the same bits; with use_kernel=False the plain
    versions run on the card and no kernel launches."""
    from repro_torch.spmv.distributed import make_distributed_spmv
    A, x, _ = small_spmv
    parts = partition(A, 4)
    ys = [make_distributed_spmv(parts, "cuda", overlap_local=ol)(x)
          for ol in (True, False)]
    np.testing.assert_array_equal(ys[0], ys[1])
    before = spmv_k.ell_spmv.launches + pack_k.pack.launches
    y = make_distributed_spmv(parts, "cuda", use_kernel=False)(x)
    assert spmv_k.ell_spmv.launches + pack_k.pack.launches == before
    ref = A.matvec(x)
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-4


def test_demo_spmv_impls_on_card_gates_every_schedule(dev):
    """demo_spmv_impls (16 x 16 dense products) through the wallclock
    evaluator on the card: all 280 schedules gated against the reference
    schedule's outputs, and those within 1e-5 of float64 products of the
    same inputs."""
    from repro_torch.core.dag import spmv_dag
    from repro_torch.core.enumerate import enumerate_schedules
    from repro_torch.engine import make_evaluator
    from repro_torch.engine.wallclock import demo_spmv_impls
    g = spmv_dag()
    impls, env = demo_spmv_impls(g, device=dev)
    assert env["xL"].is_cuda
    ev = make_evaluator(g, "wallclock", impls=impls, env=env,
                        reset=lambda: None, device=dev, repeats=1)
    times = ev.evaluate(list(enumerate_schedules(g, 2)))
    assert ev.n_checked == len(times) == 280 and min(times) > 0
    rng = np.random.default_rng(0)
    al, ar, xl = (rng.normal(size=sz).astype(np.float32).astype(np.float64)
                  for sz in ((16, 16), (16, 16), (16,)))
    ref = ev.reference_outputs()
    for k, want in (("yL", al @ xl), ("yR", ar @ xl)):
        assert np.abs(ref[k] - want).max() <= 1e-5 * np.abs(want).max(), k


def race_checks(spmv, dev) -> dict:
    """Two schedules with one sync removed: Pack delayed on its stream
    and CES-b4-PostSend removed (PostSend's copies no longer wait), and a
    GPU producer and consumer on two streams without the CSWE. Each must
    pass the value gate intact and fail it cut (``checks``). Through the
    CUDA graph runner (``graph_checks``) the intact schedules must pass,
    and whether the gate caught the race is reported: in a graph a race
    may or may not show."""
    from repro_torch.core.dag import (BoundOp, Graph, Op, OpKind, Schedule,
                                      spmv_dag)
    from repro_torch.core.executor import GraphRunner, op_impl, run_items
    from repro_torch.core.sync import expand
    from repro_torch.engine.wallclock import (ExecutorEvaluator,
                                              reference_schedule)

    graph_checks: list = []

    def caught(ev, g, items, drop) -> dict:
        cut = [it for it in items if it.name != drop]
        assert len(cut) == len(items) - 1, f"{drop} not in the schedule"
        ev.check(run_items(g, items, ev.impls, dev), "intact schedule")
        with pytest.raises(AssertionError) as gate:
            ev.check(run_items(g, cut, ev.impls, dev), f"without {drop}")
        # Through the graph: the first call captures (its eager warm-up
        # and its replay write every buffer), so the gated call is a
        # replay from poisoned buffers.
        seen = None
        for its in (items, cut):
            run = GraphRunner(g, its, ev.impls, dev)
            run(ev.env)
            try:
                ev.check(run, "as a CUDA graph")
            except AssertionError as e:
                if its is items:
                    raise
                seen = str(e).strip().splitlines()[0][:160]
            finally:
                run.release()
        graph_checks.append({"dropped": drop, "caught": seen is not None,
                             "gate": seen})
        return {"dropped": drop, "caught": True,
                "gate": str(gate.value).strip().splitlines()[0][:160]}

    g = spmv_dag()
    impls = spmv.impls()
    pack_impl = impls["Pack"]

    def slow_pack(env):
        torch.cuda._sleep(SLEEP_CYCLES)
        return pack_impl(env)

    impls["Pack"] = slow_pack
    ev = ExecutorEvaluator(g, impls=impls, env=spmv.env(),
                           reset=spmv.poison, device=dev)
    spmv_race = caught(ev, g, expand(g, reference_schedule(g)),
                       "CES-b4-PostSend")
    # The gate holds NaN equal to NaN: a row that the sorted layout's
    # perm missed would stay poisoned in the reference too.
    ref = ev.reference_outputs()
    assert all(np.isfinite(ref[k]).all() for k in ("yL", "yR"))

    toy = Graph()
    toy.add_op(Op("P", OpKind.GPU))
    toy.add_op(Op("C", OpKind.GPU))
    toy.add_edge("P", "C")
    toy.finalize()
    src = torch.arange(1 << 20, dtype=torch.float32, device=dev)
    mid, res = torch.empty_like(src), torch.empty_like(src)

    def produce(s):
        torch.cuda._sleep(SLEEP_CYCLES)
        return torch.mul(s, 2.0, out=mid)

    def poison():
        mid.fill_(float("nan"))
        res.fill_(float("nan"))

    toy_impls = {"P": op_impl(produce, ["src"], ["mid"]),
                 "C": op_impl(lambda m: torch.add(m, 1.0, out=res),
                              ["mid"], ["res"])}
    sched = Schedule((BoundOp("start"), BoundOp("P", 0), BoundOp("C", 1),
                      BoundOp("end")))
    ev = ExecutorEvaluator(toy, impls=toy_impls, env={"src": src},
                           reset=poison, device=dev)
    toy_race = caught(ev, toy, expand(toy, sched), "CSWE-b4-C")
    return {"checks": [spmv_race, toy_race], "graph_checks": graph_checks}


def test_removed_syncs_are_caught_by_the_gate(small_spmv, dev):
    """Pack delayed and CES-b4-PostSend removed; a producer/consumer pair
    on two streams with its CSWE removed: both fail the value gate, and
    both pass intact."""
    _, _, spmv = small_spmv
    checks = race_checks(spmv, dev)["checks"]
    assert [c["dropped"] for c in checks] == ["CES-b4-PostSend",
                                             "CSWE-b4-C"]
    assert all(c["caught"] for c in checks)


# -- the paper's measurement protocol and the runner's owned events ------------

def test_measure_cuda_times_a_device_sleep(dev):
    """measure_cuda of a ~25 ms device sleep returns within 20% of the
    sleep's CUDA-event time: the window waits for the device work its
    samples enqueued."""
    from repro_torch.core.bench import measure_cuda

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


# -- the compiled runner: one CUDA graph a schedule ---------------------------

SPMV_OUTPUTS = ("sendbuf", "halo", "yL", "yR")


def _outputs(env) -> dict:
    torch.cuda.synchronize()
    return {k: env[k].clone() for k in SPMV_OUTPUTS}


def _hold_to_plain(spmv, out) -> None:
    """The kernels' results in ``out`` against their plain versions on
    the same operands: Pack exactly, yL and yR within 1e-5 of max |y|
    (the kernel tests' float32 bound)."""
    assert torch.equal(out["sendbuf"], pack_plain(spmv.x, spmv.send_idx))
    for part, src, k in ((spmv.local, spmv.x, "yL"),
                         (spmv.remote, out["halo"], "yR")):
        plain = ell_spmv_plain(part.vals_t, part.cols_t, src, part.slice_k,
                               part.perm)
        assert bool(torch.isfinite(out[k]).all()), k
        assert float((out[k] - plain).abs().max()
                     / plain.abs().max()) <= 1e-5, k


def test_graph_replays_equal_the_eager_runner_bit_for_bit(small_spmv):
    """20 seeded schedules at n = 4,096: jit_runner's replay from poisoned
    buffers gives the eager runner's outputs bit for bit, and a second
    replay the first's; the kernels' results against their plain
    versions. Capture counts launches, replays do not."""
    import repro_torch.core as C
    from repro_torch.core.executor import build_runner, jit_runner
    _, _, spmv = small_spmv
    g = C.spmv_dag()
    scheds = list(C.enumerate_schedules(g, 2))
    pool = torch.cuda.graph_pool_handle()
    runs = []  # a shared pool lives while one of its graphs does
    for i in np.random.default_rng(0).choice(len(scheds), 20, replace=False):
        spmv.poison()
        want = _outputs(build_runner(g, scheds[i], spmv.impls(), "cuda")(
            spmv.env()))
        _hold_to_plain(spmv, want)
        run = jit_runner(g, scheds[i], spmv.impls(), "cuda", pool=pool)
        before = spmv_k.ell_spmv.launches
        run(spmv.env())
        assert spmv_k.ell_spmv.launches == before + 4  # warm-up, capture
        replays = []
        for _ in range(2):
            spmv.poison()
            replays.append(_outputs(run(spmv.env())))
        assert spmv_k.ell_spmv.launches == before + 4
        for k in SPMV_OUTPUTS:
            assert torch.equal(replays[0][k], want[k]), (i, k)
            assert torch.equal(replays[1][k], replays[0][k]), (i, k)
        runs.append(run)
    for run in runs:
        run.release()


def test_graph_replay_copies_another_input_in(small_spmv):
    """A later call with another x of the same shape multiplies it; one of
    another shape raises."""
    import repro_torch.core as C
    from repro_torch.core.executor import build_runner, jit_runner
    A, x, spmv = small_spmv
    g = C.spmv_dag()
    sched = next(iter(C.enumerate_schedules(g, 2)))
    run = jit_runner(g, sched, spmv.impls(), "cuda")
    run(spmv.env())
    x2 = torch.from_numpy(np.random.default_rng(9).standard_normal(
        x.size).astype(np.float32)).cuda()
    got = _outputs(run({"x": x2}))
    want = _outputs(build_runner(g, sched, spmv.impls(), "cuda")(
        spmv.env()))
    spmv.x.copy_(torch.from_numpy(x))
    for k in SPMV_OUTPUTS:
        assert torch.equal(got[k], want[k]), k
    ref = A.matvec(x2.cpu().numpy())
    y = (got["yL"] + got["yR"]).cpu().numpy()
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-4
    with pytest.raises(ValueError):
        run({"x": x2[:100]})
    run.release()


def test_a_host_sync_in_an_op_fails_the_capture(small_spmv):
    """An op that blocks the host cannot be captured: jit_runner raises
    and runs nothing in its place; the card runs the intact schedule
    (eager and captured) afterwards."""
    import repro_torch.core as C
    from repro_torch.core.executor import build_runner, jit_runner
    _, _, spmv = small_spmv
    g = C.spmv_dag()
    sched = next(iter(C.enumerate_schedules(g, 2)))
    impls = spmv.impls()
    local = impls["yL"]

    def syncing(env):
        out = local(env)
        torch.cuda.current_stream().synchronize()
        return out

    impls["yL"] = syncing
    with pytest.raises(RuntimeError):
        jit_runner(g, sched, impls, "cuda")(spmv.env())
    spmv.poison()
    want = _outputs(build_runner(g, sched, spmv.impls(), "cuda")(
        spmv.env()))
    _hold_to_plain(spmv, want)
    run = jit_runner(g, sched, spmv.impls(), "cuda")
    run(spmv.env())
    spmv.poison()
    got = _outputs(run(spmv.env()))
    for k in SPMV_OUTPUTS:
        assert torch.equal(got[k], want[k]), k
    run.release()


def test_graph_objective_on_card(small_spmv, dev):
    """ExecutorEvaluator(cuda_graph=True) gates and times 12 schedules;
    its key names the graph objective."""
    import repro_torch.core as C
    from repro_torch.engine import ExecutorEvaluator
    _, _, spmv = small_spmv
    g = C.spmv_dag()
    ev = ExecutorEvaluator(g, impls=spmv.impls(), env=spmv.env(),
                           reset=spmv.poison, repeats=3, device=dev,
                           store_tag=spmv.store_tag, cuda_graph=True)
    times = ev.evaluate(list(C.enumerate_schedules(g, 2))[:12])
    assert ev.n_checked == 12 and min(times) > 0
    assert ":graph:" in ev.objective_key()
    ref = ev.reference_outputs()
    _hold_to_plain(spmv, {k: torch.from_numpy(ref[k]).to(dev)
                          for k in SPMV_OUTPUTS})


def test_distributed_spmv_replay_is_the_step(small_spmv):
    """make_distributed_spmv's run(x) (the graph) and run.replay() give
    the eager run.step()'s y bit for bit, for both orderings."""
    from repro_torch.spmv.distributed import make_distributed_spmv
    A, x, _ = small_spmv
    for ol in (True, False):
        run = make_distributed_spmv(partition(A, 4), "cuda",
                                    overlap_local=ol)
        y = run(x)
        for env in (run.step(), run.replay()):
            torch.cuda.synchronize()
            np.testing.assert_array_equal(
                (env["yL"] + env["yR"]).cpu().numpy(), y)
        _hold_to_plain(run.spmv, _outputs(run.replay()))


def test_removed_syncs_through_the_graph_are_reported(small_spmv, dev):
    """The race checks through jit_runner: the intact schedules pass the
    gate as graphs (else the check raises), and whether each race showed
    is reported, not asserted."""
    _, _, spmv = small_spmv
    checks = race_checks(spmv, dev)["graph_checks"]
    assert [c["dropped"] for c in checks] == ["CES-b4-PostSend",
                                             "CSWE-b4-C"]
    print("graph races:", checks)


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


# -- kernel autotuning and the evaluation service -------------------------------

@pytest.mark.parametrize("name", ["pack", "spmv_mulsum", "flash_attention"])
def test_autotune_sweep_gates_every_candidate(dev, name):
    """One exhaustive sweep of a kernel's autotune space (its default
    instance) through the wallclock evaluator on the card: every
    candidate gated against the space's reference and timed, the kernel
    launched."""
    from repro_torch.engine import make_evaluator
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.search import ExhaustiveSearch, run_search
    from repro_torch.space import make_space
    counter = {"pack": pack_k.pack, "spmv_mulsum": spmv_k.ell_spmv,
               "flash_attention": fa_k.flash_attention}[name]
    sp = make_space(name, device=dev)
    ev = make_evaluator(sp, "wallclock", repeats=3, warmup=1, device=dev)
    before = counter.launches
    res = run_search(sp, ExhaustiveSearch(sp), ev, budget=sp.n_candidates())
    assert ev.n_checked == len(res.schedules) == sp.n_candidates() > 1
    assert all(np.isfinite(t) and t > 0.0 for t in res.times)
    assert counter.launches > before


def _card_files(pid: int) -> list:
    """The /dev/nvidia* files a process holds open: a CUDA context holds
    some, a process that only imported torch holds none."""
    import os

    fds = f"/proc/{pid}/fd"
    out = set()
    for fd in os.listdir(fds):
        try:
            target = os.readlink(os.path.join(fds, fd))
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return sorted(out)


def test_a_vectorized_rpc_server_holds_no_card(dev):
    """``python -m repro_torch.engine.server --space halo3d --backend
    vectorized`` on the card's host answers an rpc search bit for bit as
    local sim does, with no local evaluation, and holds no /dev/nvidia*
    file while this process, which holds a CUDA context, does: an rpc
    objective is analytic."""
    import os

    from repro_torch.core.dag import halo3d_dag
    from repro_torch.engine import make_evaluator, spawn_server_process
    from repro_torch.search import MCTSSearch, run_search
    torch.zeros(1, device=dev)
    g = halo3d_dag()
    run = dict(budget=None, sim_budget=30, batch_size=8)
    server = spawn_server_process("halo3d", backend="vectorized")
    try:
        with make_evaluator(g, "rpc", hosts=[server.addr], min_shard=1,
                            deadline=10.0, connect_timeout=5.0) as ev:
            res = run_search(g, MCTSSearch(g, 2, seed=5), ev, **run)
            assert ev.rpc_stats()["local_evals"] == 0
        files = _card_files(server.proc.pid)
    finally:
        server.terminate()
    ref = run_search(g, MCTSSearch(g, 2, seed=5), backend="sim", **run)
    assert res.times_array().tobytes() == ref.times_array().tobytes()
    assert files == []
    assert _card_files(os.getpid())


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
    padding against a float64 softmax of the same inputs rounded to the
    case's dtype (``float64_attention``); f32 2e-5, bf16 3e-2
    (bf16 outputs). Not against the CPU's float32 plain path, which
    differs between processes (PERF.md)."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.flash_attention.ref import float64_attention
    rng = np.random.default_rng(sum(q_shape))
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in (q_shape, kv_shape, kv_shape)]
    before = fa_k.flash_attention.launches
    out = mha(*(torch.from_numpy(a).to(dev, dtype) for a in arrays),
              causal=causal)
    torch.cuda.synchronize()
    assert fa_k.flash_attention.launches == before + 1
    ref = float64_attention(arrays, dtype, causal)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    assert float((out.cpu().double() - ref).abs().max()) <= tol


# The bf16 route at every ATTN_CASES shape, and grouped-query cases (q
# heads on H / g kv heads) in both dtypes: (q shape, kv shape, dtype,
# causal), (B, H, S, D).
ATTN_BF16_CASES = [((2, 3, 256, 64), (2, 3, 256, 64), torch.bfloat16, True),
                   ((1, 2, 300, 64), (1, 2, 300, 64), torch.bfloat16, True),
                   ((1, 2, 64, 48), (1, 2, 64, 48), torch.bfloat16, True),
                   ((1, 2, 128, 64), (1, 2, 256, 64), torch.bfloat16,
                    False),
                   ((1, 1, 128, 64), (1, 1, 384, 64), torch.bfloat16, True)]
ATTN_GQA_CASES = [((2, 10, 256, 128), (2, 2, 256, 128), torch.bfloat16,
                   True),
                  ((1, 4, 300, 64), (1, 2, 300, 64), torch.bfloat16, True),
                  ((1, 10, 128, 64), (1, 2, 256, 64), torch.bfloat16, False),
                  ((2, 10, 256, 128), (2, 2, 256, 128), torch.float32, True),
                  ((1, 4, 128, 64), (1, 2, 384, 64), torch.float32, True)]


@pytest.mark.parametrize("q_shape,kv_shape,dtype,causal",
                         ATTN_BF16_CASES + ATTN_GQA_CASES)
def test_flash_attention_bf16_and_grouped_heads_match_float64(
        dev, q_shape, kv_shape, dtype, causal):
    """Through ``mha`` (one launch a call): bf16 at each ATTN_CASES
    shape, and g q heads on each kv head (g = 5 and 2), against
    ``float64_attention`` on kv widened on the host (f32 2e-5,
    bf16 3e-2, as test_flash_attention_kernel_matches_plain)."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.flash_attention.ref import float64_attention
    rng = np.random.default_rng(sum(q_shape) + sum(kv_shape))
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in (q_shape, kv_shape, kv_shape)]
    before = fa_k.flash_attention.launches
    out = mha(*(torch.from_numpy(a).to(dev, dtype) for a in arrays),
              causal=causal)
    torch.cuda.synchronize()
    assert fa_k.flash_attention.launches == before + 1
    assert out.shape == q_shape and out.dtype == dtype
    ref = float64_attention(arrays, dtype, causal)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    assert float((out.cpu().double() - ref).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hq,hkv", [(10, 2), (4, 2)])
def test_flash_attention_reads_projection_outputs_where_they_lie(
        dev, dtype, hq, hkv):
    """q, k and v as slices of one projection's (B, S, Hq + 2 Hkv, D)
    output (strided, none contiguous) straight into the kernel, its
    output a (B, S, Hq, D) buffer: one launch, no copy of any operand
    (each is read where it lies), and the plain version's values on the
    same views within f32 2e-5 / bf16 3e-2 of float64."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ref import float64_attention
    b, s, d = 2, 256, 128
    rng = np.random.default_rng(hq)
    fused = torch.from_numpy(rng.standard_normal(
        (b, s, hq + 2 * hkv, d)).astype(np.float32)).to(dev, dtype)
    q, k, v = (fused[:, :, :hq], fused[:, :, hq:hq + hkv],
               fused[:, :, hq + hkv:])
    out = torch.empty(b, s, hq, d, device=dev, dtype=dtype)
    before = fa_k.flash_attention.launches
    fa_k.flash_attention(q, k, v, out, causal=True, block_q=128,
                         block_k=128, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert fa_k.flash_attention.launches == before + 1
    arrays = [x.transpose(1, 2).float().cpu().numpy() for x in (q, k, v)]
    ref = float64_attention(arrays, dtype, True).transpose(1, 2)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    assert float((out.cpu().double() - ref).abs().max()) <= tol


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
                                  "internvl2-2b", "moonlight-16b-a3b"])
def test_generate_on_card_gives_the_cpu_tokens_for_every_family(dev, arch):
    """Greedy tokens of each non-dense family's reduced config in
    float32 on the card (flash prefill where attention is causal, the
    Mamba and RWKV recurrences, MoE dispatch, the encoder and the VLM
    prefix, latent attention's decode through its latent cache) equal
    those of the same weights and frontend on the CPU; the prefill
    launches the flash kernel once a causal attention layer (latent
    attention has no kernel)."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.kernels.flash_attention import kernel as fa_k
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
    causal = 0 if cfg.mla is not None else sum(
        d.kind == "attn" and d.causal for d in on_card.descs)
    before = fa_k.flash_attention.launches
    got = Engine(on_card, t_max=t_max).generate(
        prompts.to(dev), 12, frontend=None if front is None else front.to(dev))
    assert fa_k.flash_attention.launches - before == causal
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


# -- the training kernels (csrc/flash_attention_train.cu) ---------------------

# Both (D_QK, D_V) templates at reduced S: ((D_QK, D_V), (B, S, H)).
TRAIN_ATTN_CASES = [(dims, shape) for dims in ((128, 128), (192, 128))
                    for shape in ((1, 1024, 4), (2, 512, 4))]
# SHA-256 of mha's bf16 output at the prefill cell's shape from numpy
# seed 0 (served_digest), as the served kernel gave it before the
# training kernels were added: ``served_digest`` run on the tree of the
# commit before them and on the tree with them gave this value on both
# (NVIDIA H100 80GB HBM3, 700 W).
SERVED_DIGEST = ("ac3d95b2a8b2f75adb670896ab1a3042"
                 "f479f92bb2dfb088bb60a122eca0c738")


def _train_case(dev, dims, shape, seed=0):
    """bf16 q, k (B, S, H, D_QK) and v, dO (B, S, H, D_V) on the card,
    drawn with numpy."""
    b, s, h = shape
    rng = np.random.default_rng(seed + sum(dims) + s)
    return [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
        for d in (dims[0], dims[0], dims[1], dims[1])]


def _train_counts():
    from repro_torch.kernels.flash_attention import train as ft
    return (ft.forward.launches, ft.backward_dq.launches,
            ft.backward_dkdv.launches)


def _float64_train(q, k, v, do):
    """``float64_attention`` of the bf16 values (scale D_QK ** -0.5),
    each row's log-sum-exp, rowsum(dO o) and the gradients by float64
    autograd: (o, lse (B, H, S), delta (B, H, S), dq, dk, dv), the rest
    (B, S, H, D), on the CPU."""
    from repro_torch.kernels.flash_attention.ref import float64_attention
    leaves = [t.cpu().double().transpose(1, 2).detach().requires_grad_()
              for t in (q, k, v)]
    o = float64_attention(leaves, torch.float64, True)       # (B, H, S, Dv)
    dod = do.cpu().double().transpose(1, 2)
    o.backward(dod)
    s = leaves[0] @ leaves[1].transpose(-1, -2) * q.shape[-1] ** -0.5
    n = s.shape[-1]
    later = torch.ones(n, n, dtype=torch.bool).triu(1)
    lse = torch.logsumexp(s.masked_fill(later, float("-inf")), -1).detach()
    delta = (dod * o).sum(-1).detach()
    return (o.detach().transpose(1, 2), lse, delta,
            *(t.grad.transpose(1, 2) for t in leaves))


def _within(got: torch.Tensor, ref: torch.Tensor, rel: float,
            floor: float) -> bool:
    """|got - ref| <= rel |ref| + floor max |ref| everywhere."""
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    return bool(((got - ref).abs() <=
                 rel * ref.abs() + floor * ref.abs().max()).all())


@pytest.mark.parametrize("dims,shape", TRAIN_ATTN_CASES)
def test_flash_train_kernels_match_float64(dev, dims, shape):
    """The forward's o and LSE and the backward's dq, dk and dv, one
    launch each, against a float64 evaluation of the same attention of
    the same bf16 values, the gradients by float64 autograd. o and the
    gradients within bf16's rounding of each value (2^-8 of it) plus
    1e-4 of the largest (the f32 sums' order); o's f32 copy within 2e-5
    of its largest, which a P rounded to one bf16 would miss (P enters
    P.V as hi + lo); the LSE within 1e-5 and D = rowsum(dO o) within
    1e-5 of their largest."""
    from repro_torch.kernels.flash_attention import train as ft
    q, k, v, do = _train_case(dev, dims, shape)
    scale = dims[0] ** -0.5
    before = _train_counts()
    o, o32, lse = ft.forward(q, k, v, scale)
    dq, delta = ft.backward_dq(q, k, v, do, o32, lse, scale)
    dk, dv = ft.backward_dkdv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert _train_counts() == tuple(n + 1 for n in before)
    ref_o, ref_lse, ref_delta, *ref_grads = _float64_train(q, k, v, do)
    assert _within(o, ref_o, 2 ** -8, 1e-4)
    assert _within(o32, ref_o, 0.0, 2e-5)
    assert _within(lse, ref_lse, 0.0, 1e-5)
    assert _within(delta, ref_delta, 0.0, 1e-5)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), ref_grads):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        assert _within(got, ref, 2 ** -8, 1e-4), name


@pytest.mark.parametrize("dims,shape", TRAIN_ATTN_CASES)
def test_flash_train_route_matches_streaming_on_card(dev, dims, shape):
    """``train_attention`` (the autograd Function as the model calls it,
    scale ``q_scale``'s) against ``streaming_attention``'s autograd on
    the card, the same bf16 operands and dO: the output and each
    gradient within 2^-7 of each value plus 1e-4 of the largest. Each
    route computes an f32-accurate value and rounds it once to bf16
    (half an ulp, 2^-9 of the value, each); the rest is their f32 sums
    in other orders. The kernel route launches each kernel once, the
    streaming route none."""
    from repro_torch.models import attention as attn
    q, k, v, do = _train_case(dev, dims, shape, seed=1)
    s = shape[1]
    pos = torch.arange(s, device=dev)
    outs = []
    for kernel in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = _train_counts()
        if kernel:
            assert attn.trains_on_kernel(*leaves)
            o = attn.train_attention(*leaves)
        else:
            o = attn.streaming_attention(
                *leaves, pos, pos, torch.ones(s, dtype=torch.bool,
                                              device=dev), causal=True)
        outs.append((o, *torch.autograd.grad(o, leaves, do)))
        torch.cuda.synchronize()
        assert _train_counts() == tuple(n + kernel for n in before)
    for name, got, ref in zip(("o", "dq", "dk", "dv"), *outs):
        assert got.dtype == torch.bfloat16
        assert _within(got, ref, 2 ** -7, 1e-4), name


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "moonlight-16b-a3b"])
def test_flash_train_route_engages_in_a_checkpointed_layer(dev, arch):
    """One attention layer of each train cell's configuration at its
    published widths (deepseek-moe-16b: 16 heads of 128 through
    ``attn_forward`` on the train step's ``attention="plain"``;
    Moonlight: latent attention, 192 / 128, through ``mla_forward``),
    1 x 512 tokens in bf16 under a layer checkpoint as the train step
    runs it: two forward launches (the forward and the recompute), one
    of each backward pass, none of the served kernel; every weight's
    gradient finite and the deterministic kernels' gradients the same
    bits in a second run."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.models import attention as attn
    from repro_torch.models import params as prm
    cfg = get_config(arch)
    specs = attn.attention_specs(cfg)
    p = prm.Params(specs, device=dev, dtype=torch.float32)
    prm.init(p, specs, torch.Generator(device=dev).manual_seed(0))
    p.requires_grad_(True)
    x = torch.randn((1, 512, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1)
                    ).to(torch.bfloat16)

    def layer(t):
        if cfg.mla is not None:
            return attn.mla_forward(p, t, cfg)[0]
        return attn.attn_forward(p, t, cfg, None, attention="plain")

    runs = []
    for _ in range(2):
        before, served = _train_counts(), fa_k.flash_attention.launches
        y = checkpoint(layer, x, use_reentrant=False)
        runs.append(torch.autograd.grad(y.float().square().mean(),
                                        list(p.parameters())))
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_train_counts(), before)) == \
            (2, 1, 1)
        assert fa_k.flash_attention.launches == served
    for a, b in zip(*runs):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b)


def served_digest(dev) -> str:
    """SHA-256 of mha's bf16 output (B, H, S, D) at the prefill cell's
    shape, 4 x 1,024 tokens and 16 heads of 128, from numpy seed 0,
    under no_grad."""
    import hashlib

    from repro_torch.kernels.flash_attention.ops import mha
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (4, 16, 1024, 128)).astype(np.float32)).to(dev, torch.bfloat16)
        for _ in range(3))
    with torch.no_grad():
        out = mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    return hashlib.sha256(out.cpu().view(torch.int16).numpy().tobytes()
                          ).hexdigest()


def test_served_flash_output_is_unchanged_and_off_the_training_route(dev):
    """The served kernel (csrc/flash_attention_bf16.cu through ``mha``)
    at the prefill cell's shape gives the bits it gave before the
    training kernels were added (``SERVED_DIGEST``), in one launch and
    with no launch of the training kernels."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    before, served = _train_counts(), fa_k.flash_attention.launches
    digest = served_digest(dev)
    assert fa_k.flash_attention.launches == served + 1
    assert _train_counts() == before
    assert digest == SERVED_DIGEST, digest


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "moonshot-v1-16b-a3b",
                                  "deepseek-moe-16b", "jamba-v0.1-52b",
                                  "rwkv6-3b", "whisper-tiny",
                                  "internvl2-2b", "moonlight-16b-a3b"])
def test_lm_loss_gradients_on_card_equal_the_cpu(dev, arch):
    """A reduced config on the card and on the CPU with one set of
    weights. qwen2.5-32b in bf16 activations (4 x 64 tokens): loss
    within 2e-2 relative, each gradient within 0.3 of its norm (the
    bf16 bound of tests/test_torch_train.py). The non-dense families in
    f32 activations at 4 x 96 tokens, so that Mamba runs three
    checkpointed chunks and RWKV three blocks (rwkv_chunk=32), with
    whisper's and internvl2's frontends: loss within 1e-5 relative, each
    gradient within 1e-3 of its max |g| (the f32 bound of
    tests/test_torch_train_families.py). The flash route, where a model
    has it (latent attention has none), refuses a backward."""
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
    if cfg.mla is None and any(d.kind == "attn" and d.causal
                               for d in card.descs):
        with pytest.raises(RuntimeError, match="no backward"):
            card.loss(batch, rwkv_chunk=chunk)


def test_mamba_backward_holds_the_state_once_a_chunk(dev):
    """jamba-v0.1-52b's Mamba mixer at full width (d_inner 8,192, N 16),
    1 x 1,024 tokens in bf16 under a layer checkpoint: the chunked loop
    (8 checkpointed chunks of 128) stays within the bound it derives
    (12 f32 (B, S, d_inner) tensors, the chunks' states and one
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

def run_child(*args: str, timeout: float) -> subprocess.CompletedProcess:
    """``tests/card_child.py`` with ``args`` in a process of its own (each
    child makes a default process group)."""
    return subprocess.run([sys.executable, CARD_CHILD, *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=REPO_ROOT)


@pytest.fixture(scope="module")
def dist_card_reduced():
    """The 1x1-mesh train cell of the reduced qwen config and the
    compressed sync on a one-rank NCCL group (``card_child.py
    dist_card``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    out = run_child("dist_card", timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_one_by_one_mesh_train_step_equals_make_train_step(
        dist_card_reduced):
    res = dist_card_reduced
    assert res["loss_bit_equal"] and res["params_unequal"] == 0
    assert res["flops_rel_diff"] <= res["flops_tol"]


def test_compressed_psum_mean_on_nccl_equals_the_cpu(dist_card_reduced):
    assert dist_card_reduced["compress"]["bit_equal_to_cpu"]


# -- the distributed SpMV with one process per rank ------------------------------

SHARD_SIZE = ("4096", "40960")


def _shard_child(world: int):
    """``card_child.py shard`` as rank 0 of ``world`` at a small size
    (band_matrix(4096, 40960), half-width 1,024)."""
    from repro_torch.launch.mesh import free_port

    return run_child("shard", "0", str(world), str(free_port()),
                     *SHARD_SIZE, timeout=300)


def test_shard_child_one_rank_kernels_against_plain(dev):
    """R = 1 on one card (the exchange is the identity): each case's y
    within 1e-4 of max |y| of the float64 oracle and bit for bit the
    one-process make_distributed_spmv's, ell_spmv launched twice a step
    with the kernels and nothing without, the kernel cases within 1e-4
    of the plain ones, the orderings with the kernels bit-equal."""
    out = _shard_child(1)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert (res["world"], res["backend"], res["m"]) == (1, "nccl", 4096)
    assert len(res["cases"]) == 4
    for case in res["cases"]:
        assert case["rel_err"] <= 1e-4 and case["equals_one_process"]
        assert case["launches"] == ({"ell_spmv": 2} if case["use_kernel"]
                                    else {})
        assert case["us"] > 0
    assert res["kernel_orderings_bit_equal"]
    assert all(v <= 1e-4 for v in res["kernel_vs_plain_rel"].values())


def test_shard_child_refuses_more_ranks_than_cards(dev):
    """A group of one rank more than there are cards raises before any
    group is made (NCCL refuses two ranks on one card)."""
    out = _shard_child(torch.cuda.device_count() + 1)
    assert out.returncode != 0
    assert "cards, one a rank; this machine has" in out.stderr


# -- AdamW (csrc/adamw.cu) ----------------------------------------------------

# Leaves: one element, fewer than a vector, one past a multiple of it,
# deepseek-moe-16b's expert slab, and two views offset by one element:
# "offset" with every array offset alike (a scalar head and tail around
# the vector body), "offset_p" with only parameter and gradient offset
# (no head aligns them all: element by element).
ADAMW_LEAVES = {"one": (1,), "three": (3,), "odd": (4097,),
                "slab": (2048, 1408), "offset": (4097,),
                "offset_p": (4097,)}
# (parameter, gradient, master copy): the dtypes the CUDA path meets.
ADAMW_DTYPES = {"f32": (torch.float32, torch.float32, False),
                "bf16_grads": (torch.float32, torch.bfloat16, False),
                "bf16_master": (torch.bfloat16, torch.bfloat16, True)}


def _offset_by_one(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].copy_(t.reshape(-1))


def _same_place(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` at its offset from a fresh allocation: the same
    alignment, so the same split into head, vectors and tail."""
    buf = torch.empty(t.storage_offset() + t.numel(), dtype=t.dtype,
                      device=t.device)
    return buf[t.storage_offset():].view(t.shape).copy_(t)


def _adamw_case(dev, case, clip):
    from repro_torch.optim.adamw import AdamW, warmup_cosine

    pdt, gdt, master = ADAMW_DTYPES[case]
    gen = torch.Generator().manual_seed(11)
    params, grads = {}, [{} for _ in range(5)]
    for k, shape in ADAMW_LEAVES.items():
        p = torch.randn(shape, generator=gen).to(dev, pdt)
        params[k] = _offset_by_one(p) if k.startswith("offset") else p
        for step in grads:
            g = (3 * torch.randn(shape, generator=gen)).to(dev, gdt)
            step[k] = _offset_by_one(g) if k.startswith("offset") else g
    opt = AdamW(learning_rate=warmup_cosine(1e-2, 2, 5), weight_decay=0.3,
                grad_clip_norm=clip, master_weights=master)
    state = opt.init(params)
    for name in ("mu", "nu") + (("master",) if master else ()):
        state[name]["offset"] = _offset_by_one(state[name]["offset"])
    return opt, params, state, grads


def _adamw_copy(params, state):
    return ({k: _same_place(p) for k, p in params.items()},
            {name: (_same_place(v) if name == "count" else
                    {k: _same_place(t) for k, t in v.items()})
             for name, v in state.items()})


def _plain_adamw_step(opt, grads, state, params):
    """AdamW.step with kernels/adamw's plain version on the card."""
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.optim.adamw import global_norm

    count, bc1, bc2, lr = opt._begin(state)
    scale = None if opt.grad_clip_norm is None else \
        opt._scale(global_norm(grads))
    master = state.get("master")
    for k, g in grads.items():
        adamw_ops.update_plain(
            params[k], g, state["mu"][k], state["nu"][k],
            None if master is None else master[k], scale, bc1, bc2, lr,
            **opt._hyper())
    state["count"] = count


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("case", list(ADAMW_DTYPES))
def test_adamw_kernels_match_plain_over_five_steps(dev, case, clip):
    """Five steps through the kernels against the plain version on the
    card: mu, nu and p (p's float32 master copy where p is bfloat16, and
    p that copy rounded) within 1e-6 of their max |value| a leaf; two runs
    from one state bit-equal; each step launches one update a leaf and,
    with the clip, one sum of squares a leaf and the finishing one: every
    leaf takes the kernel route."""
    from repro_torch.kernels.adamw import kernel as adamw_k

    opt, params, state, grads = _adamw_case(dev, case, clip)
    runs = []
    for _ in range(2):
        p, s = _adamw_copy(params, state)
        for g in grads:
            before = (adamw_k.sumsq.launches, adamw_k.update.launches)
            opt.step(g, s, p)
            assert (adamw_k.sumsq.launches - before[0],
                    adamw_k.update.launches - before[1]) == (
                0 if clip is None else len(g) + 1, len(g))
        runs.append((p, s))
    (p, s), (p2, s2) = runs
    pp, ps = _adamw_copy(params, state)
    for g in grads:
        _plain_adamw_step(opt, g, ps, pp)
    torch.cuda.synchronize()
    master = "master" in s
    for k in ADAMW_LEAVES:
        names = ("mu", "nu") + (("master",) if master else ())
        assert torch.equal(p[k], p2[k]), k
        for name in names:
            assert torch.equal(s[name][k], s2[name][k]), (name, k)
        pairs = [(s[name][k], ps[name][k], name) for name in names]
        if master:
            assert torch.equal(p[k], s["master"][k].to(p[k].dtype)), k
        else:
            pairs.append((p[k], pp[k], "p"))
        for got, want, name in pairs:
            err = float((got.float() - want.float()).abs().max())
            assert err <= 1e-6 * float(want.float().abs().max()), \
                (name, k, err)
        assert p[k].dtype == params[k].dtype


@pytest.mark.parametrize("gdt", [torch.float32, torch.bfloat16])
def test_adamw_sumsq_is_deterministic_and_exact(dev, gdt):
    """Each leaf's sum of squares within 1e-6 of float64's, the total the
    leaves' float32 sums added in order, and the same bits twice; the
    9,000,001-element leaf runs the kernel's four-vector loop."""
    from repro_torch.kernels.adamw import ops as adamw_ops

    gen = torch.Generator().manual_seed(5)
    gs = [torch.randn(shape, generator=gen).to(dev, gdt)
          for shape in ADAMW_LEAVES.values()]
    gs.append(_offset_by_one(torch.randn(9_000_001, generator=gen).to(
        dev, gdt)))
    gs[-2] = _offset_by_one(gs[-2])
    sums, total = adamw_ops.sumsq(gs)
    sums2, total2 = adamw_ops.sumsq(gs)
    assert torch.equal(sums, sums2)
    assert torch.equal(total, total2)
    want = [float(torch.sum(g.double() ** 2)) for g in gs]
    for got, w in zip(sums, want):
        assert abs(float(got) - w) <= 1e-6 * w
    assert torch.equal(total, sum(sums))


# -- MoE slot positions (csrc/moe_positions.cu) ----------------------------------

# name: (B, S, k, E, capacity, distinct): the benchmark cells' shapes at
# E = 64 and a capacity factor of 1.25 (train-4k, train-8k, prefill), a
# decode step (capacity = the batch), then the edges: E not a power of
# two, E = 1, lengths that no tile divides, a group of many tiles, every
# choice on one expert, capacity above S, 256 (DeepSeek-V3's count) and
# the most experts the kernel takes, repeats within a token.
POSITIONS_CARD = {
    "train_4k": (1, 4096, 6, 64, 481, True),
    "train_8k": (1, 8192, 6, 64, 961, True),
    "prefill": (4, 1024, 6, 64, 121, True),
    "decode": (16, 1, 6, 64, 16, True),
    "experts_not_a_power_of_two": (3, 777, 2, 5, 250, True),
    "one_expert": (2, 300, 1, 1, 300, True),
    "no_tile_divides": (3, 1367, 6, 64, 161, True),
    "many_tiles": (1, 50_001, 3, 64, 2000, True),
    "one_expert_takes_all": (2, 700, 6, 64, 82, None),
    "capacity_above_s": (2, 30, 6, 8, 35, True),
    "experts_256": (2, 2048, 8, 256, 81, True),
    "experts_max": (1, 4096, 8, 1024, 41, True),
    "repeats_within_a_token": (2, 999, 4, 3, 1400, False),
}


def _choices(b, s, k, e, distinct, seed):
    gen = torch.Generator().manual_seed(seed)
    if distinct is None:
        return torch.full((b, s, k), 7, dtype=torch.int64)
    if distinct:
        return torch.argsort(torch.rand((b, s, e), generator=gen),
                             dim=-1)[..., :k].contiguous()
    return torch.randint(0, e, (b, s, k), generator=gen)


@pytest.mark.parametrize("case", list(POSITIONS_CARD))
def test_moe_positions_kernel_is_the_plain_version(dev, case):
    """pos and keep equal the plain version's, on the card and on the
    CPU, in one launch."""
    from repro_torch.kernels.moe_positions import kernel as positions_k
    from repro_torch.models import moe

    b, s, k, e, c, distinct = POSITIONS_CARD[case]
    top_e = _choices(b, s, k, e, distinct, seed=s + e)
    want_pos, want_keep = moe._positions_plain(top_e, e, c)
    before = positions_k.positions.launches
    pos, keep = positions_k.positions(top_e.to(dev), e, c)
    assert positions_k.positions.launches == before + 1
    card_pos, card_keep = moe._positions_plain(top_e.to(dev), e, c)
    assert torch.equal(pos, card_pos) and torch.equal(keep, card_keep)
    assert torch.equal(pos.cpu(), want_pos)
    assert torch.equal(keep.cpu(), want_keep)


def test_moe_positions_kernel_skips_an_expert_out_of_range(dev):
    """An expert outside [0, E) takes no slot (pos -1, keep False) and
    moves no other choice's position."""
    from repro_torch.kernels.moe_positions import kernel as positions_k
    from repro_torch.models import moe

    e = 64
    top_e = _choices(2, 500, 6, e, True, seed=9)
    bad = torch.zeros(top_e.shape, dtype=torch.bool)
    bad.view(-1)[::7] = True
    top_e[bad] = torch.tensor([-1, e, e + 100, -(2 ** 40)]).repeat(
        int(bad.sum()) // 4 + 1)[:int(bad.sum())]
    want_pos, want_keep = moe._positions_plain(
        torch.where(bad, e, top_e), e + 1, 40)
    pos, keep = positions_k.positions(top_e.to(dev), e, 40)
    assert torch.equal(pos.cpu(), torch.where(bad, -1, want_pos))
    assert torch.equal(keep.cpu(), want_keep & ~bad)


def test_moe_positions_kernel_refuses_and_is_captured(dev):
    """int32, a non-contiguous view and more than MAX_EXPERTS experts
    raise; the launch replays in a CUDA graph on new choices."""
    from repro_torch.kernels.moe_positions import kernel as positions_k
    from repro_torch.models import moe

    top_e = _choices(4, 1024, 6, 64, True, seed=1).to(dev)
    with pytest.raises(TypeError, match="int64"):
        positions_k.positions(top_e.int(), 64, 121)
    with pytest.raises(ValueError, match="contiguous"):
        positions_k.positions(top_e.transpose(0, 1), 64, 121)
    with pytest.raises(ValueError, match="experts"):
        positions_k.positions(top_e, positions_k.MAX_EXPERTS + 1, 121)
    static = top_e.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        positions_k.positions(static, 64, 121)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        pos, keep = positions_k.positions(static, 64, 121)
    fresh = _choices(4, 1024, 6, 64, True, seed=2).to(dev)
    static.copy_(fresh)
    graph.replay()
    torch.cuda.synchronize()
    want_pos, want_keep = moe._positions_plain(fresh, 64, 121)
    assert torch.equal(pos, want_pos) and torch.equal(keep, want_keep)


def test_moe_positions_on_the_card_take_the_kernel_route(dev):
    """``_positions`` on a CUDA tensor (top-k's non-contiguous indices)
    launches the kernel once: every choice is the kernel's."""
    from repro_torch.kernels.moe_positions import kernel as positions_k
    from repro_torch.models import moe

    idx = torch.argsort(torch.rand((2, 300, 64), device=dev), dim=-1)
    top_e = idx[..., :6]
    before = positions_k.positions.launches
    pos, keep = moe._positions(top_e, 64, 36)
    assert positions_k.positions.launches == before + 1
    want_pos, want_keep = moe._positions_plain(top_e, 64, 36)
    assert torch.equal(pos, want_pos) and torch.equal(keep, want_keep)
