"""The LM train step as an op-DAG (``repro_torch.core.stepdag``) and its
cost terms (``repro_torch.launch.costs``) against the JAX package's.

Under the reference's constants every graph, duration, makespan, cost
term and flop count is the reference's exactly (float64, no tolerance):
``tests/test_sharding_and_hlo.py``'s stepdag cases and
``tests/test_engine_vectorized.py::test_stepdag_supported`` mirrored,
``costs_from_arch`` against ``examples/schedule_search.py``'s and
``model_flops``/``roofline`` against ``repro/launch/costs.py``. The
port's own constants are the H100 SXM data sheet's
(``train_step_machine``); its roofline terms are the reference's scaled
by the ratio of the constants.
"""
import dataclasses
import importlib.util
import io
import pathlib
import random
from contextlib import redirect_stdout

import numpy as np
import pytest

import repro.core as RC
import repro.engine as RE
import repro.launch.costs as RCOSTS
import repro.search as RS
import repro_torch.core as C
import repro_torch.engine as E
import repro_torch.launch.costs as COSTS
from repro.configs import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import applicable as ref_applicable
from repro.core.stepdag import StepCosts as RStepCosts
from repro.core.stepdag import train_step_dag as r_train_step_dag
from repro.core.stepdag import with_comm_durations as r_with_comm
from repro.search.strategy import random_schedule as r_random_schedule
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.stepdag import (StepCosts, train_step_dag,
                                      with_comm_durations)
from repro_torch.search import MCTSSearch, run_search
from repro_torch.space import random_schedule

ROOT = pathlib.Path(__file__).resolve().parents[1]
COSTS_KW = dict(fwd_flops=2e12, bwd_flops=4e12, fwd_bytes=1e9,
                bwd_bytes=2e9, grad_bytes=2e9, param_gather_bytes=1.5e9,
                opt_bytes=3e8)


def _load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_machine():
    """The reference's ``Machine()`` constants in the port's type."""
    return C.Machine(**dataclasses.asdict(RC.Machine()))


def _pair(n_layers, zero_sharded=False, link=50e9):
    """The same train-step DAG from both packages, collective durations
    pinned at ``link`` bytes/s."""
    g = with_comm_durations(train_step_dag(n_layers, StepCosts(**COSTS_KW),
                                           zero_sharded), link)
    gr = r_with_comm(r_train_step_dag(n_layers, RStepCosts(**COSTS_KW),
                                      zero_sharded), link)
    return g, gr


def _op_fields(op):
    return (op.name, op.kind.value, op.flops, op.bytes_hbm, op.comm_bytes,
            op.comm_role.value, op.duration)


def _same_graph(g, gr):
    assert list(g.ops) == list(gr.ops)
    assert [_op_fields(o) for o in g.ops.values()] == \
        [_op_fields(o) for o in gr.ops.values()]
    assert g.preds == gr.preds
    assert g.succs == gr.succs


# -- the graph ----------------------------------------------------------------

@pytest.mark.parametrize("zero_sharded", [False, True])
def test_train_step_dag_is_the_reference(zero_sharded):
    g = train_step_dag(3, StepCosts(**COSTS_KW), zero_sharded)
    gr = r_train_step_dag(3, RStepCosts(**COSTS_KW), zero_sharded)
    _same_graph(g, gr)
    assert ("ag0" in g.ops) is zero_sharded
    assert g.topological_order() == gr.topological_order()


@pytest.mark.parametrize("zero_sharded", [False, True])
@pytest.mark.parametrize("link", [50e9, COSTS.LINK_BW])
def test_with_comm_durations_is_the_reference(zero_sharded, link):
    g, gr = _pair(3, zero_sharded, link)
    _same_graph(g, gr)
    durs = {n: o.duration for n, o in g.ops.items() if o.comm_bytes}
    assert durs == {n: o.duration for n, o in gr.ops.items()
                    if o.comm_bytes}
    assert set(durs) == {n for n in g.ops if n[:2] in ("rs", "ag")}
    assert durs["rs0"] == 2e-6 + COSTS_KW["grad_bytes"] / link


def test_train_step_dag_structure():
    costs = StepCosts(fwd_flops=1e12, bwd_flops=2e12, fwd_bytes=1e9,
                      bwd_bytes=2e9, grad_bytes=5e8)
    g = train_step_dag(3, costs)
    assert {"fwd0", "fwd1", "fwd2", "bwd0", "bwd1", "bwd2",
            "rs0", "rs1", "rs2", "opt"} <= set(g.ops)
    order = g.topological_order()
    assert order.index("fwd2") < order.index("bwd2")
    assert order.index("bwd2") < order.index("bwd1")
    assert g.preds["rs1"] == {"bwd1"}      # rs ops depend only on bwd
    assert "opt" in g.succs["rs0"]


def test_core_exports_the_step_dag():
    assert C.StepCosts is StepCosts
    assert C.train_step_dag is train_step_dag
    assert C.with_comm_durations is with_comm_durations


# -- makespans under the reference's machine ----------------------------------

@pytest.mark.parametrize("backend", ["sim", "vectorized"])
def test_every_schedule_of_two_layers_is_the_reference(backend):
    g, gr = _pair(2)
    scheds = list(C.enumerate_schedules(g, 2))
    r_scheds = list(RC.enumerate_schedules(gr, 2))
    assert len(scheds) == len(r_scheds) > 100
    got = E.make_evaluator(g, backend, machine=_ref_machine()) \
        .evaluate(scheds)
    want = RE.make_evaluator(gr, backend).evaluate(r_scheds)
    assert got == want
    assert len(set(got)) > 1


def test_vectorized_random_schedules_are_sim():
    """tests/test_engine_vectorized.py::test_stepdag_supported, on the
    port and under the H100 train-step machine."""
    g = train_step_dag(3, StepCosts(fwd_flops=1e12, bwd_flops=2e12,
                                    fwd_bytes=1e9, bwd_bytes=2e9,
                                    grad_bytes=5e8))
    m = COSTS.train_step_machine()
    rng = random.Random(0)
    scheds = [random_schedule(g, 2, rng) for _ in range(20)]
    ev = E.make_evaluator(g, "vectorized", machine=m)
    assert ev.evaluate(scheds) == [C.makespan(g, s, m) for s in scheds]


def test_train_step_search_through_a_two_host_fleet_is_sim():
    """qwen2.5-32b's train step at 4 stages under the H100 train-step
    machine, searched through two in-process evaluation servers: the
    times of local sim, bit for bit."""
    from repro_torch.search import MCTSSearch, run_search
    m = COSTS.train_step_machine()
    costs = COSTS.costs_from_arch("qwen2.5-32b", 4, tokens_per_chip=4096)
    g = with_comm_durations(train_step_dag(4, costs), COSTS.LINK_BW)
    run = dict(budget=60, batch_size=8, machine=m)
    ref = run_search(g, MCTSSearch(g, 2, seed=0), backend="sim", **run)
    servers = [E.EvalServer(g, machine=m).start() for _ in range(2)]
    try:
        res = run_search(g, MCTSSearch(g, 2, seed=0), backend="rpc",
                         backend_kwargs={"hosts": [s.addr for s in servers],
                                         "min_shard": 1, "deadline": 10.0,
                                         "connect_timeout": 5.0}, **run)
    finally:
        for s in servers:
            s.close()
    assert len(res.times) > 1 and res.times == ref.times


@pytest.mark.parametrize("backend,batch_size", [("sim", 1),
                                                ("vectorized", 16)])
def test_seeded_mcts_over_four_layers_is_the_reference(backend, batch_size):
    g, gr = _pair(4)
    res = run_search(g, MCTSSearch(g, 2, seed=0), budget=300,
                     batch_size=batch_size, backend=backend,
                     machine=_ref_machine())
    ref = RS.run_search(gr, RS.MCTSSearch(gr, 2, seed=0), budget=300,
                        batch_size=batch_size, backend=backend)
    assert res.times == ref.times
    assert [s.key() for s in res.schedules] == \
        [s.key() for s in ref.schedules]
    assert (res.cache_hits, res.cache_misses) == \
        (ref.cache_hits, ref.cache_misses)


def test_random_schedules_agree_with_the_reference():
    g, gr = _pair(3, zero_sharded=True)
    rng, r_rng = random.Random(4), random.Random(4)
    scheds = [random_schedule(g, 2, rng) for _ in range(30)]
    r_scheds = [r_random_schedule(gr, 2, r_rng) for _ in range(30)]
    assert [s.key() for s in scheds] == [s.key() for s in r_scheds]
    assert [C.makespan(g, s, _ref_machine()) for s in scheds] == \
        [RC.makespan(gr, s) for s in r_scheds]


# -- the search on H100 constants ---------------------------------------------

def test_stepdag_schedule_search_prefers_overlap():
    """tests/test_sharding_and_hlo.py's overlap case under the H100
    train-step machine: MCTS finds a schedule whose reduce-scatters
    overlap the backward chain on a second stream."""
    costs = StepCosts(fwd_flops=2e12, bwd_flops=4e12, fwd_bytes=1e9,
                      bwd_bytes=2e9, grad_bytes=2e9)
    m = COSTS.train_step_machine()
    g = with_comm_durations(train_step_dag(4, costs), m.link_bytes_per_s)
    res = run_search(g, MCTSSearch(g, 2, seed=0), budget=300,
                     batch_size=1, backend="sim", machine=m)
    best = res.schedules[int(np.argmin(res.times))]
    assert min(res.times) < max(res.times)       # schedule matters
    serial = sum(op.duration if op.duration is not None
                 else m.gpu_duration(op.flops, op.bytes_hbm)
                 for op in g.ops.values())
    assert min(res.times) < serial
    assert len(set(best.streams().values())) >= 2


def test_stepdag_rules_mention_overlap():
    costs = StepCosts(fwd_flops=2e12, bwd_flops=4e12, fwd_bytes=1e9,
                      bwd_bytes=2e9, grad_bytes=2e9)
    m = COSTS.train_step_machine()
    g = with_comm_durations(train_step_dag(2, costs), m.link_bytes_per_s)
    from repro_torch.rules import (algorithm1, extract_rulesets,
                                   label_times)
    scheds = list(C.enumerate_schedules(g, 2))
    times = np.array([C.makespan(g, s, m) for s in scheds])
    lab = label_times(times)
    assert lab.n_classes >= 2
    fm = C.featurize(g, scheds)
    tree = algorithm1(fm.X, lab.labels)
    rulesets = extract_rulesets(tree, fm.features)
    assert any("stream" in r.text() or "before" in r.text()
               for rs in rulesets for r in rs.rules)


# -- costs and constants ------------------------------------------------------

def test_train_step_machine_is_the_data_sheet_without_host_costs():
    m = COSTS.train_step_machine()
    assert (m.flops_per_s, m.hbm_bytes_per_s, m.link_bytes_per_s) == \
        (989e12, 3.35e12, 450e9)
    assert (m.launch_overhead_s, m.cpu_op_s, m.sync_op_s,
            m.comm_latency_s) == (0.0, 0.0, 0.0, 0.0)
    # Machine() is the SpMV program's (float32 CUDA cores): a tensor-core
    # op under it would take 989/67 = 14.8x longer.
    assert C.Machine().flops_per_s == 67e12
    assert m.gpu_duration(1e12, 0.0) * 989 / 67 == \
        pytest.approx(C.Machine().gpu_duration(1e12, 0.0), rel=1e-12)


_REF_EXAMPLE = None


def _ref_costs_from_arch(*args, **kw):
    global _REF_EXAMPLE
    if _REF_EXAMPLE is None:
        _REF_EXAMPLE = _load_example("schedule_search")
    return _REF_EXAMPLE.costs_from_arch(*args, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_costs_from_arch_is_the_reference(arch):
    for layers, tokens, tp, dp in ((4, 4096, 16, 16), (3, 8192, 8, 4)):
        got = COSTS.costs_from_arch(arch, layers, tokens, tp=tp, dp=dp)
        want = _ref_costs_from_arch(arch, layers, tokens, tp=tp, dp=dp)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_is_the_reference(arch):
    cfg, r_cfg = get_config(arch), ref_get_config(arch)
    cells = [s for s in SHAPES if ref_applicable(arch, s)]
    assert list(SHAPES) == list(REF_SHAPES) and cells
    for shape in cells:
        assert COSTS.model_flops(cfg, shape) == \
            RCOSTS.model_flops(r_cfg, shape)


ROOF_ARGS = dict(chips=16, hlo_flops_per_chip=3.1e15,
                 collective_bytes_per_chip=4.2e10,
                 memory_stats={"argument_size_in_bytes": 7e10,
                               "temp_size_in_bytes": 2.5e10,
                               "output_size_in_bytes": 6e9,
                               "alias_size_in_bytes": 5e9},
                 collective_bytes_f32=1.1e10)


@pytest.mark.parametrize("kind,shape", [("train", "train_4k"),
                                        ("serve", "prefill_32k"),
                                        ("serve", "decode_32k")])
def test_roofline_is_the_reference_scaled_by_the_constants(
        kind, shape, monkeypatch):
    arch = "qwen2.5-32b"
    ref = RCOSTS.roofline(ref_get_config(arch), shape, kind, **ROOF_ARGS)
    ours = COSTS.roofline(get_config(arch), shape, kind, **ROOF_ARGS)
    rd, od = ref.to_dict(), ours.to_dict()
    assert list(od) == list(rd)
    for k in ("model_flops", "hlo_flops_per_chip",
              "hlo_collective_bytes_per_chip",
              "mem_traffic_bytes_per_chip", "chips", "model_flops_ratio"):
        assert od[k] == rd[k]
    scale = {"compute_s": RCOSTS.PEAK_FLOPS / COSTS.PEAK_FLOPS,
             "memory_s": RCOSTS.HBM_BW / COSTS.HBM_BW,
             "collective_s": RCOSTS.LINK_BW / COSTS.LINK_BW,
             "collective_s_tpu": RCOSTS.LINK_BW / COSTS.LINK_BW}
    for k, f in scale.items():
        assert od[k] == pytest.approx(rd[k] * f, rel=1e-15)
    # Under the reference's constants, every term is the reference's.
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(COSTS, name, getattr(RCOSTS, name))
    same = COSTS.roofline(get_config(arch), shape, kind, **ROOF_ARGS)
    assert same.to_dict() == rd


def test_h100_constants_are_the_data_sheet():
    assert (COSTS.PEAK_FLOPS, COSTS.HBM_BW, COSTS.LINK_BW) == \
        (989e12, 3.35e12, 450e9)


# -- the example --------------------------------------------------------------

def test_schedule_search_example_runs_the_train_step_on_the_cpu():
    example = _load_example("torch_schedule_search")
    out = io.StringIO()
    with redirect_stdout(out):
        example.main(["--arch", "smollm-360m", "--layers", "2",
                      "--iters", "40"])
    text = out.getvalue()
    assert "train-step DAG for smollm-360m: 9 ops, 2 stages" in text
    assert "analytic model, not a measurement" in text
    assert "performance classes" in text


def test_schedule_search_example_refuses_wallclock_without_a_program():
    example = _load_example("torch_schedule_search")
    with pytest.raises(SystemExit):
        with redirect_stdout(io.StringIO()):
            example.main(["--layers", "2", "--backend", "wallclock"])
