"""The port's distribution layer against the reference's, on the CPU.

Sharding rules (``dist/sharding.py``) are held case by case to the
reference's ``PartitionSpec``s, translated to DTensor placements. The
compressed data-parallel sync and the elastic re-mesh run on 8 gloo
ranks (processes) beside the reference's 8-device ``shard_map``. The
production meshes and the dry run's cells (``launch/inputs.py``,
``launch/hlo.py``) run over PyTorch's ``fake`` process group, which is
process-global state, so every multi-rank check runs in a subprocess of
its own, each started once per module.
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.dist import sharding as ref_shd
from repro_torch.dist import sharding as shd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
NAMES = [None, "batch", "seq", "kv_seq", "heads", "kv_heads", "heads_x_dim",
         "d_ff", "d_inner", "vocab", "experts", "kv_stored", "head_dim",
         "d_model", "layers"]
OVERRIDES = [None, {"d_ff": ("model", "data"), "vocab": ("model", "data"),
                    "head_dim": "data"},
             {"kv_heads": None}, {"kv_seq": None, "batch": "data"},
             {"batch": ("pod", "data"), "experts": ("model", "data")}]


class RefMesh:
    """The reference's stand-in: axis_names and devices.shape."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


class PortMesh:
    """The port's stand-in: mesh_dim_names and shape."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = shape
        self.ndim = len(shape)


def _entries(spec: P) -> tuple:
    return tuple(spec)


def _run(code: str, env_extra: dict | None = None, timeout: int = 560):
    """Run ``code`` as a script (spawned ranks re-import it) in a fresh
    interpreter; its last stdout line is JSON."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "script.py")
        with open(script, "w") as f:
            f.write(code)
        out = subprocess.run([sys.executable, script], env=env, cwd=tmp,
                             capture_output=True, text=True,
                             timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# -- sharding rules ------------------------------------------------------------

def _cases(n: int = 240):
    rng = np.random.default_rng(20231)
    sizes = [1, 2, 3, 8, 15, 16, 24, 32, 48, 64, 128, 256, 512, 1024,
             4096, 5120, 27648]
    out = []
    for i in range(n):
        mesh = list(MESHES)[i % 2]
        ndim = int(rng.integers(1, 6))
        shape = tuple(int(rng.choice(sizes)) for _ in range(ndim))
        names = tuple(NAMES[int(rng.integers(0, len(NAMES)))]
                      for _ in range(ndim))
        rules = OVERRIDES[int(rng.integers(0, len(OVERRIDES)))]
        out.append((mesh, shape, names, rules))
    return out


CASES = _cases()


def test_at_least_200_seeded_cases_over_both_meshes():
    assert len(CASES) >= 200
    assert {c[0] for c in CASES} == set(MESHES)
    assert sum(c[3] is not None for c in CASES) > 100


@pytest.mark.parametrize("chunk", range(8))
def test_spec_for_equals_the_reference(chunk):
    for mesh, shape, names, rules in CASES[chunk::8]:
        dims, axes = MESHES[mesh]
        ref = ref_shd.spec_for(shape, names, RefMesh(dims, axes), rules)
        port = shd.spec_entries(shape, names, PortMesh(dims, axes), rules)
        assert port == _entries(ref), (mesh, shape, names, rules)
        pl = shd.spec_for(shape, names, PortMesh(dims, axes), rules)
        assert pl == shd.placements_of(_entries(ref), PortMesh(dims, axes))


def test_placements_translate_the_reference_entries():
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    m = PortMesh((16, 16), ("data", "model"))
    assert shd.placements_of(("model",), m) == (Replicate(), Shard(0))
    assert shd.placements_of((None, ("model", "data")), m) == \
        (_StridedShard(1, split_factor=16), Shard(1))
    m3 = PortMesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.placements_of((("pod", "data"), None, "model"), m3) == \
        (Shard(0), Shard(0), Shard(2))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("extra", [0, 1, 2])
@pytest.mark.parametrize("rules", OVERRIDES[:4])
def test_batch_spec_equals_the_reference(mesh, extra, rules):
    dims, axes = MESHES[mesh]
    for bs in (None, 1, 8, 16, 32, 256, 257):
        ref = ref_shd.batch_spec(RefMesh(dims, axes), extra, rules, bs)
        port = shd.batch_entries(PortMesh(dims, axes), extra, rules, bs)
        assert port == _entries(ref), (bs, rules)
        assert shd.batch_spec(PortMesh(dims, axes), extra, rules, bs) == \
            shd.placements_of(_entries(ref), PortMesh(dims, axes))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tree_shardings_equal_the_reference(mesh):
    import torch

    # The reference's tree_shardings wraps spec_for (held above) in
    # NamedShardings of a real jax Mesh; here the port's tree walk is
    # held to the reference's spec_for leaf by leaf.
    dims, axes = MESHES[mesh]
    shapes, ax = {}, {}
    for i, (_, shape, names, _) in enumerate(CASES[:60]):
        shapes[f"l{i}"] = shape
        ax[f"l{i}"] = names if i % 7 else None
    rules = OVERRIDES[1]
    port = shd.tree_shardings(
        {"a": ax, "b": [ax["l1"], None]}, PortMesh(dims, axes), rules,
        {"a": {k: torch.empty(s, device="meta") for k, s in shapes.items()},
         "b": [torch.empty(shapes["l1"], device="meta"),
               torch.empty(shapes["l2"], device="meta")]})
    for k, s in shapes.items():
        names = ax[k] if ax[k] is not None else (None,) * len(s)
        want = ref_shd.spec_for(s, names, RefMesh(dims, axes), rules)
        assert port["a"][k] == shd.placements_of(_entries(want),
                                                 PortMesh(dims, axes))
    assert port["b"][1] == shd.placements_of((), PortMesh(dims, axes))
    with pytest.raises(ValueError):
        shd.tree_shardings({"x": None}, PortMesh(dims, axes), None,
                           {"y": torch.empty(2, device="meta")})


# The six cases of tests/test_sharding_and_hlo.py, in the port's terms.

def test_spec_for_basic_mapping():
    mesh = PortMesh((16, 16), ("data", "model"))
    assert shd.spec_entries((1024, 4096), ("vocab", "d_model"), mesh) == \
        ("model",)


def test_spec_for_drops_nondivisible():
    mesh = PortMesh((16, 16), ("data", "model"))
    assert shd.spec_entries((960, 15, 64),
                            ("d_model", "heads", "head_dim"), mesh) == ()


def test_spec_for_axis_used_once():
    mesh = PortMesh((16, 16), ("data", "model"))
    assert shd.spec_entries((256, 4096, 64, 128),
                            ("batch", "kv_seq", "kv_stored", "head_dim"),
                            mesh) == ("data", None, "model")


def test_spec_for_multi_axis_dims():
    mesh = PortMesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.spec_entries((256, 4096), ("batch", "seq"), mesh,
                            rules={"batch": ("pod", "data")}) == \
        (("pod", "data"),)
    mesh1 = PortMesh((16, 16), ("data", "model"))
    assert shd.spec_entries((256, 4096), ("batch", "seq"), mesh1,
                            rules={"batch": ("pod", "data")}) == ("data",)


def test_spec_for_fsdp_fused_dims():
    mesh = PortMesh((16, 16), ("data", "model"))
    assert shd.spec_entries((5120, 27648), ("d_model", "d_ff"), mesh,
                            rules={"d_ff": ("model", "data")}) == \
        (None, ("model", "data"))


def test_constrain_noop_without_context():
    import torch

    x = torch.ones((4, 4))
    assert shd.constrain(x, ("batch", "seq")) is x
    assert shd.unshard_grad(x, 0) is x
    assert torch.equal(shd.zeros((2, 3), ("batch", None),
                                 dtype=torch.float32, device="cpu"),
                       torch.zeros(2, 3))


def test_activation_contexts_nest():
    a, b = PortMesh((2, 4), ("data", "model")), PortMesh((1, 1),
                                                         ("data", "model"))
    assert shd.current() is None
    with shd.activation_sharding(a, {"x": 1}):
        with shd.activation_sharding(b, None):
            assert shd.current() == (b, None)
        assert shd.current() == (a, {"x": 1})
    assert shd.current() is None


# -- compressed sync and elastic re-mesh on 8 ranks ----------------------------

GLOO = r"""
import json, sys, tempfile
import numpy as np
import torch, torch.distributed as dist, torch.multiprocessing as mp

def work(rank, world, store, out):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.dist.compress import (compressed_psum_mean, init_ef,
                                           psum_mean)
    from repro_torch.dist.sharding import tree_shardings
    from repro_torch.ft.elastic import degraded_mesh, remesh_state
    g = np.random.default_rng(0).standard_normal((2, world, 64))
    g = g.astype(np.float32)
    grads = {"w": torch.from_numpy(g[0, rank].copy()),
             "n": {"b": torch.from_numpy(g[1, rank, :16].copy())}}
    synced, ef = compressed_psum_mean(grads, init_ef(grads))
    synced2, ef2 = compressed_psum_mean(grads, ef)
    exact = psum_mean(grads)
    res = {"synced": synced["w"].tolist(), "ef": ef["w"].tolist(),
           "synced_b": synced["n"]["b"].tolist(), "ef_b": ef["n"]["b"].tolist(),
           "synced2": synced2["w"].tolist(), "ef2": ef2["w"].tolist(),
           "exact": exact["w"].tolist(),
           "untouched": bool(torch.equal(grads["w"],
                                         torch.from_numpy(g[0, rank])))}
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(4, 2),
                      mesh_dim_names=("data", "model"))
    full = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    axes = {"w": ("batch", "d_ff")}
    pl = tree_shardings(axes, mesh, None, {"w": full})
    state = {"w": distribute_tensor(full, mesh, list(pl["w"]))}
    new = degraded_mesh(mesh, ("data", "model"), lost=2)
    res["new_shape"] = list(new.mesh.shape)
    res["new_names"] = list(new.mesh_dim_names)
    res["new_device_type"] = new.device_type
    out_state = remesh_state(state, axes, new)
    if rank < 6:
        res["remesh_equal"] = bool(torch.equal(out_state["w"].full_tensor(),
                                               full))
        res["local_rows"] = out_state["w"].to_local().shape[0]
    with open(f"{out}/{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()

if __name__ == "__main__":
    d = tempfile.mkdtemp()
    mp.spawn(work, args=(8, d + "/store", d), nprocs=8)
    print(json.dumps([json.load(open(f"{d}/{r}.json")) for r in range(8)]))
"""

REF_COMPRESS = r"""
import json, functools
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.dist.compat import shard_map
from repro.dist.compress import compressed_psum_mean, init_ef, psum_mean
mesh = Mesh(np.array(jax.devices()), ("data",))
g = np.random.default_rng(0).standard_normal((2, 8, 64)).astype(np.float32)

@functools.partial(shard_map, mesh=mesh,
                   in_specs=(P("data"), P("data"), P("data")),
                   out_specs=(P("data"),) * 7, check_vma=False)
def sync(w, b, e):
    grads = {"w": w[0], "n": {"b": b[0]}}
    out, new_e = compressed_psum_mean(grads, init_ef(grads), "data")
    out2, new_e2 = compressed_psum_mean(grads, new_e, "data")
    exact = psum_mean(grads, "data")
    return (out["w"][None], new_e["w"][None], out["n"]["b"][None],
            new_e["n"]["b"][None], out2["w"][None], new_e2["w"][None],
            exact["w"][None])

outs = sync(jnp.asarray(g[0]), jnp.asarray(g[1, :, :16]),
            jnp.zeros((8, 64), jnp.float32))
keys = ("synced", "ef", "synced_b", "ef_b", "synced2", "ef2", "exact")
print(json.dumps({k: np.asarray(v).tolist() for k, v in zip(keys, outs)}))
"""


@pytest.fixture(scope="module")
def gloo_ranks():
    return _run(GLOO)


@pytest.fixture(scope="module")
def ref_compress():
    return _run(REF_COMPRESS, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "JAX_PLATFORMS": "cpu"})


@pytest.mark.parametrize("key", ["synced", "ef", "synced_b", "ef_b",
                                 "synced2", "ef2", "exact"])
def test_compressed_psum_mean_equals_the_reference_on_8_ranks(
        gloo_ranks, ref_compress, key):
    ref = np.asarray(ref_compress[key])
    for rank, res in enumerate(gloo_ranks):
        got = np.asarray(res[key])
        np.testing.assert_allclose(got, ref[rank], rtol=0, atol=1e-6,
                                   err_msg=f"{key} rank {rank}")


def test_compressed_sync_error_is_bounded_and_carried(gloo_ranks):
    res = gloo_ranks[0]
    exact, got = np.asarray(res["exact"]), np.asarray(res["synced"])
    assert np.abs(got - exact).max() / np.abs(exact).max() < 1e-2
    assert np.abs(np.asarray(res["ef"])).max() > 0
    assert all(r["untouched"] for r in gloo_ranks)


def test_degraded_mesh_keeps_the_trailing_axis(gloo_ranks):
    assert all(r["new_shape"] == [3, 2] for r in gloo_ranks)
    assert all(r["new_names"] == ["data", "model"] for r in gloo_ranks)


def test_remesh_state_keeps_values_exactly(gloo_ranks):
    assert all(r["remesh_equal"] for r in gloo_ranks[:6])
    # 16 rows over 3 data ranks do not divide: the rules engine
    # replicates the batch dimension instead of failing.
    assert all(r["local_rows"] == 16 for r in gloo_ranks[:6])


def test_degraded_mesh_keeps_the_old_mesh_device_type(gloo_ranks):
    assert all(r["new_device_type"] == "cpu" for r in gloo_ranks)


@pytest.mark.parametrize("build", ["production", "production_multi_pod",
                                   "local", "degraded"])
def test_meshes_default_to_the_card(build, monkeypatch):
    """As the reference builds its meshes on the default backend's
    devices, a mesh built without a device type is on the cards: on a
    machine without one it raises before any mesh (or group) exists,
    and is never a CPU mesh."""
    import torch

    from repro_torch.ft.elastic import degraded_mesh
    from repro_torch.launch.mesh import (make_local_mesh,
                                         make_production_mesh)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"production": make_production_mesh,
          "production_multi_pod": lambda: make_production_mesh(
              multi_pod=True),
          "local": lambda: make_local_mesh(1, 1),
          "degraded": lambda: degraded_mesh(np.arange(8).reshape(4, 2),
                                            ("data", "model"), lost=2)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn[build]()


def test_degraded_mesh_refuses_an_empty_mesh():
    from repro_torch.ft.elastic import degraded_mesh

    with pytest.raises(ValueError, match="not enough devices"):
        degraded_mesh(np.arange(8).reshape(4, 2), ("data", "model"), lost=7)


# -- production meshes and the dry run's cells over a fake group -----------------

PORT_CELLS = r"""
import json
from repro_torch.configs.shapes import SHAPES, ShapeCell
for s in (64, 1024):
    SHAPES[f"tiny_train_{s}"] = ShapeCell(f"tiny_train_{s}", s, 8, "train")
    SHAPES[f"tiny_prefill_{s}"] = ShapeCell(f"tiny_prefill_{s}", s, 8,
                                            "prefill")
    SHAPES[f"tiny_decode_{s}"] = ShapeCell(f"tiny_decode_{s}", s, 8,
                                           "decode")
import torch.distributed as dist
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun, hlo
from repro_torch.launch.inputs import build_cell, cell_config
from repro_torch.launch.mesh import make_production_mesh
dryrun.quiet()
out = {"meshes": []}
for multi_pod in (False, True):
    m = dryrun.fake_mesh(multi_pod)
    out["meshes"].append([list(m.mesh.shape), list(m.mesh_dim_names),
                          dist.get_world_size()])
dist.destroy_process_group()
mesh = dryrun.fake_mesh(False, (2, 4))
arch = "granite-3-8b"
for s in (64, 1024):
    for kind in ("train", "prefill", "decode"):
        shape = f"tiny_{kind}_{s}"
        cfg = cell_config(arch, shape, mesh, base=get_reduced(arch))
        cell = build_cell(arch, shape, mesh, cfg=cfg)
        a, _ = hlo.analyze(cell.fn, *cell.args, mesh=mesh,
                           counter=cell.counter)
        out[shape] = {"args": a.memory["argument_size_in_bytes"],
                      "flops": a.dot_flops, "heads": cfg.n_heads_padded,
                      "head_dim": cfg.head_dim, "layers": cfg.n_layers,
                      "d_model": cfg.d_model,
                      "vocab": dict(cell.model.named_parameters())[
                          "embed.tokens"].shape[0],
                      "bytes": a.collective_bytes,
                      "axis": a.collective_bytes_by_axis}
for limit in (True, False):
    cfg = cell_config(arch, "tiny_train_64", mesh, base=get_reduced(arch))
    cell = build_cell(arch, "tiny_train_64", mesh, cfg=cfg, microbatches=2,
                      count_one_microbatch=limit)
    a, _ = hlo.analyze(cell.fn, *cell.args, mesh=mesh, counter=cell.counter)
    out[f"mb2_{limit}"] = {"flops": a.dot_flops,
                           "bytes": a.collective_bytes,
                           "count": a.collective_count,
                           "axis": a.collective_bytes_by_axis,
                           "trips": a.loop_trips,
                           "run": cell.meta["microbatches_run"]}
print(json.dumps(out))
"""

REF_AXIS = r"""
# The replica groups of the 2x4 mesh's two axes, in both of XLA's forms.
AXIS = {"[2,4]<=[8]": "model", "{{0,1,2,3},{4,5,6,7}}": "model",
        "[4,2]<=[2,4]T(1,0)": "data", "{{0,4},{1,5},{2,6},{3,7}}": "data"}


def bytes_by_axis(text):
    # The analyzer's collective loop (operand bytes, loop-multiplied),
    # keyed by the mesh axis of each collective's replica groups.
    comps = H.parse_module(text)
    mult = H._multipliers(comps)
    out = {}
    for comp in comps.values():
        m = mult.get(comp.name, 0.0) or (1.0 if comp.is_entry else 0.0)
        for ins in comp.instructions.values():
            if not any(ins.opcode.startswith(k) for k in H.COLLECTIVES):
                continue
            ob = sum(H._shape_bytes(comp.instructions[o].type_str)
                     for o in re.findall(r"%([\w.\-]+)", ins.text)
                     if o in comp.instructions)
            g = re.search(r"replica_groups=(\S+?)(,\s|$)", ins.text)
            if g:
                axis = AXIS[g.group(1)]
            else:   # a collective-permute: pairs within a row of 4 move
                # along the model axis
                pairs = re.findall(r"\{(\d+),(\d+)\}", ins.text.split(
                    "source_target_pairs=")[1].split("}}")[0] + "}")
                axis = "model" if all(int(a) // 4 == int(b) // 4
                                      for a, b in pairs) else "data"
            out[axis] = out.get(axis, 0.0) + m * ob
    return out

"""

REF_CELLS = r"""
import json, re
import numpy as np, jax
from jax.sharding import Mesh
import repro.launch.inputs as inputs
import repro.configs as cfgs
from repro.launch import hlo as H
from repro.configs.shapes import SHAPES, ShapeCell
for s in (64, 1024):
    SHAPES[f"tiny_train_{s}"] = ShapeCell(f"tiny_train_{s}", s, 8, "train")
    SHAPES[f"tiny_prefill_{s}"] = ShapeCell(f"tiny_prefill_{s}", s, 8,
                                            "prefill")
    SHAPES[f"tiny_decode_{s}"] = ShapeCell(f"tiny_decode_{s}", s, 8,
                                           "decode")
cfgs.get_config = lambda name: cfgs.get_reduced(name)
inputs.cfgs = cfgs
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
""" + REF_AXIS + r"""

out = {}
for s in (64, 1024):
    for kind in ("train", "prefill", "decode"):
        shape = f"tiny_{kind}_{s}"
        cell = inputs.build_cell("granite-3-8b", shape, mesh)
        c = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings).lower(
                        *cell.args).compile()
        a = H.analyze(c.as_text())
        out[shape] = {"args": c.memory_analysis().argument_size_in_bytes,
                      "flops": a.dot_flops, "bytes": a.collective_bytes,
                      "f32": a.collective_bytes_f32,
                      "axis": bytes_by_axis(c.as_text())}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def port_cells():
    return _run(PORT_CELLS)


@pytest.fixture(scope="module")
def ref_cells():
    return _run(REF_CELLS, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "JAX_PLATFORMS": "cpu"})


def test_production_meshes_over_a_fake_group(port_cells):
    assert port_cells["meshes"] == [
        [[16, 16], ["data", "model"], 256],
        [[2, 16, 16], ["pod", "data", "model"], 512]]


CELLS = [f"tiny_{k}_{s}" for s in (64, 1024)
         for k in ("train", "prefill", "decode")]


@pytest.mark.parametrize("shape", CELLS)
def test_cell_argument_bytes_equal_the_reference(port_cells, ref_cells,
                                                 shape):
    assert port_cells[shape]["args"] == ref_cells[shape]["args"]


@pytest.mark.parametrize("shape", [c for c in CELLS if c.endswith("1024")
                                   or "decode" in c])
def test_cell_dot_flops_within_5_percent_of_the_reference(
        port_cells, ref_cells, shape):
    port, ref = port_cells[shape]["flops"], ref_cells[shape]["flops"]
    assert abs(port - ref) <= 0.05 * ref, (port, ref)


# Collective bytes against the reference's compiled program. XLA on the
# CPU all-reduces bf16 activations in f32 (every f32 byte in
# ``collective_bytes_f32``); the reference's own TPU adjustment
# (``collective_s_tpu``) halves them. The serve cells' collectives and the
# train cells' on the model axis are such activations; the gradient
# reductions on the data axis are f32 in both programs. Each gap is
# recorded in ROADMAP Queue 3.

@pytest.mark.parametrize("shape", [c for c in CELLS if "train" not in c])
def test_serve_cell_all_reduce_bytes_equal_the_reference(
        port_cells, ref_cells, shape):
    port, ref = port_cells[shape]["bytes"], ref_cells[shape]["bytes"]
    assert ref_cells[shape]["f32"] >= ref["all-reduce"] > 0
    assert port["all-reduce"] == ref["all-reduce"] / 2
    for kind in ("reduce-scatter", "all-to-all", "collective-permute"):
        assert port[kind] == ref[kind] == 0, kind
    if "prefill" in shape:
        assert port["all-gather"] == ref["all-gather"] == 0


@pytest.mark.parametrize("s", [64, 1024])
def test_decode_gathers_each_shard_s_argmax_pair_as_the_reference(
        port_cells, ref_cells, s):
    # The serve step's argmax all-gathers each vocab shard's (max,
    # index) pair, 4 local rows x (4 + 4) B, as XLA's program does.
    port = port_cells[f"tiny_decode_{s}"]["bytes"]["all-gather"]
    assert port == ref_cells[f"tiny_decode_{s}"]["bytes"]["all-gather"] \
        == (8 // 2) * (4 + 4)


@pytest.mark.parametrize("s", [64, 1024])
def test_train_cell_gradient_reductions_equal_the_reference(
        port_cells, ref_cells, s):
    port = port_cells[f"tiny_train_{s}"]["axis"]["data"]
    ref = ref_cells[f"tiny_train_{s}"]["axis"]["data"]
    assert abs(port - ref) <= 1e-3 * ref, (port, ref)


@pytest.mark.parametrize("s", [64, 1024])
def test_train_cell_model_axis_bytes_against_the_reference(
        port_cells, ref_cells, s):
    # The gap: in the backward XLA all-reduces the input gradients of a
    # layer's parallel branches one by one (the MLP's wi and wg, two
    # residual-sized; the attention's q, one, and its k and v, half a
    # residual each), 4 residuals a layer; DTensor adds the Partial sums
    # first and reduces once a branch group (2 residuals) and all-gathers
    # the local heads of the k and v gradients (a quarter each): 1.5
    # residual-sized (4 x S x d_model bf16) all-reduces a layer fewer.
    # Within 1%: the loss's three f32 reductions, which the reference's
    # adjustment halves too, and the norms' gradients.
    c = port_cells[f"tiny_train_{s}"]
    residual = (8 // 2) * s * c["d_model"] * 2
    want = ref_cells[f"tiny_train_{s}"]["axis"]["model"] / 2 - \
        1.5 * residual * c["layers"]
    assert abs(c["axis"]["model"] - want) <= 0.01 * want, \
        (c["axis"]["model"], want)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_short_cells_differ_by_the_reference_s_padded_keys(
        port_cells, ref_cells, kind):
    # At S = 64 the reference pads keys and values to its block of 1024
    # (repro/models/attention.py:146-152) and scores every padded key;
    # the port's last block is short. A forward pass's extra dots are
    # exactly 4 x b x (heads per device) x S x (1024 - S) x head_dim a
    # layer. A train step repeats them in the layer's and the block's
    # remat and in the backward, where XLA slices some of the padded
    # rows away first: between 4 and 5 forward passes' worth.
    c = port_cells[f"tiny_{kind}_64"]
    b, heads = 8 // 2, c["heads"] // 4
    pad = 4 * b * heads * 64 * (1024 - 64) * c["head_dim"] * c["layers"]
    gap = ref_cells[f"tiny_{kind}_64"]["flops"] - c["flops"]
    if kind == "prefill":
        assert gap == pad
    else:
        assert 4 * pad <= gap <= 5 * pad, (gap, pad)


def test_scaled_microbatch_count_equals_the_full_loop(port_cells):
    one, full = port_cells["mb2_True"], port_cells["mb2_False"]
    assert (one["run"], full["run"]) == (1, 2)
    assert one["trips"] == [2] and full["trips"] == []
    assert one["flops"] == full["flops"] > 0
    assert one["bytes"] == full["bytes"]
    assert one["count"] == full["count"]
    assert one["axis"] == full["axis"]


# -- the non-dense families' cells -------------------------------------------------

PORT_FAMILY_CELLS = r"""
import dataclasses, json
from repro_torch.configs.shapes import SHAPES, ShapeCell
for s, kinds in ((96, ("train", "prefill")), (1024, ("train",))):
    for kind in kinds:
        SHAPES[f"tiny_{kind}_{s}"] = ShapeCell(f"tiny_{kind}_{s}", s, 8,
                                               kind)
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun, hlo
from repro_torch.launch.inputs import build_cell, cell_config
dryrun.quiet()
mesh = dryrun.fake_mesh(False, (2, 4))


def count(arch, shape, dispatch=None, **kw):
    base = get_reduced(arch)
    if dispatch:
        base = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, dispatch=dispatch))
    cfg = cell_config(arch, shape, mesh, base=base)
    cell = build_cell(arch, shape, mesh, cfg=cfg, **kw)
    a, _ = hlo.analyze(cell.fn, *cell.args, mesh=mesh, counter=cell.counter)
    return {"flops": a.dot_flops, "bytes": a.collective_bytes,
            "count": a.collective_count, "trips": a.loop_trips,
            "axis": a.collective_bytes_by_axis,
            "args": a.memory["argument_size_in_bytes"],
            "temp": a.memory["temp_size_in_bytes"],
            "one_chunk": cell.meta["count_one_chunk"]}


out = {}
for kind in ("train", "prefill"):
    for one in (True, False):
        out[f"jamba_{kind}_{one}"] = count("jamba-v0.1-52b", f"tiny_{kind}_96",
                                           count_one_chunk=one)
out["deepseek"] = count("deepseek-moe-16b", "tiny_train_1024")
out["deepseek_gather"] = count("deepseek-moe-16b", "tiny_train_1024",
                               dispatch="gather")
print(json.dumps(out))
"""

REF_FAMILY_CELLS = r"""
import dataclasses, json, re
import numpy as np, jax
from jax.sharding import Mesh
import repro.launch.inputs as inputs
import repro.configs as cfgs
from repro.launch import hlo as H
from repro.configs.shapes import SHAPES, ShapeCell
SHAPES["tiny_train_1024"] = ShapeCell("tiny_train_1024", 1024, 8, "train")
inputs.cfgs = cfgs
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
""" + REF_AXIS + r"""
out = {}
for key, dispatch in (("deepseek", "einsum"), ("deepseek_gather", "gather")):
    def reduced(name, dispatch=dispatch):
        cfg = cfgs.get_reduced(name)
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
    cfgs.get_config = reduced
    cell = inputs.build_cell("deepseek-moe-16b", "tiny_train_1024", mesh)
    c = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                out_shardings=cell.out_shardings).lower(*cell.args).compile()
    a = H.analyze(c.as_text())
    out[key] = {"args": c.memory_analysis().argument_size_in_bytes,
                "flops": a.dot_flops, "bytes": a.collective_bytes,
                "axis": bytes_by_axis(c.as_text())}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def port_family_cells():
    return _run(PORT_FAMILY_CELLS)


@pytest.fixture(scope="module")
def ref_family_cells():
    return _run(REF_FAMILY_CELLS, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "JAX_PLATFORMS": "cpu"})


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_mamba_counted_on_one_chunk_equals_the_full_loop(port_family_cells,
                                                         kind):
    """jamba reduced at S = 96 (three Mamba chunks of 32 steps) on 2x4:
    the dry run's count, which runs the first chunk and the second for
    the other two, against all three chunks run (the same dot FLOPs,
    collectives and arguments); its temporaries hold the skipped chunk's
    state, allocated but not computed, within 1% (measured 0.47%: the
    stand-in is allocated before the chunk it stands for runs)."""
    one = port_family_cells[f"jamba_{kind}_True"]
    full = port_family_cells[f"jamba_{kind}_False"]
    assert one["one_chunk"] and not full["one_chunk"]
    assert one["trips"] == [2] and full["trips"] == []
    assert one["flops"] == full["flops"] > 0
    for key in ("bytes", "count", "args"):
        assert one[key] == full[key], key
    assert abs(one["temp"] - full["temp"]) <= 0.01 * full["temp"]


def test_moe_train_cell_against_the_reference(port_family_cells,
                                              ref_family_cells):
    """deepseek-moe-16b reduced, a train step of 8 x 1,024 tokens on
    2x4, against the reference's compiled program: argument bytes exact,
    and dot FLOPs exactly the reference's less one recorded difference
    (ROADMAP Queue 3). Equal: the local experts' products on each data
    shard's own tokens, forward, recomputed and backward, and a layer
    checkpoint whose recomputation runs neither the routed combine nor
    the shared experts' output projection, as XLA drops both. The
    difference: the top-k weights' gradient through the combine tensor
    (B, S, E, C). The reference's transpose contracts the local experts
    in one dot and the capacity slots in a second, 2 x B x S x k x C a
    MoE layer; torch's einsum backward contracts the slots in its
    product and the two local experts in an elementwise sum. The same
    values: each sum has one nonzero term, a one-hot's."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.moe import _capacity

    port, ref = port_family_cells["deepseek"], ref_family_cells["deepseek"]
    assert port["args"] == ref["args"]
    cfg = get_reduced("deepseek-moe-16b")
    s, b_local = 1024, 8 // 2
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    slots_dot = 2 * b_local * s * cfg.moe.top_k * _capacity(s, cfg.moe) * \
        moe_layers
    assert port["flops"] == ref["flops"] - slots_dot, \
        (port["flops"], ref["flops"], slots_dot)


def test_moe_train_cell_gradient_reductions_equal_the_reference(
        port_family_cells, ref_family_cells):
    """The deepseek cell's collective bytes over the data axis within
    1e-3 of the reference's, as the granite train cells': each weight
    gradient's reduction, the local experts' and the router's each model
    shard's own columns, and no gather of the expert operands over the
    data axis. Measured 196 B above the reference's 1,153,344: the port all-reduces
    the load-balance loss's two expert statistics whole (8 floats) in
    the forward and in the recomputation, the reference each model
    shard's 2 floats and one of them again, and the loss's scalars in
    one all-reduce where the reference has four."""
    port = port_family_cells["deepseek"]["axis"]["data"]
    ref = ref_family_cells["deepseek"]["axis"]["data"]
    assert abs(port - ref) <= 1e-3 * ref, (port, ref)


def test_moe_gather_train_cell_against_the_reference(port_family_cells,
                                                     ref_family_cells):
    """The same cell with the gather dispatch: each device adds its own
    experts' weighted slots back to their tokens, a partial sum reduced
    over the experts axis as the combine einsum's is
    (``moe._add_to_tokens``). Argument
    bytes and dot FLOPs exactly the reference's (no einsum, so no
    recorded difference). The data axis carries 261,948 B fewer: the
    routing probabilities, (B, S, E) f32, which XLA's program gathers
    over the data axis at top_k in the forward and the recomputation
    (262,144 B a layer, as DTensor's reduce-scatter of their gradient in
    the einsum cell), here 131,072 B a layer; less the 196 B of
    statistics and scalars of the einsum cell."""
    port = port_family_cells["deepseek_gather"]
    ref = ref_family_cells["deepseek_gather"]
    assert port["args"] == ref["args"]
    assert port["flops"] == ref["flops"], (port["flops"], ref["flops"])
    gap = ref["axis"]["data"] - port["axis"]["data"]
    assert gap == 2 * (262_144 - 131_072) - 196, gap
