"""The sharded program's values on a real mesh of 8 ranks.

``jit_train_step`` on a 2x4 (data, model) mesh of 8 gloo ranks on the
CPU, held to ``make_train_step`` on one process with the same seed and
batch: granite-3-8b reduced, heads padded to the model axis, f32
activations, labels with ignored (-1) positions. Both the cell's own
rules (data and tensor parallel) and the fused FSDP+TP rules (model-major
``_StridedShard`` parameters, gathered for compute), with and without the
gradient clip, with one and two microbatches. And the serve cell's
program (``serve_shardings``, sharded prefill and decode steps) against
``Engine.generate``. Every rank is a process of its own; the script runs
once per module.
"""
import itertools
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = [f"{rules}_clip{clip}_mb{mb}" for rules, clip, mb in
            itertools.product(("tp", "fsdp"), (1, 0), (1, 2))]

MESH = r"""
import dataclasses, itertools, json, sys, tempfile
import numpy as np
import torch, torch.distributed as dist, torch.multiprocessing as mp

ARCH = "granite-3-8b"


def work(rank, world, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    from repro_torch.configs import get_reduced
    from repro_torch.configs.shapes import SHAPES, ShapeCell
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.inputs import FSDP_RULES, cell_config, rules_for
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamW
    from repro_torch.serve.engine import (Engine, make_serve_step,
                                          serve_shardings)
    from repro_torch.train.step import (distribute_model, jit_train_step,
                                        make_train_step, place)
    mesh = make_local_mesh(2, 4)
    SHAPES["mesh_train"] = ShapeCell("mesh_train", 32, 8, "train")
    SHAPES["mesh_decode"] = ShapeCell("mesh_decode", 32, 8, "decode")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, (8, 32))
    labels = np.concatenate([tokens[:, 1:], rng.integers(0, 512, (8, 1))],
                            1)
    labels[rng.random(labels.shape) < 0.2] = -1
    batch = {"tokens": torch.from_numpy(tokens).int(),
             "labels": torch.from_numpy(labels).int()}
    cfg = dataclasses.replace(
        cell_config(ARCH, "mesh_train", mesh, base=get_reduced(ARCH)),
        dtype="float32")
    res = {}
    for fsdp, clip, mb in itertools.product((False, True), (1, 0), (1, 2)):
        rules = dict(rules_for(cfg, "train", mesh),
                     **(FSDP_RULES if fsdp else {}))
        plain = LM(cfg, device="cpu", seed=3)
        opt = AdamW(grad_clip_norm=1.0 if clip else None)
        pp = dict(plain.named_parameters())
        pp, po, pm = make_train_step(plain, opt, microbatches=mb)(
            pp, opt.init(pp), batch)
        model = LM(cfg, device="cpu", seed=3)
        step, (_, _, b_sh) = jit_train_step(model, opt, mesh, rules,
                                            microbatches=mb)
        dp = dict(model.named_parameters())
        dp, do, dm = step(dp, opt.init(dp),
                          {k: place(v, mesh, b_sh[k])
                           for k, v in batch.items()})
        mu_rel, p_abs, placements = {}, {}, set()
        for k, v in pp.items():
            placements.add(str(tuple(dp[k].placements)))
            p_abs[k] = (dp[k].full_tensor() - v).abs().max().item()
            ref = po["mu"][k]
            mu_rel[k] = ((do["mu"][k].full_tensor() - ref).abs().max() /
                         ref.abs().max().clamp_min(1e-30)).item()
        loss = dm["loss"]
        loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
        # After one step mu = (1 - b1) x the (clipped) gradient.
        gnorm = torch.sqrt(sum((m.double() ** 2).sum()
                               for m in po["mu"].values())).item() / \
            (1 - opt.b1)
        res[f"{'fsdp' if fsdp else 'tp'}_clip{clip}_mb{mb}"] = {
            "loss": [pm["loss"].item(), loss.item()], "mu_rel": mu_rel,
            "param_abs": p_abs, "gnorm": gnorm,
            "lr": opt.learning_rate, "placements": sorted(placements)}
    scfg = dataclasses.replace(
        cell_config(ARCH, "mesh_decode", mesh, base=get_reduced(ARCH)),
        dtype="float32", param_dtype="float32")
    rules = rules_for(scfg, "decode", mesh)
    prompts = torch.from_numpy(rng.integers(0, 512, (8, 12))).int()
    want = Engine(LM(scfg, device="cpu", seed=5), 32).generate(prompts, 6)
    model = LM(scfg, device="cpu", seed=5)
    p_sh, c_sh, tok_sh = serve_shardings(model, mesh, 8, 32, 0, rules)
    distribute_model(model, mesh, p_sh)
    prefill = shd.bound_to(
        lambda t: model.prefill(t, 32, attention="plain"), mesh, rules)
    step = shd.bound_to(make_serve_step(model), mesh, rules)
    logits, caches = prefill(place(prompts, mesh, tok_sh))
    tok = shd.gather_dim(logits[:, -1], 1).argmax(-1)[:, None]
    got = [tok]
    for i in range(5):
        tok, _, caches = step(caches, tok, 12 + i)
        got.append(tok)
    res["serve"] = {
        "want": want.tolist(),
        "got": torch.cat([t.full_tensor() for t in got], 1).tolist(),
        "cache_placements": str(tuple(caches[0]["k"].placements))}
    with open(f"{out}/{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    d = tempfile.mkdtemp()
    mp.spawn(work, args=(8, d + "/store", d), nprocs=8)
    print(json.dumps([json.load(open(f"{d}/{r}.json")) for r in range(8)]))
"""


@pytest.fixture(scope="module")
def ranks():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "mesh.py")
        with open(script, "w") as f:
            f.write(MESH)
        out = subprocess.run([sys.executable, script], env=env, cwd=tmp,
                             capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_loss_equals_make_train_step(ranks, variant):
    for res in ranks:
        plain, sharded = res[variant]["loss"]
        assert abs(sharded - plain) <= 1e-6 * abs(plain), (plain, sharded)


@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_gradient_equals_make_train_step(ranks, variant):
    # AdamW's first moment after one step is 0.1 x the clipped gradient:
    # each leaf within 5e-5 of its largest element (f32 sums in another
    # order over 8 ranks: 1.1e-5 at most here).
    worst = max(ranks[0][variant]["mu_rel"].items(), key=lambda kv: kv[1])
    assert worst[1] <= 5e-5, worst


@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_parameters_equal_make_train_step(ranks, variant):
    # Adam's first step moves an element by lr x g / (|g| + 1e-8): an
    # element whose gradient is within rounding of 1e-8 moves by a
    # different fraction of lr (3e-4). Every element within lr / 3.
    res = ranks[0][variant]
    worst = max(res["param_abs"].items(), key=lambda kv: kv[1])
    assert worst[1] <= res["lr"] / 3, worst


@pytest.mark.parametrize("variant", [v for v in VARIANTS if "mb1" in v])
def test_the_clip_acts(ranks, variant):
    clip, free = ranks[0][variant], ranks[0][variant.replace("clip1",
                                                             "clip0")]
    assert free["gnorm"] > 1.0
    if "clip1" in variant:
        assert clip["gnorm"] == pytest.approx(1.0, rel=1e-5)


def test_fsdp_runs_model_major_strided_shards(ranks):
    fsdp = ranks[0]["fsdp_clip1_mb1"]["placements"]
    tp = ranks[0]["tp_clip1_mb1"]["placements"]
    assert any("_StridedShard" in p for p in fsdp)
    assert not any("_StridedShard" in p for p in tp)


def test_sharded_decode_equals_engine_generate(ranks):
    for res in ranks:
        assert res["serve"]["got"] == res["serve"]["want"]
    assert np.asarray(ranks[0]["serve"]["want"]).shape == (8, 6)
    assert "Shard" in ranks[0]["serve"]["cache_placements"]
