"""Children that card tests run in processes of their own, each of which
makes a default process group. Run from the repository root:

  python tests/card_child.py dist_card
      the 1x1-mesh train cell of the reduced qwen2.5-32b config and the
      compressed gradient sync on a one-rank NCCL group
  python tests/card_child.py shard RANK WORLD PORT N NNZ
      one rank of the distributed SpMV on card RANK of an NCCL group of
      WORLD

Each prints its result as one JSON line, last; a failed check raises.
``tests/test_torch_cuda.py`` reads the lines.
"""
from __future__ import annotations

import json
import os
import statistics
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The train cell: one sequence of ``seq`` lm_batch tokens from seed 0.
DIST = {"arch": "qwen2.5-32b", "batch": 1, "seq": 64, "seed": 0}
# Predicted (meta device, the dry run's analyzer) against counted
# (FlopCounterMode over the step) dot FLOPs, relative.
DIST_FLOPS_TOL = 1e-3
# The distributed step against make_train_step: bit for bit is what a
# 1x1 mesh should give (every collective is over one rank); the gate
# allows 1e-6 of max |value| per tensor.
DIST_STEP_RTOL = 1e-6
# A shard window is a fixed count of steps, so that every rank makes as
# many exchanges.
SHARD_SAMPLES = 200


def dist_card(dev, backend: str = "nccl") -> dict:
    """build_cell/jit_train_step of the reduced config on a 1x1 mesh over
    a one-rank ``backend`` group: predicted on the meta device, then two
    steps, the first held to make_train_step's on the same device and
    inputs within DIST_STEP_RTOL, the second's dot FLOPs
    (FlopCounterMode) to the prediction's within DIST_FLOPS_TOL; then
    compressed_psum_mean over that group on one layer's gradients, bit
    for bit the CPU's over a gloo group (two rounds: the residual
    carried)."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_reduced
    from repro_torch.configs.shapes import SHAPES, ShapeCell
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.dist.compress import compressed_psum_mean, init_ef
    from repro_torch.launch import hlo
    from repro_torch.launch.inputs import build_cell
    from repro_torch.launch.mesh import free_port, make_local_mesh
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import make_train_step, place

    dist.init_process_group(backend,
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    mesh = make_local_mesh(1, 1, device_type=dev.type)
    cfg = get_reduced(DIST["arch"])
    SHAPES["card_train"] = ShapeCell("card_train", DIST["seq"],
                                     DIST["batch"], "train")
    dcfg = DataConfig(seed=DIST["seed"], seq_len=DIST["seq"],
                      global_batch=DIST["batch"], vocab=cfg.vocab)

    # 1. The prediction: the cell on the meta device, nothing allocated.
    cell = build_cell(DIST["arch"], "card_train", mesh, cfg=cfg,
                      device="meta", microbatches=1)
    pred, _ = hlo.analyze(cell.fn, *cell.args, mesh=mesh,
                          counter=cell.counter)
    del cell

    # 2. make_train_step on the same device, seed and batch.
    model = LM(cfg, device=dev, seed=DIST["seed"])
    opt = AdamW()
    step = make_train_step(model, opt)
    params = dict(model.named_parameters())
    params, _, met = step(params, opt.init(params), lm_batch(dcfg, 0))
    plain_loss = met["loss"].detach().cpu()
    plain = {k: p.detach().cpu() for k, p in params.items()}
    del model, step, params, met

    # 3. The distributed step: build_cell's parameters drawn on the
    # device, the batch placed. The first step is held to
    # make_train_step's; the second is counted by FlopCounterMode (under
    # a dispatch mode some ops round differently, so the compared step
    # runs without it).
    cell = build_cell(DIST["arch"], "card_train", mesh, cfg=cfg,
                      device=dev, seed=DIST["seed"], microbatches=1)
    params, ostate, _ = cell.args

    def placed(step: int) -> dict:
        return {k: place(v.to(dev), mesh, cell.in_shardings[2][k])
                for k, v in lm_batch(dcfg, step).items()}

    def local(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t
                ).detach().cpu()

    params, ostate, met = cell.fn(params, ostate, placed(0))
    dist_loss = local(met["loss"])
    worst, unequal = 0.0, []
    for k, ref in plain.items():
        got = local(params[k])
        if not torch.equal(got, ref):
            unequal.append(k)
            d = (got.double() - ref.double()).abs().max().item()
            worst = max(worst, d / max(ref.double().abs().max().item(),
                                       1e-30))
    loss_rel = abs(dist_loss.double().item() - plain_loss.double().item()
                   ) / abs(plain_loss.double().item())
    with FlopCounterMode(display=False) as fc:
        cell.fn(params, ostate, placed(1))
    counted = float(fc.get_total_flops())
    del cell, params, ostate, met, plain

    # 4. compressed_psum_mean over the one-rank group on one layer's
    # gradients (shapes of decoder layer 0), against the CPU's over a
    # gloo group.
    gen = torch.Generator().manual_seed(DIST["seed"] + 1)
    layer0 = {k[len("decoder.0."):]: v for k, v in
              LM(cfg, device="meta").abstract_params().items()
              if k.startswith("decoder.0.")}
    grads_cpu = {k: torch.randn(v.shape, generator=gen) * 1e-3
                 for k, v in layer0.items()}
    grads = {k: v.to(dev) for k, v in grads_cpu.items()}
    synced, ef = compressed_psum_mean(grads, init_ef(grads))
    synced2, ef2 = compressed_psum_mean(grads, ef)
    cpu_group = dist.new_group(backend="gloo")
    s_cpu, e_cpu = compressed_psum_mean(grads_cpu, init_ef(grads_cpu),
                                        group=cpu_group)
    s2_cpu, e2_cpu = compressed_psum_mean(grads_cpu, e_cpu, group=cpu_group)
    compress_unequal = [
        f"{what}:{k}" for what, a, b in (("synced", synced, s_cpu),
                                         ("ef", ef, e_cpu),
                                         ("synced2", synced2, s2_cpu),
                                         ("ef2", ef2, e2_cpu))
        for k in a if not torch.equal(a[k].cpu(), b[k])]
    dist.destroy_process_group()

    res = {
        "mesh": [1, 1], "backend": backend, "arch": cfg.name,
        "batch": DIST["batch"], "seq": DIST["seq"],
        "predicted_dot_flops": pred.dot_flops,
        "counted_dot_flops": counted,
        "flops_rel_diff": abs(pred.dot_flops - counted) / counted,
        "flops_tol": DIST_FLOPS_TOL,
        "loss_plain": plain_loss.item(), "loss_dist": dist_loss.item(),
        "loss_bit_equal": bool(torch.equal(dist_loss, plain_loss)),
        "loss_rel_diff": loss_rel,
        "params_unequal": len(unequal), "params_rel_max": worst,
        "params_unequal_names": unequal[:8], "step_rtol": DIST_STEP_RTOL,
        "compress": {"leaves": len(grads_cpu),
                     "bit_equal_to_cpu": not compress_unequal,
                     "unequal": compress_unequal[:8]}}
    if not res["flops_rel_diff"] <= DIST_FLOPS_TOL:
        raise AssertionError(f"dist card: predicted {pred.dot_flops} vs "
                             f"counted {counted} dot FLOPs")
    if not (loss_rel <= DIST_STEP_RTOL and worst <= DIST_STEP_RTOL):
        raise AssertionError(f"dist card: the 1x1 step differs from "
                             f"make_train_step (loss {loss_rel}, "
                             f"{len(unequal)} parameters, {worst})")
    if compress_unequal:
        raise AssertionError(f"dist compress: card != cpu in "
                             f"{compress_unequal[:8]}")
    return res


def shard_rank(rank: int, world: int, port: int, n: int, nnz: int) -> dict:
    """One rank of the distributed SpMV, on card ``rank`` in an NCCL
    group of ``world``: make_rank_spmv on its part of band_matrix(n, nnz,
    seed=0) in the four cases (overlap_local x use_kernel), each held to
    the float64 oracle within 1e-4 of max |y| and bit for bit to the
    one-process make_distributed_spmv at the same R, its launches
    counted over its first run (ell_spmv with the kernels, nothing
    without), the two orderings with the kernels bit-equal; each step
    timed by measure_cuda over a fixed count of steps, in turns."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.bench import measure_cuda
    from repro_torch.kernels.pack import kernel as pack_k
    from repro_torch.kernels.spmv import kernel as spmv_k
    from repro_torch.spmv.distributed import (AXIS, make_distributed_spmv,
                                              make_rank_spmv, rank_device)
    from repro_torch.spmv.matrix import band_matrix, partition

    rank_device(world)
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world, device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=(AXIS,))
        A = band_matrix(n=n, nnz=nnz, seed=0)
        parts = partition(A, world)
        x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
        m = n // world
        rows = slice(rank * m, (rank + 1) * m)
        oracle = A.matvec(x)
        scale = float(np.abs(oracle).max())
        one_process = {
            uk: make_distributed_spmv(parts, dev, use_kernel=uk)(x)[rows]
            for uk in (True, False)}
        counters = {"ell_spmv": spmv_k.ell_spmv, "pack": pack_k.pack,
                    "ell_onehot": spmv_k.ell_onehot}
        cases, runs, ys = [], [], {}
        for overlap_local in (True, False):
            for use_kernel in (True, False):
                name = (f"overlap_local={overlap_local},"
                        f"use_kernel={use_kernel}")
                run = make_rank_spmv(parts[rank], mesh,
                                     use_kernel=use_kernel,
                                     overlap_local=overlap_local)
                before = {k: c.launches for k, c in counters.items()}
                y = run(x[rows])
                launched = {k: c.launches - before[k]
                            for k, c in counters.items()
                            if c.launches > before[k]}
                rel = float(np.abs(y - oracle[rows]).max() / scale)
                if not (np.isfinite(y).all() and rel <= 1e-4):
                    raise AssertionError(f"shard rank {rank} {name}: rel "
                                         f"err {rel} > 1e-4")
                if set(launched) != ({"ell_spmv"} if use_kernel else set()):
                    raise AssertionError(f"shard rank {rank} {name}: "
                                         f"launched {launched}")
                if not np.array_equal(y, one_process[use_kernel]):
                    raise AssertionError(
                        f"shard rank {rank} {name}: y is not the "
                        "one-process make_distributed_spmv's")
                ys[overlap_local, use_kernel] = y
                runs.append(run)
                cases.append({"overlap_local": overlap_local,
                              "use_kernel": use_kernel, "rel_err": rel,
                              "launches": launched,
                              "equals_one_process": True, "us_windows": []})
        if not np.array_equal(ys[True, True], ys[False, True]):
            raise AssertionError(f"shard rank {rank}: the two orderings "
                                 "with the kernels give different y")
        turns = list(range(len(cases)))
        for _ in range(3):
            for i in turns + turns[::-1]:
                cases[i]["us_windows"].append(measure_cuda(
                    runs[i].step, dev, t_measure_s=0.0,
                    min_samples=SHARD_SAMPLES) * 1e6)
        for case in cases:
            case["us"] = statistics.median(case["us_windows"])
        return {"rank": rank, "world": world, "n": n, "nnz": nnz, "m": m,
                "backend": dist.get_backend(runs[0].group),
                "cases": cases, "kernel_orderings_bit_equal": True,
                "kernel_vs_plain_rel": {
                    f"overlap_local={ol}": float(
                        np.abs(ys[ol, True] - ys[ol, False]).max() / scale)
                    for ol in (True, False)}}
    finally:
        dist.destroy_process_group()


def main(args: list[str]) -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args == ["dist_card"]:
        res = dist_card(torch.device("cuda"))
    elif len(args) == 6 and args[0] == "shard":
        res = shard_rank(*map(int, args[1:]))
    else:
        print(__doc__, file=sys.stderr)
        return 2
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
