"""Per-cell model configs, sharding rules, and abstract inputs.

Port of ``repro/launch/inputs.py``. ``build_cell(arch, shape, mesh)``
assembles everything the dry run needs for one (architecture x input
shape x mesh) cell: the step function, its arguments and their
placements. The model is built on the meta device and every argument is
a DTensor whose local shard is a meta tensor (the reference's
``ShapeDtypeStruct``s): shapes, dtypes and placements, no storage. On a
mesh over a real process group (the one-GPU cell of ``chip_smoke.py``)
``build_cell(..., device=...)`` draws the parameters instead and the
same code runs the step.

Attention takes the plain route (the streaming softmax), which is what
the reference's dry run compiles. A train cell of ``microbatches`` > 1
runs one microbatch and counts it ``microbatches`` times
(``count_one_microbatch``; the batch's split, the accumulator's set-up
and the optimizer once), and Mamba's time loop runs its first two
chunks, the second counted once for each chunk after the first
(``count_one_chunk``: forward, recompute and backward; the skipped
chunks' outputs and saved states are allocated, so their bytes count),
as the reference's analyzer multiplies its scans' bodies by their trip
counts. RWKV runs its chunked form in the
train and prefill cells (``_rwkv_chunk``), as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import Replicate

from repro_torch import configs as cfgs
from repro_torch.configs.shapes import SHAPES, ShapeCell, applicable
from repro_torch.dist import sharding as shd
from repro_torch.launch.hlo import Counter
from repro_torch.models import mamba
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamW
from repro_torch.serve.engine import make_serve_step, serve_shardings
from repro_torch.train.step import distribute_model, jit_train_step, place

ATTENTION = "plain"

# Fused FSDP+TP: parameter output dims shard over (model, data) jointly.
FSDP_RULES = {
    "d_ff": ("model", "data"),
    "vocab": ("model", "data"),
    "d_inner": ("model", "data"),
    "heads_x_dim": ("model", "data"),
    "head_dim": "data",            # FSDP for attention weights
}


def cell_config(arch: str, shape: str, mesh,
                base: ModelConfig | None = None) -> ModelConfig:
    """Full config (or ``base``, e.g. the reduced one), transformed for
    the cell (head padding, windows, serve dtypes)."""
    cfg = base or cfgs.get_config(arch)
    cell = SHAPES[shape]
    tp = shd.mesh_sizes(mesh).get("model", 1)
    over: dict[str, Any] = {"head_pad_to": tp}
    if cell.kind != "train":
        over["param_dtype"] = "bfloat16"   # serving weights
        over["remat"] = False
    if arch == "jamba-v0.1-52b" and shape == "long_500k":
        # Hybrid long-context posture: windowed attention layers, mamba
        # layers carry the unbounded context.
        over["attn_window"] = 4096
    return dataclasses.replace(cfg, **over)


def rules_for(cfg: ModelConfig, kind: str, mesh) -> dict:
    """Logical-axis rules for one cell.

    Baseline scheme: TP over "model" (heads/d_ff/vocab/experts), batch
    over ("pod","data"), FSDP (params + optimizer over "data") for
    training. KV-head fallbacks when kv_heads doesn't divide the model
    axis: row-parallel KV weights (train/prefill) or head_dim-sharded
    caches (decode).
    """
    tp = shd.mesh_sizes(mesh).get("model", 1)
    rules: dict[str, Any] = {}
    # Params + AdamW moments in f32 = 12 bytes/param, TP-sharded.
    param_gb_per_chip = cfg.param_count() * 12 / tp / 1e9
    if kind == "train" and param_gb_per_chip > 5.0:
        # Fused FSDP+TP for models whose optimizer state does not fit
        # TP-only: parameter output dims shard over (model, data)
        # jointly (ZeRO-3 semantics). Small models skip FSDP: pure DP+TP
        # costs one gradient all-reduce per step instead of per-layer
        # weight gathers.
        rules.update(FSDP_RULES)
    if cfg.n_kv_heads % tp != 0:
        # True-KV weight dim can't shard; the stored-KV (duplicated)
        # activations/caches shard via the "kv_stored" rule instead.
        rules["kv_heads"] = None
    if kind == "decode" and cfg.attn_window is not None:
        # Windowed decode slices the cache along kv_seq; a seq-sharded
        # cache would force a full-cache all-gather per layer.
        rules["kv_seq"] = None
    return rules


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    fn: Callable
    args: tuple            # DTensors (meta shards in the dry run)
    in_shardings: tuple    # placements, keyed as the arguments
    out_shardings: Any
    meta: dict
    model: LM | None = None
    counter: Counter | None = None   # the weights the step sets


def _abstract_batch(cfg: ModelConfig, cell: ShapeCell, mesh, rules: dict,
                    with_labels: bool, device) -> tuple[dict, dict]:
    gb, s = cell.global_batch, cell.seq_len
    shapes = {"tokens": ((gb, s), ("batch", "seq"), torch.int32)}
    if with_labels:
        shapes["labels"] = shapes["tokens"]
    if cfg.frontend is not None:
        fe = cfg.frontend
        shapes["frontend"] = ((gb, fe.n_positions, fe.d_frontend),
                              ("batch", None, None), torch.float32)
    batch, bsh = {}, {}
    for k, (shape, names, dt) in shapes.items():
        # spec_for drops non-divisible dims (e.g. long_500k's batch of 1).
        bsh[k] = shd.spec_for(shape, names, mesh, rules)
        batch[k] = place(torch.zeros(shape, dtype=dt, device=device), mesh,
                         bsh[k])
    return batch, bsh


def _default_microbatches(cfg: ModelConfig, cell: ShapeCell,
                          mesh) -> int:
    """Grad-accumulation depth: keep saved per-layer boundary
    activations under ~3 GB/device."""
    sizes = shd.mesh_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    b_dev = max(1, cell.global_batch // dp)
    saved = b_dev * cell.seq_len * cfg.d_model * 2 * cfg.n_layers
    mb = 1
    while saved / mb > 3e9 and mb < b_dev:
        mb *= 2
    return mb


def build_cell(arch: str, shape: str, mesh,
               microbatches: int | None = None, *,
               cfg: ModelConfig | None = None,
               device="meta", seed: int = 0,
               count_one_microbatch: bool = True,
               count_one_chunk: bool = True) -> Cell:
    """One cell on ``mesh``. ``cfg`` replaces the cell's config (a
    reduced or depth-cut one); ``device`` other than ``"meta"`` builds
    real parameters there (drawn from ``seed``), on a mesh of that
    device type. ``count_one_microbatch`` counts one microbatch for all,
    ``count_one_chunk`` one Mamba chunk for all but the first (on the
    meta device only: a real device computes every chunk)."""
    if not applicable(arch, shape):
        raise ValueError(f"{arch} x {shape} is a skip cell")
    cell = SHAPES[shape]
    cfg = cfg or cell_config(arch, shape, mesh)
    rules = rules_for(cfg, cell.kind, mesh)
    model = LM(cfg, device=device, seed=seed)
    counter = Counter()
    one_chunk = count_one_chunk and device == "meta"
    chunk = _rwkv_chunk(cfg, cell)
    meta = {"arch": arch, "shape": shape, "kind": cell.kind,
            "global_batch": cell.global_batch, "seq_len": cell.seq_len,
            "n_params": model.n_params(), "attention": ATTENTION,
            "rules": dict(rules), "rwkv_chunk": chunk,
            "count_one_chunk": one_chunk}

    def counted(fn):
        """``fn`` with Mamba's time loop counted on two chunks."""
        if not one_chunk:
            return fn

        def run(*args):
            token = mamba.count_one_chunk.set(counter.scaled)
            try:
                return fn(*args)
            finally:
                mamba.count_one_chunk.reset(token)
        return run

    if cell.kind == "train":
        opt = AdamW()
        mb = microbatches if microbatches is not None else \
            _default_microbatches(cfg, cell, mesh)
        meta["microbatches"] = mb
        limit = 1 if count_one_microbatch and mb > 1 else None
        meta["microbatches_run"] = limit or mb

        def mark(name):
            # The microbatch between "split" and "microbatch" counts mb
            # times; the split, the accumulation's set-up and the
            # optimizer once.
            if name == "split" and limit:
                counter.set_weight(mb)
            elif name == "microbatch":
                counter.set_weight(1)

        step, (p_sh, o_sh, b_sh) = jit_train_step(
            model, opt, mesh, rules, microbatches=mb, rwkv_chunk=chunk,
            marks=mark, microbatch_limit=limit)
        params = dict(model.named_parameters())
        o_abs = opt.init(params)
        batch, b_sh = _abstract_batch(cfg, cell, mesh, rules, True, device)

        def fn(params, opt_state, batch):
            counter.set_weight(1)
            return step(params, opt_state, batch)

        return Cell(arch, shape, cfg, counted(fn), (params, o_abs, batch),
                    (p_sh, o_sh, b_sh), (p_sh, o_sh, None), meta, model,
                    counter)

    n_memory = cfg.frontend.n_positions if cfg.family == "encdec" else 0
    gb, t_max = cell.global_batch, cell.seq_len
    if cell.kind == "prefill" and cfg.family == "vlm":
        t_max += cfg.frontend.n_positions  # patch tokens prepended
    p_sh, c_sh, tok_sh = serve_shardings(model, mesh, gb, t_max,
                                         n_memory, rules)
    distribute_model(model, mesh, p_sh)
    params = dict(model.named_parameters())

    if cell.kind == "prefill":
        batch, b_sh = _abstract_batch(cfg, cell, mesh, rules, False, device)

        def prefill(params, batch):
            return model.prefill(batch["tokens"], t_max,
                                 frontend=batch.get("frontend"),
                                 attention=ATTENTION, rwkv_chunk=chunk)

        return Cell(arch, shape, cfg,
                    counted(shd.bound_to(prefill, mesh, rules)),
                    (params, batch), (p_sh, b_sh), None, meta, model,
                    counter)

    # decode: one new token against a seq_len cache.
    with shd.activation_sharding(mesh, rules):
        caches = model.init_caches(gb, t_max, n_memory=n_memory)
    tokens = place(torch.zeros((gb, 1), dtype=torch.int32, device=device),
                   mesh, tok_sh)
    # The position is the reference's traced int32 scalar (4 bytes of
    # argument); the step writes the cache's last slot, t_max - 1, and
    # attends to every position before it.
    pos = place(torch.zeros((), dtype=torch.int32, device=device), mesh,
                (Replicate(),) * mesh.ndim)
    step = make_serve_step(model)

    def decode(params, caches, tokens, pos):
        return step(caches, tokens, t_max - 1)

    return Cell(arch, shape, cfg, shd.bound_to(decode, mesh, rules),
                (params, caches, tokens, pos),
                (p_sh, c_sh, tok_sh, pos.placements), (tok_sh, None, c_sh),
                meta, model)


def _rwkv_chunk(cfg: ModelConfig, cell: ShapeCell) -> int | None:
    """Chunked (block-parallel) RWKV for full-sequence cells."""
    if cfg.family != "ssm" or cell.kind == "decode":
        return None
    return 256 if cell.seq_len % 256 == 0 else None
