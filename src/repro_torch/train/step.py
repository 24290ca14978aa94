"""The train step: loss -> grads -> AdamW, with optional microbatch
gradient accumulation.

Port of ``repro/train/step.py:make_train_step``. The state is the
reference's pair ``(params, opt_state)``, so that the restart loop and
the checkpoint store port as they are, but it lives on the module:
``params`` is the ``LM``'s parameter dict (``dict(model.
named_parameters())``), updated in place under ``torch.no_grad()``, and
the optimizer state is updated in place too (``optim/adamw.py``). A
``params`` dict whose tensors are not the module's own (a restored
checkpoint, a copy) is first copied into the module. So one state cannot
be stepped twice from the same values unless the caller passes copies.

Attention runs on the plain route: on the card, where its operands
allow, the training kernels (``models/attention.py:trains_on_kernel``,
csrc/flash_attention_train.cu's forward and backward), elsewhere the
streaming softmax with the reference's nested remat; the served flash
kernel has no backward.
:func:`train_shardings` gives the placements of parameters, optimizer
state and batch on a mesh, and :func:`jit_train_step` the step over
DTensors (nothing is compiled: the name is the reference's). Every
family of the configs trains: the MoE aux loss is part of the loss,
Mamba and chunked RWKV checkpoint their time loops a chunk at a time,
and whisper's and internvl2's batches carry ``"frontend"``. With
microbatches the metrics are the reference's: ``ce`` is the mean total
loss (aux included), ``z_loss`` and ``aux`` are 0.

With a telemetry registry current (:mod:`repro_torch.obs`) the step's
parts are spans with device intervals on the model's device:
``train.forward`` and ``train.backward`` once a microbatch,
``train.optimizer`` once a step. After the optimizer each sigmoid
router's balancing bias moves by the step's loads
(``LM.update_router_bias``).
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Mapping

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch import obs
from repro_torch.dist import sharding as shd
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamW

FSDP_AXES = ("pod", "data")


def load_params(model: LM, params: dict) -> dict:
    """The module's parameter dict, holding ``params``' values: each
    tensor that is not the module's own is copied in."""
    own = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in own.items():
            if params[name] is not p:
                p.copy_(params[name])
    return own


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements (a pending
    Partial sum reduced: the data-parallel gradient reduction); a plain
    tensor as it is. A mesh dimension on which the gradient is whole
    and the parameter sharded is sliced first, at no cost, so that the
    sum is reduced over the local shard only (DTensor's embedding
    backward leaves the vocab-sharded table's gradient whole on every
    model rank)."""
    if not isinstance(g, DTensor) or tuple(g.placements) == \
            tuple(p.placements):
        return g
    sliced = tuple(q if isinstance(a, Replicate) else a
                   for a, q in zip(g.placements, p.placements))
    if sliced != tuple(g.placements):
        g = g.redistribute(p.device_mesh, sliced)
    return g.redistribute(p.device_mesh, p.placements)


def _split(x: torch.Tensor, n: int) -> tuple:
    """``n`` microbatches of ``x`` along dim 0: microbatch i holds the
    global rows [i b/n, (i+1) b/n), as the reference's reshape does (the
    loss is a masked mean per microbatch, so which rows go together
    matters). A DTensor sharded on dim 0 is gathered first, one
    all-gather of the batch a step, and each microbatch is placed as
    ``x`` was."""
    if not isinstance(x, DTensor):
        return x.chunk(n)
    return tuple(c.redistribute(x.device_mesh, x.placements)
                 for c in shd.gather_dim(x, 0).chunk(n))


def make_train_step(model: LM, opt: AdamW, microbatches: int = 1,
                    rwkv_chunk: int | None = None, *,
                    marks: Callable[[str], None] | None = None,
                    microbatch_limit: int | None = None):
    """Returns train_step(params, opt_state, batch) -> (params,
    opt_state, metrics). Turns gradients on for ``model``'s parameters.
    ``rwkv_chunk`` selects RWKV's chunked form (``LM.loss``).

    ``marks``, when given, is called with ``"forward"`` after each
    loss, ``"backward"`` after each gradient, ``"split"`` once the
    batch is split and ``"microbatch"`` after each microbatch's
    accumulation (microbatches > 1), and
    ``"optimizer"`` after the update (a caller timing the parts records
    a CUDA event there). ``microbatch_limit`` runs only the first that
    many of the ``microbatches``, each still weighted 1/microbatches:
    the dry run counts one and scales it (``launch/hlo.py``).
    """
    model.requires_grad_(True)
    mark = marks or (lambda _: None)

    def grad_fn(own: dict, batch: dict):
        with obs.span("train.forward", device=model.device):
            loss, metrics = model.loss(batch, attention="plain",
                                       rwkv_chunk=rwkv_chunk)
        mark("forward")
        with obs.span("train.backward", device=model.device):
            grads = torch.autograd.grad(loss, list(own.values()))
            grads = [_placed_like(g, p)
                     for g, p in zip(grads, own.values())]
        mark("backward")
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(own, grads))

    def train_step(params: dict, opt_state: dict, batch: dict):
        own = load_params(model, params)
        if microbatches == 1:
            loss, metrics, grads = grad_fn(own, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"{microbatches} microbatches")
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in own.items()}
            loss = torch.zeros((), device=model.device)
            mbs = list(zip(*(_split(v, microbatches)
                             for v in batch.values())))
            mark("split")
            for mb in itertools.islice(mbs, microbatch_limit):
                l_mb, _, g_mb = grad_fn(own, dict(zip(batch, mb)))
                for k, g in g_mb.items():
                    grads[k] += g.float() / microbatches
                del g_mb
                loss = loss + l_mb / microbatches
                mark("microbatch")
            zero = torch.zeros((), device=model.device)
            metrics = {"ce": loss, "z_loss": zero, "aux": zero}
        with obs.span("train.optimizer", device=model.device):
            opt.step(grads, opt_state, own)
            model.update_router_bias()
        mark("optimizer")
        metrics = dict(metrics, loss=loss,
                       step=opt_state["count"].float())
        return own, opt_state, metrics

    return train_step


def train_shardings(model: LM, mesh, rules: Mapping[str, Any] | None = None):
    """(params, opt_state, batch) placements: dicts keyed as the step's
    arguments, one placement per mesh dimension for each tensor."""
    p_shard = shd.tree_shardings(model.param_axes(), mesh, rules,
                                 model.abstract_params())
    opt_shard = {"mu": p_shard, "nu": p_shard,
                 "count": (Replicate(),) * mesh.ndim}
    bspec = shd.batch_spec(mesh, extra_dims=1, rules=rules)
    b_shard = {"tokens": bspec, "labels": bspec}
    if model.cfg.frontend is not None:
        b_shard["frontend"] = shd.batch_spec(mesh, extra_dims=2,
                                             rules=rules)
    return p_shard, opt_shard, b_shard


def place(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` as a DTensor of ``placements`` on ``mesh``: a DTensor
    redistributed, a meta tensor as its local shard (shapes only, no
    collective), any other tensor distributed from this rank's copy."""
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements)
    if t.is_meta:
        shape, _ = shd.compute_local_shape_and_global_offset(
            t.shape, mesh, placements)
        return DTensor.from_local(
            torch.empty(shape, dtype=t.dtype, device="meta"), mesh,
            placements, run_check=False, shape=t.shape, stride=t.stride())
    return distribute_tensor(t.detach(), mesh, list(placements))


def gather_for_compute(p, axes=FSDP_AXES):
    """What a layer computes with under FSDP: each DTensor parameter of
    ``p`` (a ``Params`` module, or one tensor) gathered over the mesh
    ``axes`` it is sharded on (ZeRO-3: gathered before use; its
    gradient comes back reduce-scattered). A parameter sharded on no
    such axis is returned as it is."""
    if isinstance(p, DTensor):
        pl = tuple(Replicate() if n in axes else q for n, q in
                   zip(p.device_mesh.mesh_dim_names, p.placements))
        return p if pl == tuple(p.placements) else \
            p.redistribute(p.device_mesh, pl)
    if isinstance(p, torch.Tensor):
        return p
    return {k: gather_for_compute(v, axes) for k, v in itertools.chain(
        p._parameters.items(), p._buffers.items(), p._modules.items())}


def distribute_model(model: LM, mesh, p_shard: dict) -> None:
    """Replace every parameter of ``model`` by a DTensor of its
    placements (meta parameters stay meta: shapes only)."""
    for name, p in list(model.named_parameters()):
        mod, _, leaf = name.rpartition(".")
        owner = model.get_submodule(mod) if mod else model
        setattr(owner, leaf, nn.Parameter(
            place(p.detach(), mesh, p_shard[name]),
            requires_grad=p.requires_grad))


def jit_train_step(model: LM, opt: AdamW, mesh,
                   rules: Mapping[str, Any] | None = None,
                   microbatches: int = 1, rwkv_chunk: int | None = None,
                   *, marks: Callable[[str], None] | None = None,
                   microbatch_limit: int | None = None):
    """The train step on ``mesh``: ``model``'s parameters become
    DTensors of :func:`train_shardings`' placements (in place), each
    layer gathers its parameters over the data axes before computing
    (:func:`gather_for_compute`), and the step runs bound to the mesh
    and rules (:func:`~repro_torch.dist.sharding.bound_to`). Returns (step,
    (params, opt_state, batch) placements); the step takes and returns
    DTensors placed so (build its state with ``opt.init`` of the
    model's parameters and its batch with :func:`place`).

    The reference's ``jax.jit`` with in/out shardings and donation;
    nothing is compiled here, the name is the reference's. The
    parameters and the optimizer state are updated in place, which is
    what the reference's donation allows."""
    p_sh, o_sh, b_sh = train_shardings(model, mesh, rules)
    distribute_model(model, mesh, p_sh)
    model.param_gather = gather_for_compute
    step = make_train_step(model, opt, microbatches=microbatches,
                           rwkv_chunk=rwkv_chunk, marks=marks,
                           microbatch_limit=microbatch_limit)
    return shd.bound_to(step, mesh, rules), (p_sh, o_sh, b_sh)
