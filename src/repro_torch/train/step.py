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

Attention runs on the plain route (the streaming softmax, with the
reference's nested remat); the flash kernel has no backward. The
reference's ``train_shardings`` and ``jit_train_step`` place the step on
a mesh and wait for the distribution layer (ROADMAP Queue 1 item 9).
The dense family only: training the MoE, Mamba, RWKV, enc-dec and VLM
configs (their gradient parity, Mamba's chunked checkpoint, frontend
batches) waits for ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamW


def load_params(model: LM, params: dict) -> dict:
    """The module's parameter dict, holding ``params``' values: each
    tensor that is not the module's own is copied in."""
    own = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in own.items():
            if params[name] is not p:
                p.copy_(params[name])
    return own


def make_train_step(model: LM, opt: AdamW, microbatches: int = 1, *,
                    marks: Callable[[str], None] | None = None):
    """Returns train_step(params, opt_state, batch) -> (params,
    opt_state, metrics). Turns gradients on for ``model``'s parameters.

    ``marks``, when given, is called with ``"forward"`` after each
    loss, ``"backward"`` after each gradient and ``"optimizer"`` after
    the update (a caller timing the parts records a CUDA event there).
    """
    if model.cfg.family != "dense":
        raise NotImplementedError(
            f"{model.cfg.name}: training the {model.cfg.family} family "
            "waits for ROADMAP Queue 1 item 11")
    model.requires_grad_(True)
    mark = marks or (lambda _: None)

    def grad_fn(own: dict, batch: dict):
        loss, metrics = model.loss(batch, attention="plain")
        mark("forward")
        grads = torch.autograd.grad(loss, list(own.values()))
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
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in own.items()}
            loss = torch.zeros((), device=model.device)
            for mb in zip(*(v.chunk(microbatches) for v in batch.values())):
                l_mb, _, g_mb = grad_fn(own, dict(zip(batch, mb)))
                for k, g in g_mb.items():
                    grads[k] += g.float() / microbatches
                del g_mb
                loss = loss + l_mb / microbatches
            zero = torch.zeros((), device=model.device)
            metrics = {"ce": loss, "z_loss": zero, "aux": zero}
        opt.step(grads, opt_state, own)
        mark("optimizer")
        metrics = dict(metrics, loss=loss,
                       step=opt_state["count"].float())
        return own, opt_state, metrics

    return train_step
