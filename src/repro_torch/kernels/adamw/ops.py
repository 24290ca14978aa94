"""Public entry points of AdamW's per-leaf passes: the gradients' sums of
squares (the global-norm clip) and the fused update.

A leaf on a CUDA device launches the hand-written kernels
(:mod:`.kernel`, csrc/adamw.cu) or raises; any other (the CPU, the dry
run's meta tensors) takes the plain PyTorch version below, which is the
arithmetic ``optim/adamw.py`` ran as a chain of ops before the kernels,
moved as it was.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.adamw import kernel as _k

__all__ = ["sumsq", "sumsq_plain", "update", "update_plain", "moments_plain",
           "step_plain"]


def sumsq_plain(g: torch.Tensor) -> torch.Tensor:
    """One gradient's sum of squares, float32."""
    return torch.sum(torch.square(g.float()))


def sumsq(gs: list[torch.Tensor]):
    """Each gradient's sum of squares (float32 scalars, in order: a list,
    or on the card one tensor of them) and their sum, added in that
    order from 0."""
    if gs and gs[0].device.type == "cuda":
        out = _k.sumsq(gs)
        return out[:-1], out[-1]
    sums = [sumsq_plain(g) for g in gs]
    return sums, sum(sums)


def moments_plain(g: torch.Tensor, scale, mu: torch.Tensor,
                  nu: torch.Tensor, b1: float, b2: float) -> None:
    """mu, nu of one parameter, in place."""
    g = g.float() if scale is None else g.float() * scale
    mu.mul_(b1).add_(g, alpha=1 - b1)
    nu.mul_(b2).addcmul_(g, g, value=1 - b2)


def step_plain(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, bc1, bc2,
               lr, eps: float, weight_decay: float) -> torch.Tensor:
    """-lr * (m/bc1 / (sqrt(v/bc2) + eps) + wd * p), float32."""
    den = (v / bc2).sqrt_().add_(eps)
    step = (m / bc1).div_(den)
    del den
    return step.add_(p.float(), alpha=weight_decay).mul_(-lr)


def update_plain(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, master: torch.Tensor | None, scale, bc1,
                 bc2, lr, *, b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    """One leaf's update in place: the moments, then the step added to
    ``p`` (or to its master copy, which ``p`` then takes)."""
    moments_plain(g, scale, mu, nu, b1, b2)
    anchor = p if master is None else master
    u = step_plain(anchor, mu, nu, bc1, bc2, lr, eps, weight_decay)
    if master is None:
        p.add_(u.to(p.dtype))
    else:
        anchor.add_(u)
        p.copy_(anchor)


def update(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
           nu: torch.Tensor, master: torch.Tensor | None, scale, bc1, bc2,
           lr, *, b1: float, b2: float, eps: float,
           weight_decay: float) -> None:
    """One leaf's AdamW update in place: ``mu``, ``nu``, ``master`` (when
    given) and ``p``; ``scale`` None turns the clip off."""
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if p.device.type == "cuda":
        _k.update(p, g, mu, nu, master, scale, bc1, bc2, lr, **hyper)
    else:
        update_plain(p, g, mu, nu, master, scale, bc1, bc2, lr, **hyper)
