"""AdamW with decoupled weight decay, global-norm clipping, and a
warmup+cosine schedule, on dicts of tensors keyed by parameter name.

Port of ``repro/optim/adamw.py``, the reference's arithmetic in its
order: the gradients are scaled by min(1, clip / max(|g|, 1e-9)) inside
the step, ``mu``/``nu`` are float32, the bias corrections divide ``mu``
and ``nu`` before the square root, and the decay ``wd * p`` is added to
the normalised step before the learning rate multiplies it. That is not
``torch.optim.AdamW``, which clips nothing, places its eps after the
bias correction of the root and decays the parameter separately.

The state is ``{"mu", "nu", "count"}`` (``"master"`` with
``master_weights``), ``count`` an int32 tensor. :meth:`AdamW.update`
returns the updates and a new state, as the reference. :meth:`AdamW.step`
updates the parameters and the state in place, one parameter at a time,
so that at full width no second copy of the state or of the updates is
ever held: callers that want to start twice from one state pass copies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable:
    """Linear warmup to ``peak_lr``, then a cosine to ``final_frac`` of
    it at ``total_steps``; float32, as the reference computes it."""
    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(1, warmup_steps)
        frac = (step - warmup_steps) / max(1, total_steps - warmup_steps)
        frac = torch.clamp(frac, 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) *
                         0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float | Callable = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float | None = 1.0
    # bf16 params + f32 master copies (kept in the optimizer state).
    master_weights: bool = False

    def init(self, params: dict) -> dict:
        def zeros():     # a DTensor parameter's moments share its placements
            return {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()}
        dev = next(iter(params.values())).device
        state = {"mu": zeros(), "nu": zeros(),
                 "count": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.master_weights:
            state["master"] = {k: p.detach().to(torch.float32, copy=True)
                               for k, p in params.items()}
        return state

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.tensor(self.learning_rate, dtype=torch.float32,
                            device=count.device)

    def _scale(self, grads: dict) -> torch.Tensor | None:
        if self.grad_clip_norm is None:
            return None
        gnorm = global_norm(grads)
        return torch.clamp(self.grad_clip_norm / gnorm.clamp_min(1e-9),
                           max=1.0)

    def _moments(self, g: torch.Tensor, scale, mu: torch.Tensor,
                 nu: torch.Tensor) -> None:
        """mu, nu of one parameter, in place."""
        g = g.float() if scale is None else g.float() * scale
        mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
        nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)

    def _update(self, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                bc1, bc2, lr) -> torch.Tensor:
        """-lr * (m/bc1 / (sqrt(v/bc2) + eps) + wd * p), float32."""
        den = (v / bc2).sqrt_().add_(self.eps)
        step = (m / bc1).div_(den)
        del den
        return step.add_(p.float(), alpha=self.weight_decay).mul_(-lr)

    def _begin(self, grads: dict, state: dict):
        count = state["count"] + 1
        c = count.float()
        return (count, self._scale(grads), 1 - self.b1 ** c,
                1 - self.b2 ** c, self._lr(count))

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        """Returns (updates, new_state); apply with params + updates."""
        count, scale, bc1, bc2, lr = self._begin(grads, state)
        mu = {k: m.clone() for k, m in state["mu"].items()}
        nu = {k: v.clone() for k, v in state["nu"].items()}
        anchor = state.get("master", params)
        updates = {}
        for k, g in grads.items():
            self._moments(g, scale, mu[k], nu[k])
            updates[k] = self._update(anchor[k], mu[k], nu[k], bc1, bc2,
                                      lr).to(anchor[k].dtype)
        new_state = {"mu": mu, "nu": nu, "count": count}
        if self.master_weights:
            new_state["master"] = {k: m + updates[k]
                                   for k, m in state["master"].items()}
        return updates, new_state

    @torch.no_grad()
    def step(self, grads: dict, state: dict, params: dict):
        """Updates ``params`` and ``state`` in place, one parameter at a
        time, and returns them."""
        count, scale, bc1, bc2, lr = self._begin(grads, state)
        if isinstance(scale, DTensor):
            scale = scale.full_tensor()
        master = state.get("master")
        for k, g in grads.items():
            # A DTensor parameter updates its local shard: the step is
            # elementwise, and its gradient and moments share its
            # placements.
            p, mu, nu = (_local(t) for t in (
                params[k], state["mu"][k], state["nu"][k]))
            self._moments(_local(g, params[k]), scale, mu, nu)
            anchor = p if master is None else _local(master[k])
            u = self._update(anchor, mu, nu, bc1, bc2, lr)
            if master is None:
                p.add_(u.to(p.dtype))
            else:
                anchor.add_(u)
                p.copy_(anchor)
            del u
        state["count"] = count
        return params, state


def _local(t: torch.Tensor, like: torch.Tensor | None = None):
    """A DTensor's local shard (first placed as ``like`` is, when
    given); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    if like is not None and tuple(t.placements) != tuple(like.placements):
        t = t.redistribute(like.device_mesh, like.placements)
    return t.to_local()


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree.values()))


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}
