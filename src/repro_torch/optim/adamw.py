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
On a CUDA device :meth:`AdamW.step` runs each leaf through the
hand-written kernels of ``kernels/adamw`` (one pass for the gradient
norm, one fused update; the same arithmetic), elsewhere through their
plain versions. :meth:`AdamW.update` always takes the plain version.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.kernels.adamw import ops as adamw_ops


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

    def _scale(self, gnorm: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.grad_clip_norm / gnorm.clamp_min(1e-9),
                           max=1.0)

    def _begin(self, state: dict):
        count = state["count"] + 1
        c = count.float()
        return count, 1 - self.b1 ** c, 1 - self.b2 ** c, self._lr(count)

    def _hyper(self) -> dict:
        return dict(b1=self.b1, b2=self.b2, eps=self.eps,
                    weight_decay=self.weight_decay)

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        """Returns (updates, new_state); apply with params + updates."""
        count, bc1, bc2, lr = self._begin(state)
        scale = None if self.grad_clip_norm is None else \
            self._scale(global_norm(grads))
        mu = {k: m.clone() for k, m in state["mu"].items()}
        nu = {k: v.clone() for k, v in state["nu"].items()}
        anchor = state.get("master", params)
        updates = {}
        for k, g in grads.items():
            adamw_ops.moments_plain(g, scale, mu[k], nu[k], self.b1,
                                    self.b2)
            updates[k] = adamw_ops.step_plain(
                anchor[k], mu[k], nu[k], bc1, bc2, lr, self.eps,
                self.weight_decay).to(anchor[k].dtype)
        new_state = {"mu": mu, "nu": nu, "count": count}
        if self.master_weights:
            new_state["master"] = {k: m + updates[k]
                                   for k, m in state["master"].items()}
        return updates, new_state

    @torch.no_grad()
    def step(self, grads: dict, state: dict, params: dict):
        """Updates ``params`` and ``state`` in place, one parameter at a
        time, and returns them."""
        count, bc1, bc2, lr = self._begin(state)
        bc1, bc2, lr = _local(bc1), _local(bc2), _local(lr)
        master = state.get("master")
        # A DTensor parameter updates its local shard: the step is
        # elementwise, and its gradient and moments share its placements.
        leaves = {k: (_local(params[k]), _local(g, params[k]),
                      _local(state["mu"][k]), _local(state["nu"][k]),
                      None if master is None else _local(master[k]))
                  for k, g in grads.items()}
        scale = None
        if self.grad_clip_norm is not None:
            sums, total = adamw_ops.sumsq(
                [leaf[1] for leaf in leaves.values()])
            if any(isinstance(params[k], DTensor) for k in leaves):
                # Added as global_norm adds the sums of DTensors: each
                # partial over the mesh dims its leaf is sharded on.
                total = sum(_as_sum_over(s, params[k])
                            for s, k in zip(sums, leaves))
            scale = self._scale(torch.sqrt(total))
            if isinstance(scale, DTensor):
                scale = scale.full_tensor()
        hyper = self._hyper()
        for p, g, mu, nu, m in leaves.values():
            adamw_ops.update(p, g, mu, nu, m, scale, bc1, bc2, lr, **hyper)
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


def _as_sum_over(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A local sum over ``like``'s shard as the DTensor a sum over
    ``like`` gives: partial on each mesh dim ``like`` is sharded on,
    replicated on the others; a plain tensor as it is."""
    if not isinstance(like, DTensor):
        return s
    return DTensor.from_local(
        s, like.device_mesh, [q if isinstance(q, Replicate) else Partial()
                              for q in like.placements], run_check=False)


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(adamw_ops.sumsq_plain(t) for t in tree.values()))


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}
