"""Compressed data-parallel gradient synchronization.

Port of ``repro/dist/compress.py``. Int8 per-tensor quantization with
error feedback (1-bit-Adam-style EF): each rank quantizes (gradient +
carried residual), the quantized values are mean-reduced over the
group, and the local quantization residual is carried into the next
step.

Trees are dicts (nested allowed) of tensors. The reference reduces with
``jax.lax.psum`` over a named mesh axis; here the reduction is
``torch.distributed.all_reduce`` (a sum, then a division by the group's
size) over a process group, ``None`` meaning the default group. The
quantized values travel as the gradient's dtype, as in the reference:
the int8 grid bounds the error, not the bytes on the wire.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def psum_mean(tree, group=None):
    """Exact mean-reduction of a gradient tree over ``group``; the
    inputs are left as they are."""
    n = dist.get_world_size(group)

    def mean(g):
        s = g.clone()
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        return s / _scalar(n, s)

    return _map(mean, tree)


def init_ef(params):
    """Zero-initialized error-feedback state, one residual per leaf."""
    return _map(torch.zeros_like, params)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-dim tensor on ``like``'s device: CUDA divides by a
    Python number as a product with its reciprocal, by a tensor exactly,
    as the CPU does, so card and CPU agree bit for bit."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _quantize(v: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 quantize-dequantize."""
    scale = v.abs().max() / _scalar(127.0, v) + 1e-30
    q = torch.clamp(torch.round(v / scale), -127.0, 127.0)
    return (q * scale).to(v.dtype)


def compressed_psum_mean(grads, ef, group=None):
    """Mean-reduce ``grads`` over ``group`` with int8 compression.

    Returns ``(synced, new_ef)``: the dequantized mean and the updated
    error-feedback residuals (what quantization dropped locally this
    step, re-injected into the next call's input).
    """
    compensated = _map(lambda g, e: g + e, grads, ef)
    deq = _map(_quantize, compensated)
    new_ef = _map(lambda v, d: v - d, compensated, deq)
    synced = psum_mean(deq, group)
    return synced, new_ef
