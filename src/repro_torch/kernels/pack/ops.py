"""Public pack entry point.

A tensor on the CPU takes the plain PyTorch version; a tensor on a CUDA
device launches the hand-written kernel (:mod:`.kernel`) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pack import kernel as _k
from repro_torch.kernels.pack.ref import pack_ref  # re-export

__all__ = ["pack", "pack_plain", "pack_ref"]


def pack_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``x[idx]``, 0 where
    ``idx`` lies outside [0, n) (the JAX kernel's -1 padding)."""
    n = x.shape[0]
    valid = (idx >= 0) & (idx < n)
    if n == 0:
        return torch.zeros(idx.shape, dtype=x.dtype, device=x.device)
    got = x[idx.long().clamp(0, n - 1)]
    return torch.where(valid, got, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def pack(x: torch.Tensor, idx: torch.Tensor,
         out: torch.Tensor | None = None,
         block_c: int = 256) -> torch.Tensor:
    """Gather ``x[idx]`` into ``out`` (allocated when not given);
    ``block_c`` outputs per CTA on the card."""
    if x.device.type == "cpu":
        y = pack_plain(x, idx)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    return _k.pack(x, idx, out, block_c)
