"""Launch wrapper of the hand-written pack kernel (csrc/pack.cu).

Replaces the TPU kernel ``repro/kernels/pack/kernel.py:pack``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import (check_cuda_args, check_threads,
                                         stream_handle)

_WORD = {torch.float32: "b32", torch.bfloat16: "b16"}
_fns: dict = {}


def pack(x: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
         block_c: int = 256) -> torch.Tensor:
    """``out[j] = x[idx[j]]``, or 0 where ``idx[j]`` is outside [0, n).

    ``x`` (n,) float32 or bfloat16, ``idx`` (m,) int32, ``out`` (m,) of
    ``x``'s dtype; all contiguous on one CUDA device; ``block_c``
    outputs (threads) per CTA. Launches on the current stream and does
    not synchronise.
    """
    word = _WORD.get(x.dtype)
    if word is None or out.dtype != x.dtype:
        raise TypeError(f"pack: x/out must both be float32 or bfloat16, "
                        f"got {x.dtype}/{out.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"pack: idx must be int32, got {idx.dtype}")
    if x.dim() != 1 or idx.dim() != 1 or out.shape != idx.shape:
        raise ValueError(f"pack: shapes x {tuple(x.shape)}, idx "
                         f"{tuple(idx.shape)}, out {tuple(out.shape)} do "
                         "not fit (n,), (m,), (m,)")
    if x.numel() >= 2 ** 31 or idx.numel() >= 2 ** 31:
        raise ValueError("pack: n and m must be below 2**31")
    check_threads("pack", "block_c", block_c)
    check_cuda_args("pack", x, idx, out)
    m = idx.numel()
    if m == 0:
        return out
    fn = _fns.get(word)
    if fn is None:
        fn = _fns[word] = build.declare(build.library("pack"),
                                        f"pack_{word}", 3, 3)
    err = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.numel(), m,
             block_c, stream_handle(x.device))
    build.check(err, "pack")
    pack.launches += 1
    return out


pack.launches = 0
