"""Launch wrapper of the hand-written ELL SpMV kernel (csrc/ell_spmv.cu).

Replaces the TPU kernel ``repro/kernels/spmv/kernel.py:ell_mulsum`` and
the XLA gather in front of it: the gather runs inside this kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import (FLOAT_SUFFIX, check_cuda_args,
                                         stream_handle)

_fns: dict = {}


def ell_spmv(vals_t: torch.Tensor, cols_t: torch.Tensor, x: torch.Tensor,
             out: torch.Tensor) -> torch.Tensor:
    """``out[n] = sum_k vals_t[k, n] * x[cols_t[k, n]]`` on the card.

    ``vals_t`` (K, N) float32 or bfloat16, ``cols_t`` (K, N) int32,
    ``x`` (nx,) of ``vals_t``'s dtype, ``out`` (N,) float32; all
    contiguous on one CUDA device. Launches on the current stream and
    does not synchronise. Columns must lie in [0, nx); they are not
    checked here (that would synchronise), so a bad one reads outside x.
    """
    suffix = FLOAT_SUFFIX.get(vals_t.dtype)
    if suffix is None or x.dtype != vals_t.dtype:
        raise TypeError(f"ell_spmv: vals/x must both be float32 or "
                        f"bfloat16, got {vals_t.dtype}/{x.dtype}")
    if cols_t.dtype != torch.int32 or out.dtype != torch.float32:
        raise TypeError(f"ell_spmv: cols must be int32 and out float32, "
                        f"got {cols_t.dtype}/{out.dtype}")
    if vals_t.dim() != 2 or cols_t.shape != vals_t.shape or x.dim() != 1 \
            or out.shape != (vals_t.shape[1],):
        raise ValueError(
            f"ell_spmv: shapes vals_t {tuple(vals_t.shape)}, cols_t "
            f"{tuple(cols_t.shape)}, x {tuple(x.shape)}, out "
            f"{tuple(out.shape)} do not fit (K, N), (K, N), (nx,), (N,)")
    k, n = vals_t.shape
    if n >= 2 ** 31 or x.numel() >= 2 ** 31:
        raise ValueError("ell_spmv: N and nx must be below 2**31")
    if k and n and x.numel() == 0:
        raise ValueError("ell_spmv: x is empty")
    check_cuda_args("ell_spmv", vals_t, cols_t, x, out)
    if n == 0:
        return out
    fn = _fns.get(suffix)
    if fn is None:
        fn = _fns[suffix] = build.declare(
            build.library("ell_spmv"), f"ell_spmv_{suffix}", 4, 2)
    err = fn(vals_t.data_ptr(), cols_t.data_ptr(), x.data_ptr(),
             out.data_ptr(), k, n, stream_handle(x.device))
    build.check(err, "ell_spmv")
    ell_spmv.launches += 1
    return out


ell_spmv.launches = 0
