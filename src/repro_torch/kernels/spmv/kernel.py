"""Launch wrappers of the hand-written ELL SpMV kernels.

``ell_spmv`` (csrc/ell_spmv.cu) replaces the TPU kernel
``repro/kernels/spmv/kernel.py:ell_mulsum`` and the XLA gather in front
of it: the gather runs inside this kernel, one warp per 32-row slice
of the sorted-slice layout or of plain ELL-T. ``ell_onehot``
(csrc/ell_onehot.cu) replaces ``ell_onehot_mv``, the narrow-band kernel
over window-relative columns.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import (FLOAT_SUFFIX, MAX_SMEM_BYTES,
                                         check_cuda_args, check_threads,
                                         stream_handle)

_fns: dict = {}
# Rows of one slice of the sorted-slice layout: one warp, lane = row.
SLICE_ROWS = 32


def spmv_grid(n: int, block_n: int) -> tuple[int, int]:
    """(CTAs, threads per CTA) of an ``ell_spmv`` launch over N rows."""
    return (n + block_n - 1) // block_n, block_n


def _check_layout(n: int, slice_k, perm) -> None:
    for name, t, size in (("slice_k", slice_k, -(-n // SLICE_ROWS)),
                          ("perm", perm, n)):
        if t is None:
            continue
        if t.dtype != torch.int32:
            raise TypeError(f"ell_spmv: {name} must be int32, got {t.dtype}")
        if t.shape != (size,):
            raise ValueError(f"ell_spmv: {name} has shape {tuple(t.shape)}"
                             f", N={n} rows need ({size},)")


def ell_spmv(vals_t: torch.Tensor, cols_t: torch.Tensor, x: torch.Tensor,
             out: torch.Tensor, block_n: int = 256,
             slice_k: torch.Tensor | None = None,
             perm: torch.Tensor | None = None) -> torch.Tensor:
    """``out[perm[n]] = sum_{k < slice_k[n // 32]} vals_t[k, n] *
    x[cols_t[k, n]]`` on the card (``out[n]`` and k < K without them).

    ``vals_t`` (K, N) float32 or bfloat16, ``cols_t`` (K, N) int32,
    ``x`` (nx,) of ``vals_t``'s dtype, ``out`` (N,) float32, optional
    ``slice_k`` (ceil(N/32),) and ``perm`` (N,) int32 (the sorted-slice
    layout, :func:`repro_torch.kernels.spmv.ops.sliced_operands`); all
    contiguous on one CUDA device; ``block_n`` rows (threads) per CTA, a
    multiple of 32 so that every warp is one slice. Launches on the
    current stream and does not synchronise. Columns must lie in [0, nx)
    and ``perm`` must be a permutation; neither is checked here (that
    would synchronise): a bad column reads outside x, and a row that
    ``perm`` misses is never written.
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
    _check_layout(n, slice_k, perm)
    check_threads("ell_spmv", "block_n", block_n)
    if block_n % SLICE_ROWS:
        raise ValueError(f"ell_spmv: block_n={block_n} is not a multiple "
                         f"of {SLICE_ROWS} (a warp is one slice)")
    layout = [t for t in (slice_k, perm) if t is not None]
    check_cuda_args("ell_spmv", vals_t, cols_t, x, out, *layout)
    if n == 0:
        return out
    fn = _fns.get(suffix)
    if fn is None:
        fn = _fns[suffix] = build.declare(
            build.library("ell_spmv"), f"ell_spmv_{suffix}", 6, 4)
    err = fn(vals_t.data_ptr(), cols_t.data_ptr(), x.data_ptr(),
             None if slice_k is None else slice_k.data_ptr(),
             None if perm is None else perm.data_ptr(), out.data_ptr(),
             k, n, *spmv_grid(n, block_n), stream_handle(x.device))
    build.check(err, "ell_spmv")
    ell_spmv.launches += 1
    return out


ell_spmv.launches = 0


def onehot_smem_bytes(window: int) -> int:
    """Shared memory of one ``ell_onehot`` CTA: its window's barrier (16
    bytes) and the window, placed at the offset from a 16-byte boundary
    that it has in x_pad (up to 3 more floats)."""
    return 16 + 4 * (window + 3)


def ell_onehot(vals_t: torch.Tensor, cols_win_t: torch.Tensor,
               x_pad: torch.Tensor, out: torch.Tensor, window: int,
               block_r: int = 256) -> torch.Tensor:
    """Narrow-band SpMV over window-relative columns on the card:
    ``out[n] = sum_k vals_t[k, n] * x_pad[(n // block_r) * block_r +
    cols_win_t[k, n]]``, a column outside [0, window) giving 0.

    ``vals_t`` (K, N) float32 with N a multiple of ``block_r``,
    ``cols_win_t`` (K, N) int32, ``x_pad`` float32 holding at least
    ``N - block_r + window`` entries, ``out`` (N,) float32; all
    contiguous on one CUDA device. Raises ``ValueError`` when the window
    does not fit in a CTA's shared memory.
    """
    if vals_t.dtype != torch.float32 or x_pad.dtype != torch.float32 or \
            out.dtype != torch.float32 or cols_win_t.dtype != torch.int32:
        raise TypeError(f"ell_onehot: vals/x_pad/out must be float32 and "
                        f"cols int32, got {vals_t.dtype}/{x_pad.dtype}/"
                        f"{out.dtype}/{cols_win_t.dtype}")
    if vals_t.dim() != 2 or cols_win_t.shape != vals_t.shape or \
            x_pad.dim() != 1 or out.shape != (vals_t.shape[1],):
        raise ValueError(
            f"ell_onehot: shapes vals_t {tuple(vals_t.shape)}, cols_win_t "
            f"{tuple(cols_win_t.shape)}, x_pad {tuple(x_pad.shape)}, out "
            f"{tuple(out.shape)} do not fit (K, N), (K, N), (P,), (N,)")
    k, n = vals_t.shape
    check_threads("ell_onehot", "block_r", block_r)
    if n % block_r:
        raise ValueError(f"ell_onehot: N={n} is not a multiple of "
                         f"block_r={block_r}")
    if window < 1 or onehot_smem_bytes(window) > MAX_SMEM_BYTES:
        raise ValueError(
            f"ell_onehot: a window of {window} floats does not fit the "
            f"{MAX_SMEM_BYTES} bytes of shared memory a CTA can have "
            "(this is the narrow-band kernel)")
    if n and x_pad.numel() < n - block_r + window:
        raise ValueError(f"ell_onehot: x_pad has {x_pad.numel()} entries, "
                         f"the last window ends at {n - block_r + window}")
    if n >= 2 ** 31 or x_pad.numel() >= 2 ** 31:
        raise ValueError("ell_onehot: N and len(x_pad) must be below 2**31")
    check_cuda_args("ell_onehot", vals_t, cols_win_t, x_pad, out)
    if n == 0:
        return out
    fn = _fns.get("onehot")
    if fn is None:
        fn = _fns["onehot"] = build.declare(
            build.library("ell_onehot"), "ell_onehot_f32", 4, 4)
    err = fn(vals_t.data_ptr(), cols_win_t.data_ptr(), x_pad.data_ptr(),
             out.data_ptr(), k, n, window, block_r,
             stream_handle(x_pad.device))
    build.check(err, "ell_onehot")
    ell_onehot.launches += 1
    return out


ell_onehot.launches = 0
