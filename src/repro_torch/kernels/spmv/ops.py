"""Public ELL SpMV entry points.

A tensor on the CPU takes the plain PyTorch version; a tensor on a CUDA
device launches the hand-written kernel (:mod:`.kernel`) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.spmv.kernel import ell_onehot, ell_spmv
from repro_torch.kernels.spmv.ref import ell_matvec_ref  # re-export

__all__ = ["ell_matvec", "ell_matvec_t", "ell_spmv_plain",
           "ell_matvec_onehot", "onehot_operands", "ell_onehot_plain",
           "ell_matvec_ref"]


def ell_spmv_plain(vals_t: torch.Tensor, cols_t: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: float32 (N,) result.

    Columns must lie in [0, len(x)); indexing raises on one that does
    not."""
    return (vals_t.float() * x.float()[cols_t.long()]).sum(dim=0)


def ell_matvec_t(vals_t: torch.Tensor, cols_t: torch.Tensor,
                 x: torch.Tensor, out: torch.Tensor | None = None,
                 block_n: int = 256) -> torch.Tensor:
    """y = A x for ELL-T (K-major) ``vals_t``/``cols_t`` (K, N).

    Writes into ``out`` ((N,) float32) when given — the distributed
    SpMV preallocates its outputs — else allocates it. ``block_n`` is
    the rows per CTA on the card.
    """
    if x.device.type == "cpu":
        y = ell_spmv_plain(vals_t, cols_t, x)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty(vals_t.shape[1], dtype=torch.float32,
                          device=x.device)
    return ell_spmv(vals_t, cols_t, x, out, block_n)


def ell_matvec(vals: torch.Tensor, cols: torch.Tensor,
               x: torch.Tensor, block_n: int = 256) -> torch.Tensor:
    """y = A x for row-major ELL ``vals``/``cols`` (N, K); float32 y.

    The JAX package's public contract: the operands are transposed to
    the K-major layout the kernel reads. Callers that multiply the same
    matrix often store it transposed and call :func:`ell_matvec_t`.
    """
    return ell_matvec_t(vals.T.contiguous(), cols.T.contiguous(), x,
                        block_n=block_n)


def onehot_operands(vals: torch.Tensor, cols: torch.Tensor,
                    x: torch.Tensor, half_bandwidth: int,
                    block_r: int = 256
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The narrow-band kernel's operands ``(vals_t, cols_win_t, x_pad)``.

    The JAX wrapper's contract (``repro/kernels/spmv/ops.py:
    ell_matvec_onehot``): rows are padded to a multiple of ``block_r``
    (val 0, column = row mod nx), each column becomes its circular
    offset from its row in [-hb, hb] plus ``hb`` plus the row's position
    in its block, i.e. its slot in the block's window of width
    ``W = 2*hb + block_r`` of wrap-padded x. ``x_pad[p] = x[(p - hb) mod
    nx]`` covers every block's window, ``x_pad[b*block_r : b*block_r +
    W]``, so the (N/block_r, W) copy of overlapping windows the JAX
    wrapper builds never exists. ``vals_t`` is float32: the kernel sums
    in float32, as the TPU kernel did.
    """
    n, k = vals.shape
    hb = int(half_bandwidth)
    n_x = x.shape[0]
    dev = vals.device
    pad_n = (-n) % block_r
    vals = vals.float()
    cols = cols.to(torch.int64)
    if pad_n:
        vals = torch.cat([vals, vals.new_zeros((pad_n, k))])
        pad_cols = torch.arange(n, n + pad_n, device=dev)[:, None] % n_x
        cols = torch.cat([cols, pad_cols.expand(pad_n, k)])
    np_ = n + pad_n
    rows = torch.arange(np_, device=dev)[:, None]
    offset = (cols - rows % n_x + hb) % n_x - hb
    cols_win = offset + hb + rows % block_r
    x_pad = x.float()[(torch.arange(np_ + 2 * hb, device=dev) - hb) % n_x]
    return (vals.T.contiguous(), cols_win.T.to(torch.int32).contiguous(),
            x_pad.contiguous())


def ell_onehot_plain(vals_t: torch.Tensor, cols_win_t: torch.Tensor,
                     x_pad: torch.Tensor, window: int,
                     block_r: int = 256) -> torch.Tensor:
    """The narrow-band kernel's function in plain PyTorch (float32):
    row n gathers ``x_pad[(n // block_r) * block_r + c]`` for each
    window-relative column c, 0 where c lies outside [0, window)."""
    n = vals_t.shape[1]
    c = cols_win_t.long()
    valid = (c >= 0) & (c < window)
    start = torch.arange(n, device=c.device) // block_r * block_r
    g = x_pad.float()[(start + c.clamp(0, window - 1))]
    return (vals_t.float() * torch.where(valid, g, 0.0)).sum(dim=0)


def ell_matvec_onehot(vals: torch.Tensor, cols: torch.Tensor,
                      x: torch.Tensor, half_bandwidth: int,
                      block_r: int = 256) -> torch.Tensor:
    """Narrow-band ELL SpMV (float32 y) for row-major ``vals``/``cols``
    (N, K) whose columns all lie within ``half_bandwidth`` of their row
    (circular metric); ``block_r`` rows per CTA on the card. Through
    the plain version on the CPU, the hand-written kernel on a card."""
    n = vals.shape[0]
    window = 2 * int(half_bandwidth) + block_r
    vals_t, cols_win_t, x_pad = onehot_operands(vals, cols, x,
                                                half_bandwidth, block_r)
    if x.device.type == "cpu":
        y = ell_onehot_plain(vals_t, cols_win_t, x_pad, window, block_r)
    else:
        y = ell_onehot(vals_t, cols_win_t, x_pad,
                       torch.empty(vals_t.shape[1], dtype=torch.float32,
                                   device=x.device), window, block_r)
    return y[:n]
