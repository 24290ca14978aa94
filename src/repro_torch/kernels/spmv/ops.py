"""Public ELL SpMV entry points.

A tensor on the CPU takes the plain PyTorch version; a tensor on a CUDA
device launches the hand-written kernel (:mod:`.kernel`) or raises.

The ELL-T operands may be multiplied as they are, every row padded to
K slots, or in the sorted-slice layout (SELL-32-1024) that this module
owns: :func:`sliced_operands` sorts rows by length inside each
``WINDOW``-row window so that every 32-row slice is read only as far as
its widest row, :func:`deal_blocks` deals its ``BLOCK_N``-row CTA
blocks out by row group, and :func:`sliced_matvec` launches the product
with that ``BLOCK_N``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.spmv.kernel import (SLICE_ROWS, ell_onehot,
                                             ell_spmv)
from repro_torch.kernels.spmv.ref import ell_matvec_ref  # re-export

__all__ = ["ell_matvec", "ell_matvec_t", "ell_spmv_plain",
           "SlicedEll", "sliced_operands", "deal_blocks", "sliced_matvec",
           "unsliced", "row_lengths", "check_permutation",
           "ell_matvec_onehot", "onehot_operands", "ell_onehot_plain",
           "ell_matvec_ref", "WINDOW", "BLOCK_N"]

# Rows sorted together by sliced_operands: on the paper's matrix, 1,024
# leaves 2.8% of the slots read as padding (a whole rank sorted, 0.01%).
WINDOW = 1024
# Rows (threads) per CTA of a sorted-slice product, and the blocks that
# deal_blocks deals. The dealt layout is faster only under two
# conditions that nothing checks: the card hands CTAs to its SMs in turn
# (observed on the H100, not documented), and the number of row groups
# divides the SM count (4 ranks, 132 SMs). Without them the product is
# the same; only its speed may differ.
BLOCK_N = 256


class SlicedEll(NamedTuple):
    """ELL-T operands in the sorted-slice layout.

    ``vals_t``/``cols_t`` (K, N) hold the rows in the layout's order,
    ``perm`` (N,) int32 maps a position to its original row, and
    ``slice_k`` (ceil(N/32),) int32 is each 32-row slice's widest row:
    slots at or past it are never read.
    """
    vals_t: torch.Tensor
    cols_t: torch.Tensor
    slice_k: torch.Tensor
    perm: torch.Tensor


def row_lengths(vals_t: torch.Tensor) -> torch.Tensor:
    """Each row's length (N,) int64: one past its last non-zero slot,
    0 for an empty row. Every slot past it holds 0."""
    k, n = vals_t.shape
    if k == 0:
        return torch.zeros(n, dtype=torch.int64, device=vals_t.device)
    slot = torch.arange(1, k + 1, device=vals_t.device)[:, None]
    return torch.where(vals_t != 0, slot, 0).amax(dim=0)


def sliced_operands(vals_t: torch.Tensor, cols_t: torch.Tensor
                    ) -> SlicedEll:
    """The sorted-slice layout of ELL-T ``vals_t``/``cols_t`` (K, N).

    Rows are stably sorted by descending :func:`row_lengths` inside each
    ``WINDOW``-row window, so the rows of a 32-row slice have nearly
    equal lengths and the kernel reads ``sum(slice_k) * 32`` slots
    instead of K * N. Set-up code: plain PyTorch on the operands'
    device, run once per matrix. Slots past a row's length must hold 0
    with a column inside x (as ``spmv/matrix.py:partition`` leaves
    them): the slice's widest row reads them.
    """
    if vals_t.dim() != 2 or cols_t.shape != vals_t.shape:
        raise ValueError(f"sliced_operands: vals_t {tuple(vals_t.shape)} "
                         f"and cols_t {tuple(cols_t.shape)} are not one "
                         "(K, N) shape")
    k, n = vals_t.shape
    dev = vals_t.device
    length = row_lengths(vals_t)
    # Window first, then longest first; a stable sort keeps row order
    # among equal lengths.
    key = torch.arange(n, device=dev) // WINDOW * (k + 1) + (k - length)
    perm = torch.argsort(key, stable=True)
    pad = (-n) % SLICE_ROWS
    slice_k = torch.nn.functional.pad(length[perm], (0, pad)).view(
        -1, SLICE_ROWS).amax(dim=1)
    return SlicedEll(vals_t[:, perm].contiguous(),
                     cols_t[:, perm].contiguous(),
                     slice_k.to(torch.int32), perm.to(torch.int32))


def deal_blocks(a: SlicedEll, group_rows: int) -> SlicedEll:
    """The same product with its ``BLOCK_N``-row blocks (one CTA each)
    dealt out group by group: block b of the result is block b // G of
    group b mod G, for G groups of ``group_rows`` rows (a block belongs
    to the group of its first row; a group's spare blocks come last, and
    the last, partial block stays last).

    For the distributed SpMV a group is a rank, whose rows gather from
    that rank's part of x only. Under the conditions stated at
    ``BLOCK_N`` the CTAs that share an SM come from one rank, and x's
    gathers hit that SM's L1 instead of L2 (measured: PERF.md). Set-up
    code, like :func:`sliced_operands`.
    """
    n = a.perm.numel()
    dev = a.perm.device
    full = n // BLOCK_N
    group = torch.arange(full, device=dev) * BLOCK_N // group_rows
    first = torch.searchsorted(group, group)
    key = (torch.arange(full, device=dev) - first) * (n + 1) + group
    order = torch.argsort(key, stable=True)
    step = torch.arange(BLOCK_N, device=dev)
    rows = torch.cat([(order[:, None] * BLOCK_N + step).flatten(),
                      torch.arange(full * BLOCK_N, n, device=dev)])
    per = BLOCK_N // SLICE_ROWS
    slices = torch.cat([(order[:, None] * per +
                         torch.arange(per, device=dev)).flatten(),
                        torch.arange(full * per, a.slice_k.numel(),
                                     device=dev)])
    return SlicedEll(a.vals_t[:, rows].contiguous(),
                     a.cols_t[:, rows].contiguous(),
                     a.slice_k[slices].contiguous(), a.perm[rows].contiguous())


def unsliced(a: SlicedEll) -> tuple[torch.Tensor, torch.Tensor]:
    """``a``'s ``vals_t``/``cols_t`` back in row order: the padded ELL-T
    arrays, every row read to K."""
    p = a.perm.long()
    inv = torch.empty_like(p)
    inv[p] = torch.arange(p.numel(), device=p.device)
    return a.vals_t[:, inv].contiguous(), a.cols_t[:, inv].contiguous()


def check_permutation(perm: torch.Tensor, n: int) -> None:
    """Raise unless ``perm`` holds every row 0..n-1 exactly once, so a
    sorted-slice product writes every entry of its output. Set-up
    code: it reads ``perm`` back to the host."""
    if perm.dim() != 1 or not torch.equal(
            torch.sort(perm.long().cpu()).values, torch.arange(n)):
        raise ValueError(f"perm is not a permutation of 0..{n - 1}")


def ell_spmv_plain(vals_t: torch.Tensor, cols_t: torch.Tensor,
                   x: torch.Tensor, slice_k: torch.Tensor | None = None,
                   perm: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: float32 (N,) result.

    With ``slice_k``, slot k of sorted row n counts only when k <
    ``slice_k[n // 32]`` (the slots past it are not read); with
    ``perm``, sorted row n lands in ``out[perm[n]]``. Columns of the
    slots read must lie in [0, len(x)); indexing raises on one that
    does not."""
    k, n = vals_t.shape
    cols = cols_t.long()
    if slice_k is None:
        y = (vals_t.float() * x.float()[cols]).sum(dim=0)
    else:
        width = slice_k.long().clamp(0, k).repeat_interleave(
            SLICE_ROWS)[:n]
        live = torch.arange(k, device=cols.device)[:, None] < width
        g = x.float()[torch.where(live, cols, 0)]
        y = torch.where(live, vals_t.float() * g, 0.0).sum(dim=0)
    if perm is None:
        return y
    out = torch.empty_like(y)
    out[perm.long()] = y
    return out


def ell_matvec_t(vals_t: torch.Tensor, cols_t: torch.Tensor,
                 x: torch.Tensor, out: torch.Tensor | None = None,
                 block_n: int = 256, slice_k: torch.Tensor | None = None,
                 perm: torch.Tensor | None = None) -> torch.Tensor:
    """y = A x for ELL-T (K-major) ``vals_t``/``cols_t`` (K, N).

    Writes into ``out`` ((N,) float32) when given — the distributed
    SpMV preallocates its outputs — else allocates it. ``block_n`` is
    the rows per CTA on the card (a multiple of 32). ``slice_k`` and
    ``perm`` (from :func:`sliced_operands`) select the sorted-slice
    layout; without them every row is read to K.
    """
    if x.device.type == "cpu":
        y = ell_spmv_plain(vals_t, cols_t, x, slice_k, perm)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty(vals_t.shape[1], dtype=torch.float32,
                          device=x.device)
    return ell_spmv(vals_t, cols_t, x, out, block_n, slice_k, perm)


def sliced_matvec(a: SlicedEll, x: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """y = A x for ``a`` in the sorted-slice layout, ``BLOCK_N`` rows per
    CTA on the card (the blocks :func:`deal_blocks` dealt); float32 y in
    row order."""
    return ell_matvec_t(a.vals_t, a.cols_t, x, out=out, block_n=BLOCK_N,
                        slice_k=a.slice_k, perm=a.perm)


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
