"""Public ELL SpMV entry points.

A tensor on the CPU takes the plain PyTorch version; a tensor on a CUDA
device launches the hand-written kernel (:mod:`.kernel`) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.spmv.kernel import ell_spmv
from repro_torch.kernels.spmv.ref import ell_matvec_ref  # re-export

__all__ = ["ell_matvec", "ell_matvec_t", "ell_spmv_plain",
           "ell_matvec_ref"]


def ell_spmv_plain(vals_t: torch.Tensor, cols_t: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: float32 (N,) result.

    Columns must lie in [0, len(x)); indexing raises on one that does
    not."""
    return (vals_t.float() * x.float()[cols_t.long()]).sum(dim=0)


def ell_matvec_t(vals_t: torch.Tensor, cols_t: torch.Tensor,
                 x: torch.Tensor, out: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """y = A x for ELL-T (K-major) ``vals_t``/``cols_t`` (K, N).

    Writes into ``out`` ((N,) float32) when given — the distributed
    SpMV preallocates its outputs — else allocates it.
    """
    if x.device.type == "cpu":
        y = ell_spmv_plain(vals_t, cols_t, x)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty(vals_t.shape[1], dtype=torch.float32,
                          device=x.device)
    return ell_spmv(vals_t, cols_t, x, out)


def ell_matvec(vals: torch.Tensor, cols: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y = A x for row-major ELL ``vals``/``cols`` (N, K); float32 y.

    The JAX package's public contract: the operands are transposed to
    the K-major layout the kernel reads. Callers that multiply the same
    matrix often store it transposed and call :func:`ell_matvec_t`.
    """
    return ell_matvec_t(vals.T.contiguous(), cols.T.contiguous(), x)
