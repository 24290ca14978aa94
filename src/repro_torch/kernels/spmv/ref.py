"""Plain PyTorch oracles for the ELL SpMV kernel."""
from __future__ import annotations

import torch


def ell_matvec_ref(vals: torch.Tensor, cols: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_k vals[i, k] * x[cols[i, k]].

    Padding convention: padded entries have vals == 0 (cols may point
    anywhere valid), so they contribute nothing.
    """
    return torch.sum(vals * x[cols.long()], dim=1)


def ell_matvec_f32_ref(vals, cols, x):
    return ell_matvec_ref(vals.float(), cols, x.float())
