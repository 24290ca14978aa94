"""The plain reference of the paper's SpMV: y = A x from the benchmark's
own ELL arrays, in float64 on the host (NumPy), and its control, the
same product in the precision below the configuration's float32.

Imports nothing of the program. ``rel_gap`` is the number a run
compares: the largest gap of any entry of y, as a share of the largest
|y| of the reference; an entry that is not finite reads infinite.
"""
from __future__ import annotations

import numpy as np


def matvec(vals: np.ndarray, cols: np.ndarray, x: np.ndarray,
           rows: slice = slice(None)) -> np.ndarray:
    """float64 y[rows] = A[rows] x; (n, K) ELL arrays, padding 0.0."""
    v, c = vals[rows], cols[rows]
    return (v.astype(np.float64) * x.astype(np.float64)[c]).sum(axis=1)


def matvec_bf16(vals: np.ndarray, cols: np.ndarray, x: np.ndarray,
                rows: slice = slice(None), device: str = "cpu"
                ) -> np.ndarray:
    """The control: A and x rounded to bfloat16, the products summed in
    float32, as a bfloat16 SpMV kernel would compute y[rows]."""
    import torch

    v = torch.from_numpy(np.ascontiguousarray(vals[rows])).to(device)
    c = torch.from_numpy(np.ascontiguousarray(cols[rows])).to(device).long()
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    v16 = v.to(torch.bfloat16).float()
    x16 = xt.to(torch.bfloat16).float()
    return (v16 * x16[c]).sum(dim=1).cpu().numpy().astype(np.float64)


def rel_gap(y, y_ref: np.ndarray) -> float:
    """max |y - y_ref| / max |y_ref|; inf where y is not finite or has
    another shape."""
    y = np.asarray(y, dtype=np.float64)
    if y.shape != y_ref.shape or not np.isfinite(y).all():
        return float("inf")
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
