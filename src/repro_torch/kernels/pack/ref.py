"""Plain PyTorch oracle for the pack (gather) kernel."""
from __future__ import annotations

import torch


def pack_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[j] = x[idx[j]] — halo/send-buffer packing."""
    return x[idx.long()]
