"""Plain PyTorch oracle for the flash-attention kernel."""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, H, Skv, D). Softmax in f32."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (d ** -0.5)
    if causal:
        # Aligned on the right: query i attends keys <= i + (Skv - Sq).
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
