"""Plain PyTorch oracles for the flash-attention kernel."""
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


def float64_attention(a, dtype: torch.dtype, causal: bool) -> torch.Tensor:
    """The card tests' oracle: a float64 softmax on the CPU of the inputs
    ``a`` (q, k, v as float32 numpy arrays or CPU tensors, (B, H, S, D),
    k and v with H / g heads, q head h reading kv head h // g, v's D may
    differ from q's) rounded to ``dtype`` first, scaled by the true head
    dim, causal mask right-aligned. Float64 tensors that need a gradient
    give one through it (with ``dtype`` float64)."""
    q, k, v = (torch.as_tensor(t).to(dtype).double() for t in a)
    g = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(g, dim=1) for t in (k, v))
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        sq, skv = s.shape[-2:]
        live = torch.arange(skv)[None, :] <= \
            torch.arange(sq)[:, None] + (skv - sq)
        s = s.masked_fill(~live, float("-inf"))
    return torch.softmax(s, -1) @ v
