"""Public flash-attention entry point.

A tensor on the CPU takes the plain PyTorch version; a tensor on a CUDA
device launches the hand-written kernel (:mod:`.kernel`) or raises.
Padding follows the JAX wrapper (``repro/kernels/flash_attention/
ops.py:mha``): Sq and Skv are padded up to the blocks, padded query rows
are sliced off, padded keys are masked by position (causal only), and
the scale comes from the true head dim. The head dim is padded to the
kernel's 64 or 128, not to the TPU's 128-lane tile.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention.ref import attention_ref  # re-export

__all__ = ["mha", "attention_plain", "attention_ref"]

NEG_INF = -1e30


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on its operands: q (BH,
    Sq, D), k/v (BH, Skv, D); float32 softmax with masked scores at
    -1e30 and their probabilities 0, right-aligned causal mask,
    ``acc / max(l, 1e-30)`` in q's dtype."""
    sq, skv = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float() * scale, k.float())
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        live = ki <= qi
        s = torch.where(live, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if causal:
        p = torch.where(live, p, 0.0)
    acc = torch.einsum("bqk,bkd->bqd", p, v.float())
    return (acc / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def padded_head_dim(d: int) -> int:
    """The kernel head dim that ``d`` is zero-padded to."""
    for hd in _k.HEAD_DIMS:
        if d <= hd:
            return hd
    raise ValueError(f"mha: head dim {d} is above the kernel's largest, "
                     f"{_k.HEAD_DIMS[-1]}")


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, block_q: int = 128, block_k: int = 128,
        scale: float | None = None) -> torch.Tensor:
    """Multi-head attention. q: (B, H, Sq, D); k, v: (B, H, Skv, D).
    ``scale`` multiplies q . k (default ``D ** -0.5``, the true D).

    Raises ``ValueError`` for non-causal shapes that are not block
    aligned and for causal shapes whose q and kv padding differ (the
    JAX wrapper's two asserts). Raises ``RuntimeError`` for a CUDA
    operand that requires grad while grad is enabled: the kernel writes
    its output through ctypes and has no backward (nor has the
    reference's Pallas kernel), so its output would carry no gradient.
    """
    if q.device.type != "cpu" and torch.is_grad_enabled() and \
            any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "mha: the flash kernel has no backward; differentiate through "
            "the plain route (attention=\"plain\", "
            "models/attention.py:streaming_attention)")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    pq = (-sq) % block_q
    pk = (-skv) % block_k
    # Padded kv columns are masked only by the causal mask, and with
    # right-aligned masking the offset comes from the padded shapes.
    if not causal and (pq or pk):
        raise ValueError("mha: non-causal requires block-aligned shapes")
    if causal and pq != pk:
        raise ValueError("mha: causal padding requires pq == pk (use "
                         "equal blocks, sq == skv)")
    dp = padded_head_dim(d)
    if scale is None:
        scale = d ** -0.5
    q = F.pad(q, (0, dp - d, 0, pq))
    k = F.pad(k, (0, dp - d, 0, pk))
    v = F.pad(v, (0, dp - d, 0, pk))
    qf = q.reshape(b * h, sq + pq, dp)
    kf = k.reshape(b * h, skv + pk, dp)
    vf = v.reshape(b * h, skv + pk, dp)
    if q.device.type == "cpu":
        out = attention_plain(qf, kf, vf, causal=causal, scale=scale)
    else:
        out = _k.flash_attention(
            qf.contiguous(), kf.contiguous(), vf.contiguous(),
            torch.empty_like(qf), causal=causal, block_q=block_q,
            block_k=block_k, scale=scale)
    return out.reshape(b, h, sq + pq, dp)[:, :, :sq, :d]
