"""Public flash-attention entry point.

A tensor on the CPU takes the plain PyTorch version; a tensor on a CUDA
device launches the hand-written kernel (:mod:`.kernel`) or raises.
Padding follows the JAX wrapper (``repro/kernels/flash_attention/
ops.py:mha``), and only where it is needed: Sq and Skv are padded up to
the blocks, padded query rows are sliced off, padded keys are masked by
position (causal only), and the scale comes from the true head dim. The
head dim is padded to the kernel's 64 or 128, not to the TPU's 128-lane
tile. k and v may have fewer heads than q (grouped-query attention: q
head h reads kv head h // g); the kernel reads them so, never widened.
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
    """The kernel's function in plain PyTorch, on its operands: q (B,
    Sq, Hq, D) and k/v (B, Skv, Hkv, D) at any strides, q head h reading
    kv head h // (Hq // Hkv), or q (BH, Sq, D) and k/v (BH, Skv, D), one
    head; float32 softmax with masked scores at -1e30 and their
    probabilities 0, right-aligned causal mask, ``acc / max(l, 1e-30)``
    in q's dtype, laid out as q."""
    if q.dim() == 3:
        return attention_plain(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal, scale=scale)[:, :, 0]
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg * scale, k.float())
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        live = ki <= qi
        s = torch.where(live, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if causal:
        p = torch.where(live, p, 0.0)
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    l = p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]       # (B,Sq,Hkv,g,1)
    out = acc / l.clamp_min(1e-30)
    return out.reshape(b, sq, hq, d).to(q.dtype)


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
    """Multi-head attention. q: (B, H, Sq, D); k, v: (B, H / g, Skv, D),
    q head h reading kv head h // g (g = 1: the reference's ``mha``).
    ``scale`` multiplies q . k (default ``D ** -0.5``, the true D).

    Pads only where a pad is needed (D up to the kernel's, Sq and Skv up
    to the blocks); otherwise the kernel reads the operands at the
    strides they have and writes into a (B, Sq, H, D) buffer, returned
    as its (B, H, Sq, D) view. Raises ``ValueError`` for non-causal
    shapes that are not block aligned and for causal shapes whose q and
    kv padding differ (the JAX wrapper's two asserts). Raises
    ``RuntimeError`` for a CUDA operand that requires grad while grad is
    enabled: the kernel writes its output through ctypes and has no
    backward (nor has the reference's Pallas kernel), so its output
    would carry no gradient.
    """
    if q.device.type != "cpu" and torch.is_grad_enabled() and \
            any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "mha: the flash kernel has no backward; differentiate through "
            "the plain route (attention=\"plain\", "
            "models/attention.py:streaming_attention)")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or \
            h % k.shape[1]:
        raise ValueError(f"mha: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not fit (B, H, Sq, D) and "
                         "(B, H / g, Skv, D)")
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
    _k.check_blocks(dp, block_q, block_k, q.dtype)
    if dp != d:
        q, k, v = (F.pad(x, (0, dp - d)) for x in (q, k, v))
    if pq:
        q = F.pad(q, (0, 0, 0, pq))
    if pk:
        k, v = (F.pad(x, (0, 0, 0, pk)) for x in (k, v))
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))   # (B, S, H, D)
    if q.device.type == "cpu":
        out = attention_plain(qs, ks, vs, causal=causal, scale=scale)
    else:
        qs, ks, vs = (_kernel_ready(x) for x in (qs, ks, vs))
        out = _k.flash_attention(
            qs, ks, vs, torch.empty(qs.shape, dtype=q.dtype,
                                    device=q.device),
            causal=causal, block_q=block_q, block_k=block_k, scale=scale)
    return out.transpose(1, 2)[:, :, :sq, :d]


def _kernel_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernel can read it where it lies (D
    contiguous, rows and base 16-byte aligned), else a contiguous copy."""
    size = x.element_size()
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
            st * size % 16 == 0 for n, st in zip(x.shape[:-1], x.stride())
            if n > 1):
        return x
    return x.contiguous()
