"""Frozen arithmetic of the model cells beside ``_yardstick.py``'s: the
bf16 flash kernel's bytes and operations, a prefill's model FLOPs, and
the parameters and train-step FLOPs of a decoder with latent attention
and leading dense layers (Moonlight-16B-A3B). A change to the program
cannot move these.

Bytes count each input byte read once and each output byte written
once; FLOPs count two a multiply-add, and a causal attention the
lower triangle only (half of the S x S products).
"""
from __future__ import annotations

from portbench.metrics._yardstick import moe_param_counts

BF16_BYTES = 2


def flash_bytes(batch: int, heads: int, kv_heads: int, seq: int,
                head_dim: int) -> float:
    """One launch of the bf16 flash kernel over causal self-attention:
    q and o of ``heads``, k and v of ``kv_heads``, bfloat16."""
    return float(BF16_BYTES * batch * seq * head_dim *
                 (2 * heads + 2 * kv_heads))


def flash_flops(batch: int, heads: int, seq: int, head_dim: int) -> float:
    """Its causal products: q k^T and P v, 2 S^2 Dh a head over the
    lower triangle."""
    return 2.0 * batch * heads * seq * seq * head_dim


def prefill_flops(c: dict, batch: int, seq: int) -> float:
    """A prefill of ``batch`` prompts of ``seq`` tokens through a
    decoder of ``moe_param_counts``'s kind: 2 N D on the active
    parameters of the layers (the embedding is a lookup), the head on
    each prompt's last position (the logits a prefill returns), and each
    layer's causal attention."""
    _, active = moe_param_counts(c)
    table = c["vocab"] * c["d_model"]
    layers = active - 2 * table - c["d_model"]         # less embed, head, norm
    head = 2.0 * batch * c["d_model"] * c["vocab"]
    attn = c["layers"] * flash_flops(batch, c["heads"], seq, c["head_dim"])
    return 2.0 * layers * batch * seq + head + attn


def mla_param_counts(c: dict) -> tuple[float, float]:
    """(all, active) parameters of a decoder of ``c["layers"]`` layers,
    each latent attention (full-rank queries of ``q_nope + q_rope`` a
    head, a latent of ``kv_rank`` with its norm, keys' nope part and
    values of ``v_dim`` up from it, the output from heads x ``v_dim``),
    the first ``dense`` with a SwiGLU MLP of ``d_ff``, the others a MoE
    MLP of ``experts`` routed and ``shared`` shared SwiGLU experts of
    ``d_expert``, ``top_k`` routed a token; untied embeddings of
    ``vocab``. The routers' balancing biases are state, not counted."""
    d, h, r = c["d_model"], c["heads"], c["kv_rank"]
    dn, dr, dv = c["q_nope"], c["q_rope"], c["v_dim"]
    de, e, k, sh = c["d_expert"], c["experts"], c["top_k"], c["shared"]
    attn = (d * h * (dn + dr) + d * (r + dr) + r + r * h * (dn + dv) +
            h * dv * d)
    dense = 2 * d + attn + 3 * d * c["d_ff"]
    moe = 2 * d + attn + (e + sh) * 3 * d * de + d * e
    n_moe = c["layers"] - c["dense"]
    total = 2 * c["vocab"] * d + c["dense"] * dense + n_moe * moe + d
    inactive = n_moe * (e - k) * 3 * d * de
    return float(total), float(total - inactive)


def mla_train_flops(c: dict, batch: int, seq: int) -> float:
    """6 N D on the active parameters plus every layer's causal
    attention, forward and backward: 6 L B (S^2 / 2) H (d_qk + d_v)."""
    _, active = mla_param_counts(c)
    attn = 6.0 * c["layers"] * batch * (seq * seq / 2) * c["heads"] * \
        (c["q_nope"] + c["q_rope"] + c["v_dim"])
    return 6.0 * active * batch * seq + attn
