"""GQA attention: projections, the padded head layout, prefill through the
Hopper flash-attention kernel, the streaming softmax, and decode.

Port of ``repro/models/attention.py``. The reference runs every shape
through its XLA streaming softmax; its Pallas kernel computes the same
contraction but no model calls it. Here causal self-attention at
positions ``arange(S)`` with every key valid, no window and no softcap
(every prefill and forward call of the dense configs) goes through
``kernels.flash_attention.ops.mha``: on a CUDA tensor that launches the
kernel (csrc/flash_attention.cu) or raises, on a CPU tensor it runs the
kernel's plain version. :func:`streaming_attention` is the plain route:
it serves the CPU when asked for, and the shapes the kernel does not
take (windows, softcap, cross-attention, masked keys, given positions).
It is also the route that trains: the kernel has no backward, so
``mha`` raises on a CUDA operand that needs a gradient, and under
autograd each KV block of :func:`streaming_attention` is checkpointed
(recomputed in the backward pass), as the reference's is.

Layouts follow the reference: activations (B, S, H, Dh); the stored-KV
width K (``cfg.head_layout()[0]``) with q head h reading stored head
h // g.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import constrain, unshard_grad
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rope
from repro_torch.models.params import Spec

NEG_INF = -1e30
ROUTES = ("flash", "plain")


def attention_specs(cfg: ModelConfig) -> dict:
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads_padded, cfg.n_kv_heads
    out = {
        "wq": Spec((d, hq, dh), ("d_model", "heads", "head_dim")),
        "wk": Spec((d, hkv, dh), ("d_model_kv", "kv_heads", "head_dim")),
        "wv": Spec((d, hkv, dh), ("d_model_kv", "kv_heads", "head_dim")),
        "wo": Spec((hq, dh, d), ("heads", "head_dim", "d_model")),
    }
    if cfg.qkv_bias:
        out["bq"] = Spec((hq, dh), ("heads", "head_dim"), init="zeros")
        out["bk"] = Spec((hkv, dh), ("kv_heads", "head_dim"), init="zeros")
        out["bv"] = Spec((hkv, dh), ("kv_heads", "head_dim"), init="zeros")
    return out


def slot_is_real(cfg: ModelConfig) -> list[bool]:
    """Validity per padded q-head slot (see ModelConfig.head_layout).

    Slots are arranged as K stored-KV groups of g_p; stored copy
    c = (slot_group % r) covers real heads [c*g_p, min((c+1)*g_p, g))
    of its true KV head."""
    k, g_p, hq_p = cfg.head_layout()
    r = k // cfg.n_kv_heads
    g = cfg.n_heads // cfg.n_kv_heads
    out = []
    for h in range(hq_p):
        s, i = divmod(h, g_p)
        c = s % r
        out.append(c * g_p + i < g)
    return out


def slot_to_real(cfg: ModelConfig) -> list[int | None]:
    """Real head index per slot (None for dummy slots)."""
    k, g_p, hq_p = cfg.head_layout()
    r = k // cfg.n_kv_heads
    g = cfg.n_heads // cfg.n_kv_heads
    out = []
    for h in range(hq_p):
        s, i = divmod(h, g_p)
        j, c = divmod(s, r)
        real = j * g + c * g_p + i
        out.append(real if c * g_p + i < g else None)
    return out


def head_mask(cfg: ModelConfig,
              device: torch.device) -> torch.Tensor | None:
    """1 for real q-head slots, 0 for padding slots."""
    if cfg.n_heads_padded == cfg.n_heads and \
            cfg.head_layout()[0] == cfg.n_kv_heads:
        return None
    return torch.tensor(slot_is_real(cfg), device=device)


def repeat_kv(cfg: ModelConfig, kv: torch.Tensor) -> torch.Tensor:
    """Duplicate KV heads (axis 2) to the stored-KV width K = r * hkv."""
    k = cfg.head_layout()[0]
    r = k // cfg.n_kv_heads
    if r == 1:
        return kv
    # stored head t is t // r; on a mesh the backward's sum over the r
    # copies needs the stored-head dimension whole.
    return unshard_grad(kv.repeat_interleave(r, dim=2), 2)


def project_qkv(p, xq: torch.Tensor, xkv: torch.Tensor, cfg: ModelConfig):
    dt = xq.dtype
    # On a mesh the streaming attention's backward leaves k's and v's
    # gradients with transposed local shards; a cross sublayer (no rope
    # between) would hand them to the einsum's backward as they are.
    q, k, v = (shd.contiguous_grad(torch.einsum(
        "bsd,dhk->bshk", x, p[w].to(dt)))
        for x, w in ((xq, "wq"), (xkv, "wk"), (xkv, "wv")))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def out_proj(p, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    hm = head_mask(cfg, o.device)
    if hm is not None:
        # Zero padding heads: exact n_heads semantics.
        o = o * hm[None, None, :, None].to(o.dtype)
    # On a mesh the heads' partial sums are reduced here, into the
    # residual stream's placement (XLA does so unasked; DTensor would
    # carry the Partial into the residual).
    return constrain(torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype)),
                     ("batch", "seq", "d_model"))


def q_scale(dh: int, dtype: torch.dtype) -> float:
    """The factor every route multiplies float32 q by: ``dh ** -0.5``
    rounded to q's dtype. The reference writes ``(q * scale)`` in q's
    dtype, then casts to float32; XLA's compiled program (checked on the
    CPU) fuses the product into the cast, so it multiplies float32 q by
    the scale constant, which is rounded to q's dtype, and never rounds
    the product. The kernel, the streaming softmax and decode all do
    that."""
    return float(torch.tensor(dh ** -0.5, dtype=dtype))


def on_shards(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              *rest) -> torch.Tensor:
    """``fn(q, k, v, *rest)``; on a mesh, run on each device's shards of
    batch and heads (``shd.run_local``, the reference's ``shard_map``):
    the attention of one (sequence, stored head) needs no other's, and q
    head h reads stored head h // g, so q's heads and k's and v's stored
    heads shard alike. Inside, on plain local tensors, the model's
    constraints do nothing. Off a mesh (or on plain tensors) ``fn`` runs
    as it is. Without this DTensor would flatten batch and heads, both
    sharded, into one batch dimension of each product, which torch 2.11
    refuses."""
    if shd.current() is None or not isinstance(q, DTensor):
        return fn(q, k, v, *rest)
    q = constrain(q, ("batch", None, "heads", None))
    k = constrain(k, ("batch", None, "kv_stored", None))
    v = constrain(v, ("batch", None, "kv_stored", None))
    if q.placements != k.placements:        # heads shard unlike kv heads
        q, k, v = (shd.gather_dim(x, 2) for x in (q, k, v))
    return shd.run_local(fn, (q, k, v), rest, out_like=q)


def streaming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor,
                        kv_positions: torch.Tensor,
                        kv_valid: torch.Tensor,
                        *, causal: bool = True,
                        window: int | None = None,
                        block_k: int = 1024,
                        softcap: float | None = None) -> torch.Tensor:
    """Online-softmax attention over KV blocks (the plain route).

    q: (B, Sq, Hq, Dh);  k, v: (B, T, K, Dh) where K is the stored-KV
    width (after repeat_kv) and Hq = g_p * K.
    q_positions: (Sq,), kv_positions: (T,), kv_valid: (T,) bool.
    q is scaled as :func:`q_scale` says. The last block is short where
    the reference pads it with invalid keys: the same sums. On a mesh
    each device attends over its own shards (:func:`on_shards`).
    """
    return on_shards(functools.partial(
        _streaming, causal=causal, window=window, block_k=block_k,
        softcap=softcap), q, k, v, q_positions, kv_positions, kv_valid)


def _streaming(q, k, v, q_positions, kv_positions, kv_valid, *, causal,
               window, block_k, softcap):
    b, sq, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    ha = "kv_stored"
    qh = (q.float() * q_scale(dh, q.dtype)).reshape(b, sq, hkv, g, dh)
    qh = qh.permute(0, 2, 3, 1, 4)                 # (B,K,G,Sq,Dh)
    qh = constrain(qh, ("batch", ha, None, None, None))
    k = constrain(k, ("batch", None, ha, None))
    v = constrain(v, ("batch", None, ha, None))
    m = constrain(torch.full_like(qh[..., 0], NEG_INF),
                  ("batch", ha, None, None))
    l = constrain(torch.zeros_like(qh[..., 0]), ("batch", ha, None, None))
    acc = constrain(torch.zeros_like(qh), ("batch", ha, None, None, None))
    # Nested remat, as the reference's: under autograd each block's
    # scores are recomputed in the backward pass, not saved.
    remat = torch.is_grad_enabled()
    for s0 in range(0, t, block_k):
        args = (m, l, acc, qh, k[:, s0:s0 + block_k],
                v[:, s0:s0 + block_k], kv_positions[s0:s0 + block_k],
                kv_valid[s0:s0 + block_k], q_positions, causal, window,
                softcap)
        m, l, acc = checkpoint(_kv_block, *args, use_reentrant=False) \
            if remat else _kv_block(*args)
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)
    return out.to(q.dtype)


def _kv_block(m, l, acc, qh, k, v, kp, kval, q_positions, causal, window,
              softcap):
    """One KV block of :func:`streaming_attention`: the running max,
    sum and accumulator after it."""
    kk, vv = k.float(), v.float()                  # (B,bk,K,Dh)
    s = torch.einsum("bhgqd,bkhd->bhgqk", qh, kk)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = kval[None, :]                            # (1, bk)
    if causal:
        mask = mask & (kp[None, :] <= q_positions[:, None])
    if window is not None:
        mask = mask & (kp[None, :] > q_positions[:, None] - window)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    pr = torch.exp(s - m_new[..., None])
    # Fully-masked blocks: exp(-inf - -inf) == 1; zero them explicitly.
    pr = pr * mask
    corr = torch.exp(m - m_new)
    l = l * corr + pr.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", pr, vv)
    ha = "kv_stored"
    return (constrain(m_new, ("batch", ha, None, None)),
            constrain(l, ("batch", ha, None, None)),
            constrain(acc, ("batch", ha, None, None, None)))


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention at positions ``arange(S)`` through ``mha``.

    q: (B, S, Hq, Dh); k, v: (B, S, K, Dh). The kernel scales q in
    float32 by :func:`q_scale`. KV is widened to one head per q head (q
    head h reads stored head h // g, the reference's (K, g) split) and
    every operand goes to (B, H, S, Dh). On a CUDA tensor the kernel
    launches or ``mha`` raises; nothing here falls back.
    """
    g = q.shape[2] // k.shape[2]

    def heads_first(x):
        return x.transpose(1, 2).contiguous()

    kw, vw = (x.repeat_interleave(g, dim=2) if g > 1 else x for x in (k, v))
    o = mha(heads_first(q), heads_first(kw), heads_first(vw), causal=True,
            scale=q_scale(q.shape[-1], q.dtype))
    return o.transpose(1, 2)


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: ModelConfig, positions: torch.Tensor | None, *,
                   causal: bool, attention: str = "flash") -> torch.Tensor:
    """Self-attention over stored-width k, v. ``positions=None`` means
    ``arange(S)``: with ``attention="flash"``, causal, no window and no
    softcap that goes through the kernel; everything else through
    :func:`streaming_attention`."""
    if attention not in ROUTES:
        raise ValueError(f"attention must be one of {ROUTES}, "
                         f"got {attention!r}")
    if attention == "flash" and positions is None and causal and \
            cfg.attn_window is None and cfg.attn_logit_softcap is None:
        return flash_attention(q, k, v)
    s = q.shape[1]
    if positions is None:
        positions = torch.arange(s, device=q.device)
    return streaming_attention(
        q, k, v, positions, positions,
        torch.ones(s, dtype=torch.bool, device=q.device), causal=causal,
        window=cfg.attn_window, softcap=cfg.attn_logit_softcap)


def attn_forward(p, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor | None, *, causal: bool = True,
                 memory: torch.Tensor | None = None,
                 memory_valid: torch.Tensor | None = None,
                 block_k: int = 1024,
                 attention: str = "flash") -> torch.Tensor:
    """Full-sequence attention (prefill / forward / cross).
    ``positions=None`` means ``arange(S)``."""
    if memory is None:
        q, k, v = project_qkv(p, x, x, cfg)
        pos = positions if positions is not None else \
            torch.arange(x.shape[1], device=x.device)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
        q = constrain(q, ("batch", "seq", "heads", "head_dim"))
        o = self_attention(q, repeat_kv(cfg, k), repeat_kv(cfg, v), cfg,
                           positions, causal=causal, attention=attention)
        o = constrain(o, ("batch", "seq", "heads", "head_dim"))
        return out_proj(p, o, cfg)
    q, k, v = project_qkv(p, x, memory, cfg)
    t = memory.shape[1]
    kv_val = memory_valid if memory_valid is not None else \
        torch.ones(t, dtype=torch.bool, device=x.device)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q = constrain(q, ("batch", "seq", "heads", "head_dim"))
    o = streaming_attention(
        q, repeat_kv(cfg, k), repeat_kv(cfg, v), positions,
        torch.arange(t, device=x.device), kv_val, causal=False,
        window=cfg.attn_window, block_k=block_k,
        softcap=cfg.attn_logit_softcap)
    o = constrain(o, ("batch", "seq", "heads", "head_dim"))
    return out_proj(p, o, cfg)


def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos: int, kv_pos: torch.Tensor,
                      *, window: int | None,
                      softcap: float | None) -> torch.Tensor:
    """Direct masked softmax for Sq == 1: the scores are only (B, Hq, T)
    float32. On a mesh each device attends over its own shards
    (:func:`on_shards`)."""
    return on_shards(functools.partial(
        _decode_core, pos=pos, window=window, softcap=softcap),
        q, k, v, kv_pos)


def _decode_core(q, k, v, kv_pos, *, pos, window, softcap):
    b, _, hq, dh = q.shape
    kk = k.shape[2]
    g = hq // kk
    qh = q[:, 0].reshape(b, kk, g, dh).float() * q_scale(dh, q.dtype)
    qh = constrain(qh, ("batch", "kv_stored", None, None))
    s = torch.einsum("bkgd,btkd->bkgt", qh, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = kv_pos <= pos
    if window is not None:
        mask = mask & (kv_pos > pos - window)
    s = torch.where(mask, s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", pr, v.float())
    return o.reshape(b, 1, hq, dh).to(q.dtype)


def attn_decode(p, x: torch.Tensor, cfg: ModelConfig, pos: int,
                cache_k: torch.Tensor, cache_v: torch.Tensor):
    """Single-token decode. x: (B, 1, D); cache_*: (B, T, K, Dh).

    Writes the new key and value into row ``pos`` of the caches in place
    (the reference returns updated copies) and returns (out (B, 1, D),
    cache_k, cache_v).
    """
    q, k, v = project_qkv(p, x, x, cfg)
    at = torch.tensor([pos], device=x.device)
    q = rope(q, at, cfg.rope_theta)
    k = rope(k, at, cfg.rope_theta)
    cache_k[:, pos] = repeat_kv(cfg, k)[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = repeat_kv(cfg, v)[:, 0].to(cache_v.dtype)
    t = cache_k.shape[1]
    k_att, v_att = cache_k, cache_v
    kv_pos = torch.arange(t, device=x.device)
    if cfg.attn_window is not None and t > 2 * cfg.attn_window:
        # Long-context windowed decode: only the trailing window can
        # attend.
        w = cfg.attn_window
        start = min(max(pos + 1 - w, 0), t - w)
        k_att = cache_k[:, start:start + w]
        v_att = cache_v[:, start:start + w]
        kv_pos = kv_pos[start:start + w]
    o = _decode_attention(q, k_att, v_att, pos, kv_pos,
                          window=cfg.attn_window,
                          softcap=cfg.attn_logit_softcap)
    return out_proj(p, o, cfg), cache_k, cache_v
