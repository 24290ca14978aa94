"""Block assembly: pre-norm mixer + (dense|MoE) MLP.

Port of ``repro/models/blocks.py``. A :class:`LayerDesc` describes one
layer of a repeating period: mixer kind (attn / mamba / rwkv), MoE or
dense MLP, an optional cross-attention sublayer (the enc-dec decoder),
causal or bidirectional. The port holds one parameter set per layer
(``models/model.py``), so the period's kinds simply alternate in the
layer list (Jamba's 1:7 interleave).

Caches: attention keeps the stored-width keys and values (B, t_max, K,
Dh), written in place by decode; Mamba keeps (conv (B, d_conv-1, di) in
the activation dtype, h (B, di, N) float32); RWKV (shift (B, d), s (B,
H, N, N) float32); a cross sublayer keeps its memory's keys and values
(ck, cv), widened to the stored width once, at prefill.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import rwkv6 as rwk
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, mlp_specs, norm_spec, rmsnorm
from repro_torch.models.moe import moe_mlp, moe_specs


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    kind: str               # attn | mamba | rwkv
    moe: bool = False
    cross: bool = False
    causal: bool = True


def block_specs(cfg: ModelConfig, desc: LayerDesc) -> dict:
    d = cfg.d_model
    out: dict = {"norm_mix": norm_spec(d)}
    if desc.kind == "attn":
        out["mixer"] = attn.attention_specs(cfg)
    elif desc.kind == "mamba":
        out["mixer"] = mam.mamba_specs(cfg)
    elif desc.kind == "rwkv":
        out["mixer"] = rwk.rwkv_specs(cfg)
    else:
        raise ValueError(desc.kind)
    if desc.cross:
        out["norm_cross"] = norm_spec(d)
        out["cross"] = attn.attention_specs(cfg)
    out["norm_mlp"] = norm_spec(d)
    out["mlp"] = moe_specs(cfg) if desc.moe else mlp_specs(cfg)
    return out


def _mlp_part(p, x: torch.Tensor, cfg: ModelConfig, desc: LayerDesc,
              moe_capacity: int | None = None):
    h = rmsnorm(x, p["norm_mlp"], cfg.rms_eps)
    if desc.moe:
        y, aux = moe_mlp(p["mlp"], h, cfg, capacity=moe_capacity)
    else:
        y, aux = mlp(p["mlp"], h, cfg.mlp), 0.0
    return x + y, aux


def _arange(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], device=x.device)


def _cross_prefill(p, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor | None, memory: torch.Tensor):
    """The cross sublayer over the whole memory: (x, ck, cv), the keys
    and values at the stored width."""
    hc = rmsnorm(x, p["norm_cross"], cfg.rms_eps)
    qc, ck, cv = attn.project_qkv(p["cross"], hc, memory, cfg)
    ck, cv = attn.repeat_kv(cfg, ck), attn.repeat_kv(cfg, cv)
    t = memory.shape[1]
    o = attn.streaming_attention(
        qc, ck, cv, positions if positions is not None else _arange(x),
        _arange(memory), torch.ones(t, dtype=torch.bool, device=x.device),
        causal=False)
    return x + attn.out_proj(p["cross"], o, cfg), ck, cv


def block_forward(p, x: torch.Tensor, cfg: ModelConfig, desc: LayerDesc,
                  positions: torch.Tensor | None, *,
                  memory: torch.Tensor | None = None,
                  rwkv_chunk: int | None = None,
                  attention: str = "flash"):
    """Full-sequence mode. Returns (x, aux); ``positions=None`` means
    ``arange(S)`` (the kernel's route for causal attention)."""
    h = rmsnorm(x, p["norm_mix"], cfg.rms_eps)
    if desc.kind == "attn":
        y = attn.attn_forward(p["mixer"], h, cfg, positions,
                              causal=desc.causal, attention=attention)
    elif desc.kind == "mamba":
        y, _ = mam.mamba_forward(p["mixer"], h, cfg)
    else:
        y, _ = rwk.rwkv_forward(p["mixer"], h, cfg, chunk=rwkv_chunk)
    x = x + y
    if desc.cross:
        h = rmsnorm(x, p["norm_cross"], cfg.rms_eps)
        x = x + attn.attn_forward(p["cross"], h, cfg, positions,
                                  memory=memory)
    return _mlp_part(p, x, cfg, desc)


def init_cache(cfg: ModelConfig, desc: LayerDesc, batch: int, t_max: int,
               n_memory: int, dtype: torch.dtype,
               device: torch.device) -> dict:
    """A zeroed cache entry for one layer."""
    d, dh = cfg.d_model, cfg.head_dim
    hkv = cfg.head_layout()[0]   # stored-KV width (duplicated heads)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if desc.kind == "attn":
        c = {"k": zeros(batch, t_max, hkv, dh),
             "v": zeros(batch, t_max, hkv, dh)}
    elif desc.kind == "mamba":
        di = cfg.mamba_expand * d
        c = {"conv": zeros(batch, cfg.mamba_d_conv - 1, di),
             "h": zeros(batch, di, cfg.mamba_d_state, dt=torch.float32)}
    else:
        n = cfg.rwkv_head_dim
        c = {"shift": zeros(batch, d),
             "s": zeros(batch, d // n, n, n, dt=torch.float32)}
    if desc.cross:
        c["ck"] = zeros(batch, n_memory, hkv, dh)
        c["cv"] = zeros(batch, n_memory, hkv, dh)
    return c


def block_prefill(p, x: torch.Tensor, cfg: ModelConfig, desc: LayerDesc,
                  positions: torch.Tensor | None, t_max: int, *,
                  memory: torch.Tensor | None = None,
                  rwkv_chunk: int | None = None,
                  attention: str = "flash"):
    """Like block_forward but also returns the decode cache entry:
    attention's stored-width keys and values in rows 0..S-1 of (B, t_max,
    K, Dh), or the recurrent state after S tokens."""
    b, s, _ = x.shape
    h = rmsnorm(x, p["norm_mix"], cfg.rms_eps)
    cache: dict = {}
    if desc.kind == "attn":
        q, k, v = attn.project_qkv(p["mixer"], h, h, cfg)
        pos = positions if positions is not None else _arange(x)
        q = attn.rope(q, pos, cfg.rope_theta)
        k = attn.rope(k, pos, cfg.rope_theta)
        k_rep, v_rep = attn.repeat_kv(cfg, k), attn.repeat_kv(cfg, v)
        o = attn.self_attention(q, k_rep, v_rep, cfg, positions,
                                causal=desc.causal, attention=attention)
        y = attn.out_proj(p["mixer"], o, cfg)
        cache = init_cache(cfg, dataclasses.replace(desc, cross=False), b,
                           t_max, 0, k_rep.dtype, x.device)
        cache["k"][:, :s] = k_rep
        cache["v"][:, :s] = v_rep
    elif desc.kind == "mamba":
        y, (cache["conv"], cache["h"]) = mam.mamba_forward(
            p["mixer"], h, cfg)
    else:
        y, (cache["shift"], cache["s"]) = rwk.rwkv_forward(
            p["mixer"], h, cfg, chunk=rwkv_chunk)
    x = x + y
    if desc.cross:
        x, cache["ck"], cache["cv"] = _cross_prefill(p, x, cfg, positions,
                                                     memory)
    x, aux = _mlp_part(p, x, cfg, desc)
    return x, aux, cache


def block_decode(p, x: torch.Tensor, cfg: ModelConfig, desc: LayerDesc,
                 pos: int, cache: dict):
    """Single-token step. x: (B, 1, d). Returns (x, cache): attention's
    row ``pos`` is written in place, a recurrent state replaced in the
    same dict."""
    h = rmsnorm(x, p["norm_mix"], cfg.rms_eps)
    if desc.kind == "attn":
        y, _, _ = attn.attn_decode(p["mixer"], h, cfg, pos, cache["k"],
                                   cache["v"])
    elif desc.kind == "mamba":
        y, (cache["conv"], cache["h"]) = mam.mamba_decode(
            p["mixer"], h, cfg, (cache["conv"], cache["h"]))
    else:
        y, (cache["shift"], cache["s"]) = rwk.rwkv_decode(
            p["mixer"], h, cfg, (cache["shift"], cache["s"]))
    x = x + y
    if desc.cross:
        hc = rmsnorm(x, p["norm_cross"], cfg.rms_eps)
        q = attn.project_qkv(p["cross"], hc, hc, cfg)[0]
        t = cache["ck"].shape[1]
        o = attn._decode_attention(q, cache["ck"], cache["cv"], t,
                                   torch.arange(t, device=x.device),
                                   window=None, softcap=None)
        x = x + attn.out_proj(p["cross"], o, cfg)
    # Decode is dropless: capacity = the batch, one token a group.
    x, _ = _mlp_part(p, x, cfg, desc, moe_capacity=x.shape[0])
    return x, cache
