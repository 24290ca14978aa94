"""Transformer block assembly: pre-norm attention + dense MLP.

Port of ``repro/models/blocks.py`` for ``kind="attn"`` with a dense MLP,
the layers of every dense config. A :class:`LayerDesc` describes one
layer of a repeating period as in the reference; mamba, rwkv, MoE and
cross-attention sublayers are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, mlp_specs, norm_spec, rmsnorm

# What a sublayer that is not ported yet waits for.
NOT_PORTED = "not ported yet (ROADMAP Queue 1 item 7)"


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    kind: str               # attn | mamba | rwkv
    moe: bool = False
    cross: bool = False
    causal: bool = True


def check_ported(desc: LayerDesc) -> None:
    """Raise ``NotImplementedError`` for a layer the port cannot run."""
    if desc.kind not in ("attn", "mamba", "rwkv"):
        raise ValueError(desc.kind)
    for what, missing in ((f"{desc.kind} blocks", desc.kind != "attn"),
                          ("MoE MLPs", desc.moe),
                          ("cross-attention sublayers", desc.cross)):
        if missing:
            raise NotImplementedError(f"{what} are {NOT_PORTED}")


def block_specs(cfg: ModelConfig, desc: LayerDesc) -> dict:
    check_ported(desc)
    d = cfg.d_model
    return {"norm_mix": norm_spec(d), "mixer": attn.attention_specs(cfg),
            "norm_mlp": norm_spec(d), "mlp": mlp_specs(cfg)}


def _mlp_part(p, x: torch.Tensor, cfg: ModelConfig, desc: LayerDesc):
    h = rmsnorm(x, p["norm_mlp"], cfg.rms_eps)
    return x + mlp(p["mlp"], h, cfg.mlp), 0.0


def block_forward(p, x: torch.Tensor, cfg: ModelConfig, desc: LayerDesc,
                  positions: torch.Tensor | None, *,
                  attention: str = "flash"):
    """Full-sequence mode. Returns (x, aux); ``positions=None`` means
    ``arange(S)`` (the kernel's route)."""
    check_ported(desc)
    h = rmsnorm(x, p["norm_mix"], cfg.rms_eps)
    x = x + attn.attn_forward(p["mixer"], h, cfg, positions,
                              causal=desc.causal, attention=attention)
    return _mlp_part(p, x, cfg, desc)


def init_cache(cfg: ModelConfig, desc: LayerDesc, batch: int, t_max: int,
               dtype: torch.dtype, device: torch.device) -> dict:
    check_ported(desc)
    shape = (batch, t_max, cfg.head_layout()[0], cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def block_prefill(p, x: torch.Tensor, cfg: ModelConfig, desc: LayerDesc,
                  positions: torch.Tensor | None, t_max: int, *,
                  attention: str = "flash"):
    """Like block_forward but also returns the decode cache entry: the
    stored-width keys and values in rows 0..S-1 of (B, t_max, K, Dh)."""
    check_ported(desc)
    b, s, _ = x.shape
    h = rmsnorm(x, p["norm_mix"], cfg.rms_eps)
    q, k, v = attn.project_qkv(p["mixer"], h, h, cfg)
    pos = positions if positions is not None else \
        torch.arange(s, device=x.device)
    q = attn.rope(q, pos, cfg.rope_theta)
    k = attn.rope(k, pos, cfg.rope_theta)
    k_rep, v_rep = attn.repeat_kv(cfg, k), attn.repeat_kv(cfg, v)
    o = attn.self_attention(q, k_rep, v_rep, cfg, positions,
                            causal=desc.causal, attention=attention)
    x = x + attn.out_proj(p["mixer"], o, cfg)
    cache = init_cache(cfg, desc, b, t_max, k_rep.dtype, x.device)
    cache["k"][:, :s] = k_rep
    cache["v"][:, :s] = v_rep
    x, aux = _mlp_part(p, x, cfg, desc)
    return x, aux, cache


def block_decode(p, x: torch.Tensor, cfg: ModelConfig, desc: LayerDesc,
                 pos: int, cache: dict):
    """Single-token step. x: (B, 1, d). Returns (x, cache); the cache's
    row ``pos`` is written in place."""
    check_ported(desc)
    h = rmsnorm(x, p["norm_mix"], cfg.rms_eps)
    y, _, _ = attn.attn_decode(p["mixer"], h, cfg, pos, cache["k"],
                               cache["v"])
    x, _ = _mlp_part(p, x + y, cfg, desc)
    return x, cache
