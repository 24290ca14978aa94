"""The language model: embeddings -> layer stack -> logits.

Port of ``repro/models/model.py`` for the dense decoder-only configs.
The reference scans stacked period parameters with ``lax.scan``; here
:class:`LM` is an ``nn.Module`` holding one :class:`~.params.Params` per
layer in an ``nn.ModuleList`` and loops over them. Parameter names are
the reference's Spec paths with the period axis unstacked
(``embed.tokens``, ``decoder.<layer>.mixer.wq``, ``final_norm``;
``models/convert.py`` maps a JAX tree onto them). The vocab is padded up
to a multiple of ``VOCAB_PAD`` as in the reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import params as prm
from repro_torch.models.blocks import (NOT_PORTED, LayerDesc, block_decode,
                                       block_forward, block_prefill,
                                       block_specs, init_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed_specs, embed_tokens,
                                       logits_out, norm_spec, rmsnorm)
from repro_torch.models.params import stack_specs

VOCAB_PAD = 2048


def _padded_vocab(v: int) -> int:
    return (v + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


def _period_layout(cfg: ModelConfig) -> tuple[LayerDesc, ...]:
    """Repeating layer pattern (length divides n_layers)."""
    kinds = cfg.block_kinds()
    period = len(cfg.pattern) if cfg.pattern else 1
    if cfg.moe is not None:
        # MoE cadence must align with the period.
        period = math.lcm(period, cfg.moe_every)
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                         f"multiple of the period {period}")
    return tuple(LayerDesc(kind=kinds[i], moe=cfg.is_moe_layer(i),
                           cross=cfg.family == "encdec", causal=True)
                 for i in range(period))


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a config's dtype strings)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class LM(nn.Module):
    """Dense decoder LM. ``device=None`` means CUDA (raises without a
    card); parameters are drawn there from ``generator`` (a generator on
    that device seeded with ``seed`` when none is given)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None, seed: int = 0):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is {NOT_PORTED}")
        dev = resolve_device(device)
        self.cfg = dataclasses.replace(cfg, vocab=_padded_vocab(cfg.vocab))
        self.vocab_real = cfg.vocab
        period = _period_layout(self.cfg)
        self.descs = period * (self.cfg.n_layers // len(period))
        pdt = dtype_of(self.cfg.param_dtype)
        self.dtype = dtype_of(self.cfg.dtype)
        specs = self.layer_specs()
        self.embed = prm.Params(specs["embed"], device=dev, dtype=pdt)
        self.decoder = nn.ModuleList(
            prm.Params(s, device=dev, dtype=pdt)
            for s in specs["decoder"].values())
        self.final_norm = nn.Parameter(
            torch.empty(self.cfg.d_model, device=dev, dtype=pdt),
            requires_grad=False)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        prm.init(self, specs, generator)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    # -- parameters --------------------------------------------------------
    def specs(self) -> dict:
        """The reference's spec tree: each period's Specs stacked."""
        cfg = self.cfg
        period = _period_layout(cfg)
        return {"embed": embed_specs(cfg),
                "decoder": stack_specs(
                    {str(i): block_specs(cfg, d)
                     for i, d in enumerate(period)},
                    cfg.n_layers // len(period)),
                "final_norm": norm_spec(cfg.d_model)}

    def layer_specs(self) -> dict:
        """The same Specs one layer at a time, keyed as the module's
        parameters are named."""
        cfg = self.cfg
        return {"embed": embed_specs(cfg),
                "decoder": {str(i): block_specs(cfg, d)
                            for i, d in enumerate(self.descs)},
                "final_norm": norm_spec(cfg.d_model)}

    def n_params(self) -> int:
        return prm.count(self.specs())

    # -- forward -------------------------------------------------------------
    def forward(self, tokens: torch.Tensor, *,
                attention: str = "flash") -> torch.Tensor:
        """Logits over every position, (B, S, padded vocab), in the
        activation dtype. Attention goes through the flash kernel unless
        ``attention="plain"`` (the streaming softmax, the route that
        trains: the kernel has no backward, and ``mha`` raises on a CUDA
        operand that needs a gradient). With grad enabled and
        ``cfg.remat``, each layer is checkpointed, as the reference
        checkpoints each period (``repro/models/model.py:128-129``)."""
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        x = embed_tokens(self.embed, tokens, self.dtype)
        for p, desc in zip(self.decoder, self.descs):
            if remat:
                x, _ = checkpoint(block_forward, p, x, cfg, desc, None,
                                  attention=attention, use_reentrant=False)
            else:
                x, _ = block_forward(p, x, cfg, desc, None,
                                     attention=attention)
        x = rmsnorm(x, self.final_norm, cfg.rms_eps)
        return logits_out(self.embed, x, cfg)

    def loss(self, batch: dict, *, attention: str = "flash"):
        """Next-token CE (+ z-loss + MoE aux, 0 for the dense family) of
        ``batch`` = {"tokens", "labels"} (B, S) int, labels -1 ignored,
        moved to the model's device. Returns (total, {"ce", "z_loss",
        "aux"}), float32 scalars."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        labels = batch["labels"].to(self.device, torch.int64)
        lf = self.forward(tokens, attention=attention).float()
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.clamp_min(0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        n = mask.sum().clamp_min(1.0)
        ce = ((lse - gold) * mask).sum() / n
        zl = cfg.z_loss * ((lse ** 2) * mask).sum() / n
        aux = torch.zeros((), device=self.device)
        return ce + zl + aux, {"ce": ce, "z_loss": zl, "aux": aux}

    # -- serving ----------------------------------------------------------------
    def init_caches(self, batch: int, t_max: int) -> list[dict]:
        """One zeroed {k, v} cache per layer, (B, t_max, K, Dh)."""
        return [init_cache(self.cfg, d, batch, t_max, self.dtype,
                           self.device) for d in self.descs]

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, t_max: int, *,
                attention: str = "flash"):
        """Run the prompt; returns (last-position logits (B, 1, V),
        caches). Attention goes through the flash kernel unless
        ``attention="plain"`` (the streaming softmax)."""
        cfg = self.cfg
        x = embed_tokens(self.embed, tokens, self.dtype)
        caches = []
        for p, desc in zip(self.decoder, self.descs):
            x, _, c = block_prefill(p, x, cfg, desc, None, t_max,
                                    attention=attention)
            caches.append(c)
        x = rmsnorm(x[:, -1:], self.final_norm, cfg.rms_eps)
        return logits_out(self.embed, x, cfg), caches

    @torch.inference_mode()
    def decode_step(self, tokens: torch.Tensor, pos: int,
                    caches: list[dict]):
        """One token for every sequence. tokens: (B, 1); pos: the new
        token's position. Returns (logits (B, 1, V), caches), the caches
        updated in place."""
        cfg = self.cfg
        x = embed_tokens(self.embed, tokens, self.dtype)
        for p, desc, c in zip(self.decoder, self.descs, caches):
            x, _ = block_decode(p, x, cfg, desc, pos, c)
        x = rmsnorm(x, self.final_norm, cfg.rms_eps)
        return logits_out(self.embed, x, cfg), caches
