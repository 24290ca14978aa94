"""The language model: embeddings -> layer stacks -> logits.

Port of ``repro/models/model.py`` for every family of the configs:
dense and MoE decoders, the RWKV-6 SSM, Jamba's Mamba/attention hybrid,
whisper's encoder-decoder and internvl2's VLM prefix. The reference
scans stacked period parameters with ``lax.scan``; here :class:`LM` is
an ``nn.Module`` holding one :class:`~.params.Params` per layer in an
``nn.ModuleList`` per stage (``encoder`` for enc-dec, ``decoder``) and
loops over them. Parameter names are the reference's Spec paths with
the period axis unstacked (``embed.tokens``, ``decoder.<layer>.mixer.
wq``, ``decoder.<layer>.mlp.experts.wi``, ``final_norm``,
``enc_norm``; ``models/convert.py`` maps a JAX tree onto them). The
vocab is padded up to a multiple of ``VOCAB_PAD`` as in the reference.

The modality frontends are the reference's stubs: the caller passes
precomputed frame or patch embeddings, (B, n_positions, d_frontend), as
``frontend=``. Whisper's go through ``frontend_proj`` and the encoder to
the memory every decoder layer cross-attends to; internvl2's through
``frontend_proj`` to a prefix in front of the text, part of the causal
sequence, whose positions the logits leave out.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, noop_context_fn

from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.models import params as prm
from repro_torch.models.blocks import (LayerDesc, block_decode,
                                       block_forward, block_prefill,
                                       block_specs, init_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed_specs, embed_tokens,
                                       keep_context, logits_out, norm_spec,
                                       rmsnorm)
from repro_torch.models.params import stack_specs

VOCAB_PAD = 2048


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    descs: tuple[LayerDesc, ...]      # one period
    n_periods: int
    causal: bool = True

    @property
    def layers(self) -> tuple[LayerDesc, ...]:
        """Every layer's desc, the stage's causality applied."""
        return tuple(dataclasses.replace(d, causal=self.causal)
                     for d in self.descs) * self.n_periods


def _padded_vocab(v: int) -> int:
    return (v + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


def _period_layout(cfg: ModelConfig) -> tuple[LayerDesc, ...]:
    """Repeating layer pattern (length divides n_layers)."""
    kinds = cfg.block_kinds()
    period = len(cfg.pattern) if cfg.pattern else 1
    if cfg.moe is not None:
        # MoE cadence must align with the period.
        period = math.lcm(period, cfg.moe_every)
    if cfg.first_k_dense:
        # Leading dense layers break the period: one of every layer.
        period = cfg.n_layers
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


def _serving(fn):
    """Run ``fn`` under ``torch.inference_mode()``; on a mesh (inside an
    ``activation_sharding`` context) under ``torch.no_grad()`` instead:
    there DTensor propagates the shardings of composite ops by tracing
    them on meta tensors at the global shapes, which a counting dispatch
    mode (``launch/hlo.py``) cannot tell from the program's own ops."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        mode = torch.no_grad() if shd.current() is not None else \
            torch.inference_mode()
        with mode:
            return fn(*args, **kwargs)
    return wrapped


def _gold(lf: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """lf[..., labels]: the logit of each label. On a mesh the vocab
    dimension is sharded and DTensor cannot gather along it, so there it
    is a sum of the logits under a one-hot mask of the local columns
    (a Partial sum, one small all-reduce): the same value, since every
    other term is an exact zero."""
    if shd.current() is None:
        return torch.gather(lf, -1, labels[..., None])[..., 0]
    cols = torch.arange(lf.shape[-1], device=labels.device)
    return shd.constrain((lf * (cols == labels[..., None])).sum(-1),
                         ("batch", "seq"))


def _logsumexp(lf: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp`` over the vocab (last) dimension. Where that
    dimension is sharded, DTensor's own logsumexp gathers it whole (at
    qwen2.5-32b x train_4k 2.5 GB of f32 logits a microbatch on each
    device); there the max and the sum of the exponentials are reduced
    instead, two all-reduces of one value a position, as XLA partitions
    the reference's logsumexp."""
    last = lf.ndim - 1
    if not any(getattr(p, "dim", None) == last
               for p in getattr(lf, "placements", ())):
        return torch.logsumexp(lf, dim=-1)
    names = ("batch", "seq")
    m = shd.constrain(lf.detach().amax(-1), names)
    s = shd.constrain((lf - m[..., None]).exp().sum(-1), names)
    return s.log() + m


class LM(nn.Module):
    """Decoder LM; also hosts the enc-dec (whisper) and VLM variants.
    ``device=None`` means CUDA (raises without a card); parameters are
    drawn there from ``generator`` (a generator on that device seeded
    with ``seed`` when none is given), in the reference's spec order."""

    #: On a mesh, maps a layer's parameters (a ``Params``, or one
    #: tensor) to what the layer computes with: under FSDP each gathered
    #: over the data axes (``train.step.jit_train_step`` sets it). None:
    #: the parameters as they are.
    param_gather = None

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = dataclasses.replace(cfg, vocab=_padded_vocab(cfg.vocab))
        self.vocab_real = cfg.vocab
        period = _period_layout(self.cfg)
        self.stages = [Stage("decoder", period,
                             self.cfg.n_layers // len(period))]
        self.enc_stage = None
        if self.cfg.family == "encdec":
            self.enc_stage = Stage("encoder",
                                   (LayerDesc(kind="attn", causal=False),),
                                   self.cfg.n_encoder_layers, causal=False)
        self.descs = self.stages[0].layers
        pdt = dtype_of(self.cfg.param_dtype)
        self.dtype = dtype_of(self.cfg.dtype)
        specs = self.layer_specs()
        self.embed = prm.Params(specs["embed"], device=dev, dtype=pdt)
        for st in self.all_stages():
            self.add_module(st.name, nn.ModuleList(
                prm.Params(s, device=dev, dtype=pdt)
                for s in specs[st.name].values()))
        for name in ("final_norm", "enc_norm"):
            if name in specs:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(self.cfg.d_model, device=dev, dtype=pdt),
                    requires_grad=False))
        mc = self.cfg.moe
        for p in self.routers():
            # The sigmoid router's balancing bias and the step's loads
            # (models/moe.py): state, no gradient, not AdamW's.
            for name in ("router_bias", "router_load"):
                p.register_buffer(name, torch.zeros(
                    mc.n_experts, device=dev, dtype=torch.float32))
        if dev.type == "meta":
            return              # shapes only: nothing to draw
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        prm.init(self, specs, generator)

    def routers(self) -> list:
        """The MLP parameters of every decoder layer whose router keeps
        a balancing bias (``scoring="sigmoid"``)."""
        mc = self.cfg.moe
        if mc is None or mc.scoring != "sigmoid":
            return []
        return [p["mlp"] for p, d in zip(self.decoder, self.descs) if d.moe]

    @torch.no_grad()
    def update_router_bias(self) -> None:
        """Once a train step, after the optimizer: each router's bias b_i
        += bias_rate x sign(mean load - load_i), the loads its forwards
        counted since the last update (before capacity drops), which are
        then zeroed (DeepSeek-V3 §2.1.2)."""
        for p in self.routers():
            load = p["router_load"]
            p["router_bias"].add_(torch.sign(load.mean() - load),
                                  alpha=self.cfg.moe.bias_rate)
            load.zero_()

    def all_stages(self) -> list[Stage]:
        """The encoder (enc-dec only), then the decoder."""
        return [s for s in [self.enc_stage] if s] + self.stages

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    @property
    def n_front(self) -> int:
        """Prefix positions the VLM's frontend puts before the text."""
        return self.cfg.frontend.n_positions \
            if self.cfg.family == "vlm" else 0

    # -- parameters --------------------------------------------------------
    def specs(self) -> dict:
        """The reference's spec tree: each period's Specs stacked."""
        cfg = self.cfg
        out: dict = {"embed": embed_specs(cfg)}
        for st in self.all_stages():
            out[st.name] = stack_specs(
                {str(i): block_specs(cfg, d) for i, d in enumerate(st.descs)},
                st.n_periods)
        out["final_norm"] = norm_spec(cfg.d_model)
        if self.enc_stage:
            out["enc_norm"] = norm_spec(cfg.d_model)
        return out

    def layer_specs(self) -> dict:
        """The same Specs one layer at a time, keyed as the module's
        parameters are named."""
        cfg = self.cfg
        out: dict = {"embed": embed_specs(cfg)}
        for st in self.all_stages():
            out[st.name] = {str(i): block_specs(cfg, d)
                            for i, d in enumerate(st.layers)}
        out["final_norm"] = norm_spec(cfg.d_model)
        if self.enc_stage:
            out["enc_norm"] = norm_spec(cfg.d_model)
        return out

    def param_axes(self) -> dict:
        """Logical axes of every parameter, keyed as
        ``named_parameters()`` names them (the reference's stacked
        ``"layers"`` axis unstacked: one entry per layer)."""
        return {path: s.axes
                for path, s in prm.leaves(self.layer_specs())}

    def abstract_params(self) -> dict:
        """Every parameter as a meta tensor of its shape and dtype
        (nothing allocated, nothing drawn), keyed as
        :meth:`param_axes`."""
        pdt = dtype_of(self.cfg.param_dtype)
        return {path: torch.empty(s.shape, dtype=pdt, device="meta")
                for path, s in prm.leaves(self.layer_specs())}

    def n_params(self) -> int:
        return prm.count(self.specs())

    # -- stacks and frontends --------------------------------------------------
    def _run_stage(self, stage: Stage, x: torch.Tensor, *,
                   memory: torch.Tensor | None = None,
                   rwkv_chunk: int | None = None,
                   attention: str = "flash"):
        """Returns (x, the layers' summed MoE aux). With grad enabled and
        ``cfg.remat``, each layer is checkpointed, as the reference
        checkpoints each period (``repro/models/model.py:128-129``); a
        MoE layer with shared experts keeps their output projection's
        output for its recomputation (``layers.keep_context``)."""
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        aux = 0.0
        for p, desc in zip(getattr(self, stage.name), stage.layers):
            kw = dict(memory=memory, rwkv_chunk=rwkv_chunk,
                      attention=attention)
            if remat:
                keep = desc.moe and cfg.moe.n_shared
                x, a = checkpoint(
                    self._block, p, x, desc, use_reentrant=False,
                    context_fn=keep_context if keep else noop_context_fn,
                    **kw)
            else:
                x, a = self._block(p, x, desc, **kw)
            aux = aux + a
        return x, aux

    def _block(self, p, x: torch.Tensor, desc: LayerDesc, **kw):
        return block_forward(self._p(p), x, self.cfg, desc, None, **kw)

    def _p(self, p):
        """What a layer computes with: ``p`` itself, or on a mesh what
        :attr:`param_gather` makes of it. Inside a checkpointed layer,
        so a rematerialised forward gathers again (FSDP's
        reshard-after-forward)."""
        return p if self.param_gather is None else self.param_gather(p)

    def _frontend(self, frontend: torch.Tensor | None) -> torch.Tensor:
        if frontend is None:
            raise ValueError(f"{self.cfg.name}: the {self.cfg.family} "
                             "family needs frontend= embeddings")
        return frontend.to(self.device, self.dtype) @ \
            self._p(self.embed)["frontend_proj"].to(self.dtype)

    def _embed_inputs(self, tokens: torch.Tensor,
                      frontend: torch.Tensor | None):
        """(x, n_front): the tokens' embeddings, behind the VLM prefix."""
        x = embed_tokens(self._p(self.embed), tokens, self.dtype)
        if self.cfg.family != "vlm":
            return x, 0
        fe = self._frontend(frontend)
        return torch.cat([fe, x], dim=1), fe.shape[1]

    def _encode(self, frontend: torch.Tensor | None):
        """The encoder side (whisper): frontend embeddings -> memory, or
        None for a model without an encoder."""
        if self.enc_stage is None:
            return None
        x, _ = self._run_stage(self.enc_stage, self._frontend(frontend))
        return rmsnorm(x, self._p(self.enc_norm), self.cfg.rms_eps)

    # -- forward -------------------------------------------------------------
    def forward(self, tokens: torch.Tensor, *,
                frontend: torch.Tensor | None = None,
                attention: str = "flash",
                rwkv_chunk: int | None = None) -> torch.Tensor:
        """Logits over the text positions, (B, S, padded vocab), in the
        activation dtype (:meth:`logits_and_aux` without the aux)."""
        return self.logits_and_aux(tokens, frontend=frontend,
                                   attention=attention,
                                   rwkv_chunk=rwkv_chunk)[0]

    def logits_and_aux(self, tokens: torch.Tensor, *,
                       frontend: torch.Tensor | None = None,
                       attention: str = "flash",
                       rwkv_chunk: int | None = None):
        """The reference's ``forward``: (logits over the text positions,
        the decoder's summed MoE aux loss). Causal self-attention goes
        through the served flash kernel unless ``attention="plain"``
        (the streaming softmax); under autograd on the card either route
        takes the training kernels where the operands allow
        (``attention.trains_on_kernel``), and elsewhere ``mha`` raises on
        a CUDA operand that needs a gradient (the served kernel has no
        backward); RWKV layers run the chunked form when ``rwkv_chunk``
        is given."""
        memory = self._encode(frontend)
        x, n_front = self._embed_inputs(tokens, frontend)
        x, aux = self._run_stage(self.stages[0], x, memory=memory,
                                 rwkv_chunk=rwkv_chunk, attention=attention)
        x = rmsnorm(x[:, n_front:], self._p(self.final_norm),
                    self.cfg.rms_eps)
        return logits_out(self._p(self.embed), x, self.cfg), aux

    def loss(self, batch: dict, *, attention: str = "flash",
             rwkv_chunk: int | None = None):
        """Next-token CE + z-loss + MoE aux of ``batch`` = {"tokens",
        "labels"} (B, S) int, labels -1 ignored, and "frontend" where the
        family takes one, moved to the model's device. Returns (total,
        {"ce", "z_loss", "aux"}), float32 scalars."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        labels = batch["labels"].to(self.device, torch.int64)
        logits, aux = self.logits_and_aux(
            tokens, frontend=batch.get("frontend"), attention=attention,
            rwkv_chunk=rwkv_chunk)
        lf = logits.float()
        lse = _logsumexp(lf)
        gold = _gold(lf, labels.clamp_min(0))
        mask = (labels >= 0).float()
        n = mask.sum().clamp_min(1.0)
        ce = ((lse - gold) * mask).sum() / n
        zl = cfg.z_loss * ((lse ** 2) * mask).sum() / n
        aux = torch.as_tensor(aux, dtype=torch.float32, device=self.device)
        return ce + zl + aux, {"ce": ce, "z_loss": zl, "aux": aux}

    # -- serving ----------------------------------------------------------------
    def init_caches(self, batch: int, t_max: int,
                    n_memory: int = 0) -> list[dict]:
        """One zeroed cache entry per decoder layer."""
        return [init_cache(self.cfg, d, batch, t_max, n_memory, self.dtype,
                           self.device) for d in self.descs]

    @_serving
    def prefill(self, tokens: torch.Tensor, t_max: int, *,
                frontend: torch.Tensor | None = None,
                attention: str = "flash", rwkv_chunk: int | None = None,
                all_positions: bool = False):
        """Run the prompt (behind the VLM prefix); returns
        (last-position logits (B, 1, V), caches), or with
        ``all_positions`` the logits at every text position (B, S, V).
        ``t_max`` counts the prefix's positions too. Causal
        self-attention goes through the flash kernel unless
        ``attention="plain"``."""
        cfg = self.cfg
        memory = self._encode(frontend)
        x, _ = self._embed_inputs(tokens, frontend)
        caches = []
        for p, desc in zip(self.decoder, self.descs):
            x, _, c = block_prefill(p, x, cfg, desc, None, t_max,
                                    memory=memory, rwkv_chunk=rwkv_chunk,
                                    attention=attention)
            caches.append(c)
        x = x[:, self.n_front:] if all_positions else x[:, -1:]
        x = rmsnorm(x, self.final_norm, cfg.rms_eps)
        return logits_out(self.embed, x, cfg), caches

    @_serving
    def decode_step(self, tokens: torch.Tensor, pos: int,
                    caches: list[dict]):
        """One token for every sequence. tokens: (B, 1); pos: the new
        token's position (behind the VLM prefix). Returns (logits (B, 1,
        V), caches), the caches updated in place."""
        cfg = self.cfg
        x = embed_tokens(self.embed, tokens, self.dtype)
        for p, desc, c in zip(self.decoder, self.descs, caches):
            x, _ = block_decode(p, x, cfg, desc, pos, c)
        x = rmsnorm(x, self.final_norm, cfg.rms_eps)
        return logits_out(self.embed, x, cfg), caches
