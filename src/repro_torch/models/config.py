"""Model configuration for the architecture zoo.

One :class:`ModelConfig` instance per assigned architecture lives in
``repro_torch/configs/<arch>.py``; reduced variants drive CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

MlpKind = Literal["swiglu", "geglu", "relu2", "gelu"]
BlockKind = Literal["attn", "mamba", "rwkv"]


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int | None = None     # defaults to d_ff
    capacity_factor: float = 1.25
    # "einsum": GShard-style dispatch matmuls (paper-era baseline).
    # "gather": take/segment_sum dispatch (beyond-paper optimization).
    dispatch: Literal["einsum", "gather"] = "einsum"
    router_aux_weight: float = 0.01
    # Fields the JAX package lacks (DeepSeek-V3's router; their
    # defaults are the softmax router above). "sigmoid": sigmoid scores,
    # the top-k chosen by score plus a per-layer balancing bias (state,
    # not a parameter), weights from the scores alone, DeepSeek-V3's
    # sequence-wise balance loss.
    scoring: Literal["softmax", "sigmoid"] = "softmax"
    routed_scale: float = 1.0          # the routed weights' factor
    bias_rate: float = 0.0             # the bias's step a train step


@dataclasses.dataclass(frozen=True)
class MlaConfig:
    """Multi-head latent attention (DeepSeek-V2/V3) with full-rank
    queries: keys and values come up from a normed latent of
    ``kv_lora_rank`` a token, and a rotary key part of ``qk_rope_head_dim``
    is shared by every head."""

    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend stub ([audio]/[vlm] archs).

    The brief: frontends are STUBS — input_specs() provides precomputed
    frame/patch embeddings of shape (batch, n_positions, d_frontend); a
    learned projection maps d_frontend -> d_model.
    """

    kind: Literal["audio", "vision"]
    n_positions: int        # frames (audio) or patches (vision)
    d_frontend: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None          # defaults to d_model // n_heads
    mlp: MlpKind = "swiglu"
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    moe: MoeConfig | None = None
    moe_every: int = 1                 # apply MoE MLP every k-th layer
    # Hybrid models: repeating per-period block pattern; n_layers must be
    # a multiple of len(pattern). E.g. Jamba 1:7 attn:mamba.
    pattern: tuple[BlockKind, ...] | None = None
    # SSM / linear-recurrence dims.
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    rwkv_head_dim: int = 64
    # Encoder-decoder (whisper): encoder layer count; decoder uses
    # n_layers. Cross-attention in every decoder layer.
    n_encoder_layers: int = 0
    frontend: FrontendConfig | None = None
    # Attention variants.
    attn_window: int | None = None     # sliding window (None = full)
    attn_logit_softcap: float | None = None
    # Tensor-parallel head padding (Megatron-style): q-heads are padded
    # up to a multiple of this so the heads dim shards evenly; dummy
    # heads are masked out of the output (exact semantics). The launch
    # layer sets this to the model-axis extent; 1 = no padding.
    head_pad_to: int = 1
    # Numerics / training.
    dtype: str = "bfloat16"            # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    z_loss: float = 1e-4
    tie_embeddings: bool = False
    # Fields the JAX package lacks: latent attention in every attention
    # layer, and the leading layers whose MLP is dense (of width d_ff)
    # in a MoE model.
    mla: MlaConfig | None = None
    first_k_dense: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None \
            else self.d_model // self.n_heads

    def head_layout(self) -> tuple[int, int, int]:
        """(stored_kv_heads K, q_per_stored g_p, padded_q_heads Hq_p).

        The TPU-native GQA layout for ``head_pad_to`` = tp-way tensor
        parallelism (vLLM-style): KV heads are *duplicated* r = tp/hkv
        times so the stored-KV dim shards evenly, and q heads are
        arranged in K groups of g_p = ceil(g / r) slots (padded with
        masked dummy heads when g doesn't split evenly). Falls back to
        the unpadded layout (attention replicated on the model axis)
        when no layout with <= 2x q-head waste exists — only hits the
        smallest archs (smollm's 5 kv heads, whisper's 6).
        """
        hq, hkv, tp = self.n_heads, self.n_kv_heads, self.head_pad_to
        g = hq // hkv
        if tp <= 1 or hkv % tp == 0:
            return hkv, g, hq
        if tp % hkv != 0:
            return hkv, g, hq          # no clean duplication: fallback
        r = tp // hkv
        g_p = -(-g // r)               # ceil
        hq_p = hkv * r * g_p
        if hq_p > 2 * hq:
            return hkv, g, hq          # too wasteful: fallback
        return hkv * r, g_p, hq_p

    @property
    def n_heads_padded(self) -> int:
        return self.head_layout()[2]

    @property
    def q_per_kv(self) -> int:
        assert self.n_heads % self.n_kv_heads == 0
        return self.n_heads // self.n_kv_heads

    def block_kinds(self) -> tuple[BlockKind, ...]:
        """Per-layer block kinds, length n_layers."""
        if self.pattern is None:
            kind: BlockKind = "rwkv" if self.family == "ssm" else "attn"
            return tuple([kind] * self.n_layers)
        assert self.n_layers % len(self.pattern) == 0
        reps = self.n_layers // len(self.pattern)
        return tuple(self.pattern) * reps

    def is_moe_layer(self, idx: int) -> bool:
        if self.moe is None or idx < self.first_k_dense:
            return False
        return (idx % self.moe_every) == (self.moe_every - 1)

    def param_count(self) -> float:
        """Analytic parameter count (total, incl. all experts)."""
        c = self
        d, dh = c.d_model, c.head_dim
        total = 2 * c.vocab * d if not c.tie_embeddings else c.vocab * d
        kinds = c.block_kinds()
        for i, kind in enumerate(kinds):
            total += d  # pre-norm scale
            if kind == "attn" and c.mla is not None:
                m = c.mla
                total += d * c.n_heads * m.qk_head_dim        # wq
                total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                total += m.kv_lora_rank                        # kv_norm
                total += m.kv_lora_rank * c.n_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)         # wkvb
                total += c.n_heads * m.v_head_dim * d          # wo
            elif kind == "attn":
                total += d * (c.n_heads * dh) + 2 * d * (c.n_kv_heads * dh)
                total += (c.n_heads * dh) * d
                if c.qkv_bias:
                    total += (c.n_heads + 2 * c.n_kv_heads) * dh
            elif kind == "mamba":
                di = c.mamba_expand * d
                total += d * 2 * di            # in_proj
                total += di * c.mamba_d_conv   # conv
                total += di * (2 * c.mamba_d_state + 1) + di  # x_proj,dt
                total += di * d                # out_proj
                total += di * c.mamba_d_state + di  # A, D
            elif kind == "rwkv":
                # r,k,v,g,o projections + decay/mix params.
                total += 5 * d * d + 4 * d
            total += d  # mlp pre-norm
            if c.is_moe_layer(i):
                de = c.moe.d_expert or c.d_ff
                n_mats = 3 if c.mlp in ("swiglu", "geglu") else 2
                total += (c.moe.n_experts + c.moe.n_shared) * \
                    n_mats * d * de
                total += d * c.moe.n_experts   # router
            else:
                n_mats = 3 if c.mlp in ("swiglu", "geglu") else 2
                total += n_mats * d * c.d_ff
        total += d  # final norm
        # Encoder stack (whisper): attention + dense mlp per layer, plus
        # decoder cross-attention (counted here, used in blocks).
        if c.family == "encdec":
            enc = c.n_encoder_layers * (
                2 * d + d * (c.n_heads * dh) + 2 * d * (c.n_kv_heads * dh)
                + (c.n_heads * dh) * d + 2 * d * c.d_ff)
            cross = c.n_layers * (
                d + d * (c.n_heads * dh) + 2 * d * (c.n_kv_heads * dh)
                + (c.n_heads * dh) * d)
            total += enc + cross
        if c.frontend is not None:
            total += c.frontend.d_frontend * d
        return float(total)

    def active_param_count(self) -> float:
        """Params touched per token (MoE: only routed top-k active)."""
        if self.moe is None:
            return self.param_count()
        c = self
        de = c.moe.d_expert or c.d_ff
        n_mats = 3 if c.mlp in ("swiglu", "geglu") else 2
        n_moe_layers = sum(c.is_moe_layer(i) for i in range(c.n_layers))
        inactive = n_moe_layers * \
            (c.moe.n_experts - c.moe.top_k) * n_mats * c.d_model * de
        return self.param_count() - inactive
