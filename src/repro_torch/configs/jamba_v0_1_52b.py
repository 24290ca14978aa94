"""jamba-v0.1-52b [hybrid]: Mamba + attention 1:7 interleave, MoE 16e
top-2 every other layer [arXiv:2403.19887].

long_500k note: at 524k context the attention layers use a sliding
window (the mamba layers carry unbounded context in O(1) state); the
launch layer applies ``attn_window`` for that shape cell only.
"""
from repro_torch.models.config import ModelConfig, MoeConfig

_PATTERN = ("mamba", "mamba", "mamba", "mamba",
            "attn", "mamba", "mamba", "mamba")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, mlp="swiglu",
    pattern=_PATTERN,
    moe=MoeConfig(n_experts=16, top_k=2, n_shared=0, d_expert=14336),
    moe_every=2,
    mamba_d_state=16, mamba_expand=2, mamba_d_conv=4,
)

REDUCED = ModelConfig(
    name="jamba-v0.1-52b-reduced", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, mlp="swiglu",
    pattern=_PATTERN,
    moe=MoeConfig(capacity_factor=8.0, n_experts=4, top_k=2, n_shared=0, d_expert=128),
    moe_every=2,
    mamba_d_state=8, mamba_expand=2, mamba_d_conv=4,
)
