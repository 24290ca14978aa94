"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 routed top-6 + 2 shared
[hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.models.config import ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840, mlp="swiglu",
    moe=MoeConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
)

REDUCED = ModelConfig(
    name="moonshot-v1-16b-a3b-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=512, mlp="swiglu",
    moe=MoeConfig(capacity_factor=8.0, n_experts=8, top_k=2, n_shared=1, d_expert=96),
)
