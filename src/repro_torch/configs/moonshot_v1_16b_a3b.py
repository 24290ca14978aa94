"""moonshot-v1-16b-a3b [moe]: the JAX package's stand-in of that name,
mirrored: deepseek-moe-16b's layer (multi-head attention, a softmax
router, 64 routed top-6 + 2 shared) at 48 layers. It is not
Moonlight-16B-A3B as published (latent attention, a sigmoid router with
a balancing bias, a dense first layer): ``moonlight-16b-a3b`` is."""
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
