"""deepseek-moe-16b [moe]: 2 shared + 64 routed top-6, fine-grained
experts [arXiv:2401.06066]."""
from repro_torch.models.config import ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, mlp="swiglu",
    moe=MoeConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
)

REDUCED = ModelConfig(
    name="deepseek-moe-16b-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=512, mlp="swiglu",
    moe=MoeConfig(capacity_factor=8.0, n_experts=8, top_k=2, n_shared=1, d_expert=96),
)
