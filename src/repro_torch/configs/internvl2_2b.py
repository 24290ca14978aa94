"""internvl2-2b [vlm]: InternViT + InternLM2 backbone; the ViT frontend
is a STUB — input_specs() provides precomputed patch embeddings
(batch, 256, 1024) [arXiv:2404.16821]."""
from repro_torch.models.config import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553, mlp="swiglu",
    frontend=FrontendConfig(kind="vision", n_positions=256,
                            d_frontend=1024),
)

REDUCED = ModelConfig(
    name="internvl2-2b-reduced", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, mlp="swiglu",
    frontend=FrontendConfig(kind="vision", n_positions=8, d_frontend=32),
)
