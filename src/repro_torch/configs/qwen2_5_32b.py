"""qwen2.5-32b [dense]: GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab=152064, mlp="swiglu", qkv_bias=True,
    rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="qwen2.5-32b-reduced", family="dense",
    n_layers=2, d_model=80, n_heads=5, n_kv_heads=1,
    d_ff=192, vocab=512, mlp="swiglu", qkv_bias=True,
)
