"""rwkv6-3b [ssm]: Finch — attention-free, data-dependent decay
[arXiv:2404.05892]. Channel-mix uses squared ReLU (RWKV convention)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536, mlp="relu2", rwkv_head_dim=64,
)

REDUCED = ModelConfig(
    name="rwkv6-3b-reduced", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, mlp="relu2", rwkv_head_dim=16,
)
