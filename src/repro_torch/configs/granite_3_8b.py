"""granite-3-8b [dense]: GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab=49155, mlp="swiglu",
)

REDUCED = ModelConfig(
    name="granite-3-8b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab=512, mlp="swiglu",
)
