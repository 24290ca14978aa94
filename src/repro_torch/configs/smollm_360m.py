"""smollm-360m [dense]: llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, mlp="swiglu",
)

REDUCED = ModelConfig(
    name="smollm-360m-reduced", family="dense",
    n_layers=2, d_model=96, n_heads=3, n_kv_heads=1,
    d_ff=256, vocab=512, mlp="swiglu",
)
