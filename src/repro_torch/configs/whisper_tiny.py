"""whisper-tiny [audio]: enc-dec transformer backbone; the conv frame
frontend is a STUB — input_specs() provides precomputed frame embeddings
(batch, 1500, 384) [arXiv:2212.04356].

Adaptation note (DESIGN.md): whisper uses learned positions + GELU; the
backbone here uses the framework's RoPE + GELU. The brief specifies the
transformer backbone only.
"""
from repro_torch.models.config import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_encoder_layers=4,
    d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, mlp="gelu",
    frontend=FrontendConfig(kind="audio", n_positions=1500,
                            d_frontend=384),
)

REDUCED = ModelConfig(
    name="whisper-tiny-reduced", family="encdec",
    n_layers=2, n_encoder_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, mlp="gelu",
    frontend=FrontendConfig(kind="audio", n_positions=16, d_frontend=32),
)
