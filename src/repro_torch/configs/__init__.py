"""Architecture registry: ``--arch <id>`` -> ModelConfig."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES: dict[str, str] = {
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
}

ARCHS = list(_MODULES)

#: Architectures of the port alone, which the JAX package does not have
#: (so not in :data:`ARCHS`, which its tests hold equal to the JAX
#: package's list); ``get_config``/``get_reduced`` and the launchers take
#: them too.
PORT_ARCHS = ["moonlight-16b-a3b"]
_MODULES["moonlight-16b-a3b"] = "repro_torch.configs.moonlight_16b_a3b"


def get_config(name: str) -> ModelConfig:
    return importlib.import_module(_MODULES[name]).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return importlib.import_module(_MODULES[name]).REDUCED
