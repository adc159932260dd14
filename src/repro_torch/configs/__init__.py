"""Architecture registry: --arch <id> resolves here."""
from . import (granite_20b, granite_34b, hubert_xlarge,
               llava_next_mistral_7b, mamba2_2_7b, mixtral_8x22b,
               qwen2_moe_a2_7b, smollm_360m, tinyllama_1_1b, zamba2_1_2b)
from .base import SHAPES, ModelConfig, ShapeCell, cell_supported

_MODULES = {
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "smollm-360m": smollm_360m,
    "granite-34b": granite_34b,
    "granite-20b": granite_20b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "mixtral-8x22b": mixtral_8x22b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "zamba2-1.2b": zamba2_1_2b,
    "hubert-xlarge": hubert_xlarge,
    "mamba2-2.7b": mamba2_2_7b,
}

ARCHS = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].smoke_config()
