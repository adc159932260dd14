"""llava-next-mistral-7b [vlm]: Mistral-7B backbone, anyres vision frontend
as a STUB (input_specs provides precomputed patch embeddings, per
assignment). [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", input_mode="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, vision_seq=1152,
    subquadratic=False,  # full attention -> long_500k skipped (DESIGN §6)
)


def smoke_config():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=256, vision_seq=8, remat=False)
