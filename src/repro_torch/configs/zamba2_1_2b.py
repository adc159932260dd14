"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block every 6
layers (Zamba concat-with-embedding trick; per-application LoRA omitted,
DESIGN.md). [arXiv:2411.15242; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000, ssm_state=64, ssm_headdim=64, ssm_expand=2,
    attn_every=6, subquadratic=True,
)


def smoke_config():
    return CONFIG.replace(n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab_size=256, ssm_state=16,
                          ssm_headdim=16, ssm_chunk=8, attn_every=2,
                          remat=False)
