"""tinyllama-1.1b [dense]: llama2-arch small, GQA kv=4. [arXiv:2401.02385; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
    vocab_size=32000,
)


def smoke_config():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=192, vocab_size=256, remat=False)
