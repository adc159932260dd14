"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention (per the
assignment spec) -> SWA makes long_500k decode sub-quadratic with a rolling
W=4096 KV cache. [arXiv:2401.04088; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32768,
    n_experts=8, n_experts_per_tok=2, moe_d_ff=16384,
    sliding_window=4096, subquadratic=True,
)


def smoke_config():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, moe_d_ff=128, n_experts=4,
                          n_experts_per_tok=2, vocab_size=256,
                          sliding_window=16, remat=False)
