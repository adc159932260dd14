"""qwen2-moe-a2.7b [moe]: 60 routed experts top-4 + 4 shared experts
(modelled as one dense FFN of 4*1408). [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=151936,
    n_experts=60, n_experts_per_tok=4, moe_d_ff=1408, shared_d_ff=5632,
)


def smoke_config():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=96, moe_d_ff=96, shared_d_ff=96, n_experts=8,
                          n_experts_per_tok=4, vocab_size=256, remat=False)
