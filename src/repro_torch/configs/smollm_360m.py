"""smollm-360m [dense]: llama-arch small; 15 heads (indivisible by a 16-way
model axis -> attention weights replicate, MLP still TP-shards).
[hf:HuggingFaceTB/SmolLM-135M; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab_size=49152, tie_embeddings=True,
)


def smoke_config():
    return CONFIG.replace(n_layers=2, d_model=60, n_heads=3, n_kv_heads=1,
                          d_ff=160, vocab_size=256, remat=False)
