"""hubert-xlarge [audio]: encoder-only (bidirectional); the conv waveform
frontend is a STUB — input_specs provides precomputed frame embeddings (per
assignment). No decode shapes. [arXiv:2106.07447; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder", input_mode="embeds",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab_size=504, causal=False, supports_decode=False,
)


def smoke_config():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab_size=32, remat=False)
