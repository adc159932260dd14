"""mamba2-2.7b [ssm]: attention-free SSD (state-space duality); decode is a
recurrent state update, so every decode shape (incl. long_500k) runs.
Vocab 50280 padded to 50304 internally. [arXiv:2405.21060; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, ssm_state=128, ssm_headdim=64, ssm_expand=2,
    tie_embeddings=True, subquadratic=True,
)


def smoke_config():
    return CONFIG.replace(n_layers=3, d_model=64, vocab_size=256,
                          ssm_state=16, ssm_headdim=16, ssm_chunk=8,
                          remat=False)
