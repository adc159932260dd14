"""granite-4.0-h-small [moe_hybrid]: IBM Granite 4.0-H Small (32B-A9B,
``granitemoehybrid``). 40 layers of d 4096 in a period of 10: Mamba2
mixers (128 heads x 64, state 128, one B/C group, conv 4 with bias) and,
at layers 5, 15, 25 and 35, GQA attention (32 on 8 heads x 128) with no
position embedding and a softmax scale of 1/128. Every layer then has a
dropless MoE: 72 SwiGLU experts of 768, top-10, the softmax over the
chosen logits, and one ungated shared expert of 1536. The embedding is
scaled by 12, each sublayer's output by 0.22, the logits divided by 16;
tied embeddings. A port-only config: the JAX package has no such family.
[hf:ibm-granite/granite-4.0-h-small config.json]"""
from .base import ModelConfig

#: the published pattern: attention where ``i % 10 == 5``, Mamba2 elsewhere
LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba" for i in range(40))

CONFIG = ModelConfig(
    name="granite-4.0-h-small", family="moe_hybrid",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    vocab_size=100352, n_experts=72, n_experts_per_tok=10, moe_d_ff=768,
    shared_d_ff=1536, ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    tie_embeddings=True, norm_eps=1e-5, subquadratic=False,
    layer_types=LAYER_TYPES, attn_scale=1 / 128,
    embedding_multiplier=12.0, residual_multiplier=0.22, logits_scaling=16.0,
)


def smoke_config():
    """The same 10-layer pattern at a size the CPU runs in a second."""
    return CONFIG.replace(n_layers=10, layer_types=LAYER_TYPES[:10], d_model=64, n_heads=4,
                          n_kv_heads=2, head_dim=16, vocab_size=256, n_experts=8,
                          n_experts_per_tok=3, moe_d_ff=32, shared_d_ff=48, ssm_state=16,
                          ssm_headdim=16, ssm_chunk=8, attn_scale=1 / 16, remat=False)
