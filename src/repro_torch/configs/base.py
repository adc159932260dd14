"""ModelConfig + the assigned input-shape grid (DESIGN.md §6).

Mirror of ``repro.configs.base`` with ``dtype`` a ``torch.dtype``.

Every architecture file exports ``CONFIG`` (full size, exercised only via
the dry-run) and ``smoke_config()`` (reduced, runs a real step on CPU).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0           # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0
    moe_aux_weight: float = 0.01
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    attn_every: int = 6
    # attention
    causal: bool = True
    sliding_window: int = 0     # 0 = full attention
    rope_theta: float = 10000.0
    # input mode: tokens | embeds (audio frontend stub) | vlm (patch stub)
    input_mode: str = "tokens"
    vision_seq: int = 1152      # VLM: patch-embedding prefix length
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    unroll_layers: bool = False   # python loop instead of lax.scan (used by
    #                               the analytic-roofline validation probe)
    use_flash: bool = False
    use_ssd_kernel: bool = False
    decode_batch_replicated: bool = False

    # which shape cells run (DESIGN.md §6: skips are per-spec, documented)
    supports_decode: bool = True
    subquadratic: bool = False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (embedding included once)."""
        D, L = self.d_model, self.n_layers
        n = 0
        emb = self.vocab_size * D
        if self.input_mode in ("tokens", "vlm"):
            n += emb * (1 if self.tie_embeddings else 2)
        else:
            n += self.vocab_size * D  # classifier head
        if self.family in ("ssm", "hybrid"):
            d_in = self.ssm_expand * D
            H = d_in // self.ssm_headdim
            per = D * (2 * d_in + 2 * self.ssm_state + H) + d_in * D \
                + 4 * (d_in + 2 * self.ssm_state)
            n += per * L
            if self.family == "hybrid":
                hd = D // self.n_heads
                attn = 2 * D * (self.n_heads + 2 * self.n_kv_heads) * hd \
                    + self.n_heads * hd * D
                n += attn + 3 * D * self.d_ff
            return n
        hd = self.head_dim or D // self.n_heads
        attn = D * (self.n_heads + 2 * self.n_kv_heads) * hd \
            + self.n_heads * hd * D
        if self.n_experts:
            ffn = 3 * D * self.moe_d_ff * self.n_experts \
                + 3 * D * self.shared_d_ff + D * self.n_experts
        else:
            ffn = 3 * D * self.d_ff
        n += (attn + ffn) * L
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        dense = self.replace(n_experts=0, d_ff=0)
        n = dense.param_count()
        D, L = self.d_model, self.n_layers
        n += (3 * D * self.moe_d_ff * self.n_experts_per_tok
              + 3 * D * self.shared_d_ff + D * self.n_experts) * L
        return n


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """(supported, reason-if-not) per the assignment's skip rules."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full attention is quadratic at 500k (per spec)"
    return True, ""
