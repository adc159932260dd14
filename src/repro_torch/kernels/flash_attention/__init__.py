from .ops import flash_attention
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref
