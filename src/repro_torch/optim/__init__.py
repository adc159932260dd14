from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update, adamw_update_plain,
                    global_norm, schedule)
from .compression import (compressed_grads, compressed_psum, dequantize_int8,
                          quantize_int8)
