from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm,
                    schedule)
