"""Device choice for the port's entry points: CUDA unless asked otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; a host without CUDA raises
    instead of carrying on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
