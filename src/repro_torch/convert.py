"""Weight bridge between the JAX package's param tree and the port's modules.

The JAX tree (``repro.models.Model(cfg).init(key)[0]``) is a nested dict
whose ``layers`` leaves are stacked on a leading ``(n_layers,)`` axis. The
port keeps every per-layer shape of the reference, so conversion is a
rename (``layers/attn/q`` -> ``layers.{i}.attn.q``; for the SSM family
``layers/in_x`` -> ``layers.{i}.in_x``) plus a split of that axis. Both
directions go through numpy; bf16 travels as ``ml_dtypes``' ``bfloat16``,
the dtype JAX hands to numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.model import SSM
from .models.transformer import Transformer


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only this direction needs it, and only for bf16
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def state_dict_from_jax(tree) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` (CPU tensors) for a JAX param tree."""
    sd = {}
    for name, leaf in _flatten(tree):
        if name.startswith("layers."):
            stacked = _to_tensor(leaf)
            rest = name[len("layers."):]
            for i in range(stacked.shape[0]):
                sd[f"layers.{i}.{rest}"] = stacked[i].clone()
        else:
            sd[name] = _to_tensor(leaf)
    return sd


def from_jax(cfg, tree, device=None) -> Transformer | SSM:
    """The port's model for ``cfg.family`` (an :class:`SSM` for ``ssm``, a
    :class:`Transformer` otherwise) on ``device`` (default: CUDA) holding
    the JAX weights."""
    cls = SSM if cfg.family == "ssm" else Transformer
    model = cls(cfg, device=resolve_device(device))
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    return model


def to_jax(model: Transformer | SSM) -> dict:
    """The JAX param tree (numpy leaves, layers stacked) of a port model."""
    tree: dict = {}
    stacked: dict[str, list] = {}
    for name, t in model.state_dict().items():
        if name.startswith("layers."):
            _, idx, rest = name.split(".", 2)
            stacked.setdefault(rest, []).append((int(idx), _to_numpy(t)))
        else:
            tree[name] = _to_numpy(t)
    for rest, items in stacked.items():
        node = tree.setdefault("layers", {})
        *path, leaf = rest.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.stack([a for _, a in sorted(items, key=lambda x: x[0])])
    return tree
