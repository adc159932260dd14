"""Weight bridge between the JAX package's param tree and the port's modules.

The JAX tree (``repro.models.Model(cfg).init(key)[0]``) is a nested dict
whose ``layers`` leaves (zamba2: ``mamba_layers``) are stacked on a leading
``(n_layers,)`` axis; zamba2's ``shared`` block is not stacked. The port
keeps every per-layer shape of the reference, so conversion is a rename
(``layers/attn/q`` -> ``layers.{i}.attn.q``; for the SSM family
``layers/in_x`` -> ``layers.{i}.in_x``; for zamba2
``mamba_layers/in_x`` -> ``mamba_layers.{i}.in_x``) plus a split of that
axis (``jax_path``, ``stack_layers``). Both directions go through numpy; bf16
travels as ``ml_dtypes``' ``bfloat16``, the dtype JAX hands to numpy.
The AdamW state converts the same way: ``m`` and ``v`` are laid out like
the params.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.model import model_class
from .optim import AdamWState

#: the JAX tree's keys whose leaves are stacked on a leading layer axis
STACKED = ("layers", "mamba_layers")


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


def jax_path(name: str) -> tuple[tuple[str, ...], int | None]:
    """Where the port's ``state_dict`` entry ``name`` lives in the JAX tree:
    its key path and, for a layer's tensor, its index on the stacked axis.
    ``layers.3.attn.q`` -> ``(('layers', 'attn', 'q'), 3)``;
    ``mamba_layers.3.in_x`` -> ``(('mamba_layers', 'in_x'), 3)``;
    ``shared.q`` -> ``(('shared', 'q'), None)``."""
    parts = name.split(".")
    if parts[0] in STACKED and len(parts) > 2 and parts[1].isdigit():
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None


class LayerStack(list):
    """The per-layer entries, in layer order, of one leaf that the JAX tree
    stacks on a leading ``(n_layers,)`` axis."""


def stack_layers(named: dict) -> dict:
    """``{JAX key path: entry}`` for a dict keyed by the port's names; the
    entries of ``layers.{i}.rest`` (``mamba_layers.{i}.rest``) are gathered
    into one ``LayerStack``."""
    out: dict = {}
    layers: dict = {}
    for name, val in named.items():
        path, idx = jax_path(name)
        if idx is None:
            out[path] = val
        else:
            layers.setdefault(path, {})[idx] = val
    for path, by_idx in layers.items():
        if sorted(by_idx) != list(range(len(by_idx))):
            raise ValueError(f"{'/'.join(path)}: layers {sorted(by_idx)} are not 0..n-1")
        out[path] = LayerStack(by_idx[i] for i in range(len(by_idx)))
    return out


def state_dict_from_jax(tree) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` (CPU tensors) for a JAX param tree."""
    sd = {}
    for name, leaf in _flatten(tree):
        top, _, rest = name.partition(".")
        if top in STACKED:
            stacked = _to_tensor(leaf)
            for i in range(stacked.shape[0]):
                sd[f"{top}.{i}.{rest}"] = stacked[i].clone()
        else:
            sd[name] = _to_tensor(leaf)
    return sd


def from_jax(cfg, tree, device=None) -> torch.nn.Module:
    """The port's model for ``cfg.family`` (an ``SSM`` for ``ssm``, a
    ``Zamba2`` for ``hybrid``, a ``Transformer`` otherwise) on ``device``
    (default: CUDA) holding the JAX weights."""
    model = model_class(cfg)(cfg, device=resolve_device(device))
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    return model


def named_to_jax(named: dict) -> dict:
    """The JAX tree (numpy leaves, layers stacked) of a port-named dict."""
    tree: dict = {}
    for path, val in stack_layers(named).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (np.stack([_to_numpy(t) for t in val])
                          if isinstance(val, LayerStack) else _to_numpy(val))
    return tree


def to_jax(model: torch.nn.Module) -> dict:
    """The JAX param tree (numpy leaves, layers stacked) of a port model."""
    return named_to_jax(model.state_dict())


def opt_state_from_jax(state, device=None) -> AdamWState:
    """The port's AdamW state for the JAX package's ``AdamWState``: ``m``
    and ``v`` keyed by the port's parameter names, on ``device`` (default:
    CUDA)."""
    device = resolve_device(device)
    move = lambda tree: {k: t.to(device) for k, t in state_dict_from_jax(tree).items()}
    return AdamWState(m=move(state.m), v=move(state.v),
                      count=torch.tensor(int(np.asarray(state.count)), dtype=torch.int32,
                                         device=device))


def opt_state_to_jax(state: AdamWState) -> tuple:
    """``(m, v, count)`` as numpy trees laid out like the JAX params, the
    fields of the JAX package's ``AdamWState`` in order."""
    return (named_to_jax(state.m), named_to_jax(state.v),
            np.asarray(state.count.cpu().numpy(), dtype=np.int32))
