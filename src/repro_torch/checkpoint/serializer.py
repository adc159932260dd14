"""Sharded tree serialization, in the JAX package's format (manifest v1).

Mirror of ``repro.checkpoint.serializer``. Leaves are flattened under the
keys ``jax.tree_util.keystr`` gives the same tree in the JAX package, packed
into N balanced shard files of raw bytes and described by a manifest
(written LAST -> atomic commit: a checkpoint without a valid manifest does
not exist). So either package restores what the other wrote.

A tree is a tensor, a NamedTuple (``.field``), a tuple or list (``[i]``) or
a dict (``['key']``, keys sorted as JAX sorts them). A dict keyed by the
port's ``state_dict`` names is laid out as the JAX param tree
(``convert.stack_layers``): ``layers.3.attn.q`` is row 3 of the leaf
``['layers']['attn']['q']``, zamba2's ``mamba_layers.3.in_x`` row 3 of
``['mamba_layers']['in_x']``.

bf16 has no numpy dtype: it is written as the raw bytes of a ``uint16``
view under the dtype name ``"bfloat16"`` (what ``ml_dtypes`` writes for
JAX) and read back the same way, so nothing here needs ``ml_dtypes``.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..convert import LayerStack, jax_path, stack_layers
from ..distributed.sharding import full


def _key(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def flatten_with_paths(tree, prefix: str = ""):
    """``[(key, leaf)]`` in ``jax.tree_util``'s order and under its keys. A
    leaf is a tensor, or a ``LayerStack`` of the per-layer tensors that the
    JAX tree holds as one."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in flatten_with_paths(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, x in enumerate(tree) for kv in flatten_with_paths(x, f"{prefix}[{i}]")]
    if isinstance(tree, dict):
        out = []
        for path, val in sorted(stack_layers(tree).items()):
            key = prefix + _key(path)
            out += [(key, val)] if isinstance(val, LayerStack) else flatten_with_paths(val, key)
        return out
    raise TypeError(f"checkpoint: cannot flatten a {type(tree).__name__} at {prefix!r}")


def to_host(leaf) -> torch.Tensor:
    """A CPU copy of ``leaf`` (a ``LayerStack`` stacked on axis 0), taken
    now: the caller may update the device tensors in place right after. A
    DTensor is gathered whole first, so every rank of its mesh must call
    this."""
    if isinstance(leaf, LayerStack):
        out = torch.empty((len(leaf), *leaf[0].shape), dtype=leaf[0].dtype)
        for i, t in enumerate(leaf):
            out[i].copy_(full(t.detach()))
        return out
    return full(leaf.detach()).to("cpu", copy=True)


def plan_shards(leaves, n_shards: int):
    """Greedy size-balanced assignment: [(shard_idx, [(key, leaf), ...])]."""
    n_shards = max(1, n_shards)
    sizes = [0] * n_shards
    plan = [[] for _ in range(n_shards)]
    for key, leaf in sorted(leaves, key=lambda kl: -kl[1].nbytes):
        i = sizes.index(min(sizes))
        plan[i].append((key, leaf))
        sizes[i] += leaf.nbytes
    return plan


def _raw(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the bytes of ``t`` as a flat uint8 array, its dtype's numpy name)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        arr, name = t.view(torch.int16).numpy(), "bfloat16"
    else:
        arr = t.numpy()
        name = str(arr.dtype)
    return arr.reshape(-1).view(np.uint8), name


def write_shard(path: Path, entries) -> dict:
    """Write one shard file of CPU tensors; returns manifest fragment.
    fsync'd (the paper's experiments bypass page cache the same way)."""
    meta = {}
    offset = 0
    with open(path, "wb") as f:
        for key, t in entries:
            data, dtype = _raw(t)
            f.write(data)
            meta[key] = {"shape": list(t.shape), "dtype": dtype,
                         "offset": offset, "nbytes": int(data.nbytes)}
            offset += int(data.nbytes)
        f.flush()
        os.fsync(f.fileno())
    return {"file": path.name, "entries": meta, "total_bytes": offset}


def _from_raw(buf, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.frombuffer(buf, dtype=np.uint16).reshape(shape)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape))


def read_shard(path: Path, frag: dict, out: dict) -> None:
    size = path.stat().st_size
    if size != frag["total_bytes"]:
        raise IOError(f"shard {path} truncated: {size} != {frag['total_bytes']}")
    blob = bytearray(size)          # writable, so the tensors over it are too
    with open(path, "rb") as f:
        if f.readinto(blob) != size:
            raise IOError(f"shard {path} truncated while reading")
    view = memoryview(blob)
    for key, m in frag["entries"].items():
        out[key] = _from_raw(view[m["offset"]:m["offset"] + m["nbytes"]], m["dtype"],
                             m["shape"])


def _leaf(key, arr, old, row=None):
    """Checkpoint leaf ``arr`` (its row ``row`` for a layer's tensor), checked
    against the shape of ``old`` and put in ``old``'s dtype and device."""
    if arr is None:
        raise KeyError(f"checkpoint missing leaf {key}")
    if row is not None:
        if arr.dim() == 0 or row >= arr.shape[0]:
            raise ValueError(f"checkpoint leaf {key} {tuple(arr.shape)} has no layer {row}")
        arr = arr[row]
    if tuple(arr.shape) != tuple(old.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {tuple(arr.shape)} vs "
                         f"{tuple(old.shape)}")
    return arr.to(device=old.device, dtype=old.dtype)


def unflatten_like(tree, by_key: dict, prefix: str = ""):
    """``tree``'s structure with each leaf read from ``by_key``, in that
    leaf's dtype and on its device (the reference casts to the like tree's
    dtypes and places leaves with ``shardings``)."""
    if isinstance(tree, torch.Tensor):
        return _leaf(prefix, by_key.get(prefix), tree)
    if _is_namedtuple(tree):
        return type(tree)(*(unflatten_like(getattr(tree, f), by_key, f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(unflatten_like(x, by_key, f"{prefix}[{i}]")
                          for i, x in enumerate(tree))
    if isinstance(tree, dict):
        out = {}
        for name, val in tree.items():
            path, row = jax_path(name)
            key = prefix + _key(path)
            out[name] = (unflatten_like(val, by_key, key) if row is None
                         else _leaf(key, by_key.get(key), val, row))
        return out
    raise TypeError(f"checkpoint: cannot restore a {type(tree).__name__} at {prefix!r}")
