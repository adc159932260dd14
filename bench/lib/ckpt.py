"""The benchmark's own reader of a committed checkpoint (manifest v1: a
``MANIFEST.json`` naming shard files of raw little-endian bytes, each entry
with its key, shape, dtype name, offset and length; bf16 as the bytes of a
uint16), and the key a saved tensor has in it."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch


def read_checkpoint(step_dir) -> tuple[dict, dict]:
    """(manifest, {key: CPU tensor}) of the checkpoint in ``step_dir``."""
    step_dir = Path(step_dir)
    manifest = json.loads((step_dir / "MANIFEST.json").read_text())
    out = {}
    for frag in manifest["shards"]:
        blob = (step_dir / frag["file"]).read_bytes()
        if len(blob) != frag["total_bytes"]:
            raise IOError(f"{frag['file']}: {len(blob)} bytes, the manifest says "
                          f"{frag['total_bytes']}")
        for key, m in frag["entries"].items():
            raw = np.frombuffer(blob, dtype=np.uint8, count=m["nbytes"], offset=m["offset"])
            if m["dtype"] == "bfloat16":
                t = torch.from_numpy(raw.view(np.uint16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(raw.view(np.dtype(m["dtype"])).copy())
            out[key] = t.reshape(m["shape"])
    return manifest, out


def key_of(prefix: str, name: str) -> tuple[str, int | None]:
    """The checkpoint key of the model's ``state_dict`` entry ``name`` saved
    under ``prefix``, and its row for a layer's tensor: the layers are
    stacked on a leading axis (``layers.3.attn.q`` is row 3 of
    ``['layers']['attn']['q']``); ``name`` "" is the leaf ``prefix`` itself."""
    if not name:
        return prefix, None
    parts = name.split(".")
    row = None
    if parts[0] == "layers" and len(parts) > 2 and parts[1].isdigit():
        row = int(parts[1])
        parts = [parts[0], *parts[2:]]
    return prefix + "".join(f"[{p!r}]" for p in parts), row


def mismatches(saved: dict, by_key: dict) -> list[str]:
    """Names of the tensors of ``saved`` ({(prefix, name): tensor}) that the
    checkpoint lacks or holds with other bytes, shape or dtype."""
    bad = []
    for (prefix, name), t in saved.items():
        key, row = key_of(prefix, name)
        got = by_key.get(key)
        if got is not None and row is not None:
            got = got[row] if got.dim() and row < got.shape[0] else None
        want = t.detach().cpu()
        if got is None or got.dtype != want.dtype or tuple(got.shape) != tuple(want.shape) \
                or not torch.equal(_bytes(got), _bytes(want)):
            bad.append(f"{prefix}{name}")
    return bad


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)
