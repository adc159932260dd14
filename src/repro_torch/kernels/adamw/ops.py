"""Public wrappers for the multi-tensor AdamW kernels.

Replaces no Pallas kernel: the JAX package's AdamW is plain jnp that XLA
fuses, while the port's plain version (``optim.adamw.adamw_update_plain``)
issues ~24 kernels a leaf. ``csrc/adamw.cu`` does a whole tree in three
launches: ``norm`` (every gradient's sum of squares in per-chunk partials,
then a fixed-order finish) and ``update`` (one pass a element, bit for bit
the plain loop's update). See the note at the head of the source.

Both read one leaf table (``table``) of plain CUDA tensors on one device,
which raises on a leaf of a dtype, layout or device the kernels do not
take. There is no fallback; ``optim.adamw.adamw_update`` sends only CUDA
leaves here.
"""
from __future__ import annotations

from array import array
from ctypes import c_float, c_int, c_void_p
from pathlib import Path
from typing import NamedTuple

import torch

from ..build import entry, launch

SOURCE = Path(__file__).resolve().parent / "csrc" / "adamw.cu"
SOURCES = (SOURCE,)
#: each C entry point: (source, name, the types of its arguments before the
#: stream). norm: the table, its rows, the partials, their capacity, out.
#: update: the table, its rows; scale, lr, b1c, b2c (device pointers); b1,
#: 1 - b1, b2, 1 - b2, eps, wd
NORM = (SOURCE, "adamw_norm", (c_void_p, c_int, c_void_p, c_int, c_void_p))
UPDATE = (SOURCE, "adamw_update", (c_void_p, c_int) + (c_void_p,) * 4 + (c_float,) * 6)
#: the dtype tags of the table (the source's ``Dtype``)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: as in the source: leaves a launch, and the elements of a norm partial
MAX_LEAVES, NORM_CHUNK = 512, 32768


class Table(NamedTuple):
    """A tree's leaf table: int64 rows of p, g, m, v, numel, p's and g's
    dtype tags (empty leaves left out), their number, the device, and the
    norm partials the tree needs."""
    rows: array
    n: int
    device: torch.device
    partials: int


def _rows(leaves):
    """(rows, their number, the first leaf's device, the norm partials) of
    ``leaves`` [(p, g, m, v)]; ValueError on a dtype or layout the kernels
    do not take, or on leaves of two devices."""
    rows, n, partials, idx, dev = array("q"), 0, 0, None, None
    for p, g, m, v in leaves:
        numel = g.numel()
        if dev is None:
            idx, dev = p.get_device(), p.device
        pt, gt = DTYPES.get(p.dtype), DTYPES.get(g.dtype)
        if pt is None or gt is None or m.dtype != torch.float32 or v.dtype != torch.float32:
            raise ValueError(f"adamw kernels: p {p.dtype}, g {g.dtype}, m {m.dtype}, v {v.dtype}: "
                             "p and g must be bf16, fp16 or fp32, the moments fp32")
        if not (p.numel() == numel == m.numel() == v.numel()):
            raise ValueError(f"adamw kernels: p, g, m, v of {p.numel()}, {numel}, {m.numel()}, "
                             f"{v.numel()} elements")
        if not (p.is_contiguous() and g.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("adamw kernels: p, g, m and v must be contiguous")
        if not (p.get_device() == g.get_device() == m.get_device() == v.get_device() == idx):
            raise ValueError(f"adamw kernels: every leaf must be on {dev}")
        if numel:
            rows.extend((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), numel, pt, gt))
            n += 1
            partials += -(-numel // NORM_CHUNK)
    if dev is None:
        raise ValueError("adamw kernels: no leaves")
    return rows, n, dev, partials


def table(leaves) -> Table:
    """The table of ``leaves`` [(p, g, m, v)], built anew for every step
    (gradients are freed each step, so their addresses change). ValueError
    on what the kernels do not take."""
    rows, n, dev, partials = _rows(leaves)
    if dev.type != "cuda":
        raise ValueError(f"adamw kernels: no kernel for device {dev}")
    return Table(rows, n, dev, partials)


def _scalar(t, dev, name):
    if not (isinstance(t, torch.Tensor) and t.dim() == 0 and t.dtype == torch.float32
            and t.device == dev):
        raise ValueError(f"adamw kernels: {name} must be a 0-d fp32 tensor on {dev}")
    return t.data_ptr()


def launches(n_leaves: int) -> tuple[int, int]:
    """(norm, update) kernel launches for a tree of ``n_leaves`` non-empty
    leaves."""
    per = -(-n_leaves // MAX_LEAVES)
    return per + 1, per


def norm(t: Table) -> torch.Tensor:
    """The 2-norm of every gradient of the table together, a 0-d fp32
    tensor on its device; the same tensors give the same bits every call."""
    part = torch.empty(max(t.partials, 1), dtype=torch.float32, device=t.device)
    out = torch.empty((), dtype=torch.float32, device=t.device)
    launch(entry(*NORM), NORM[1], t.device, t.rows.buffer_info()[0], t.n, part.data_ptr(),
           t.partials, out.data_ptr())
    norm.launches += launches(t.n)[0]
    return out


def update(t: Table, scale, lr, b1c, b2c, b1: float, b2: float, eps: float,
           weight_decay: float) -> None:
    """One AdamW step over the table's leaves, p, m and v in place.
    ``scale`` is the clip factor (a 0-d fp32 device tensor) or None for
    none; ``lr``, ``b1c``, ``b2c`` 0-d fp32 device tensors; the Python
    floats are rounded to fp32 as torch rounds a scalar operand."""
    dev = t.device
    ptrs = [None if scale is None else _scalar(scale, dev, "scale"), _scalar(lr, dev, "lr"),
            _scalar(b1c, dev, "b1c"), _scalar(b2c, dev, "b2c")]
    launch(entry(*UPDATE), UPDATE[1], dev, t.rows.buffer_info()[0], t.n, *ptrs, b1, 1 - b1, b2,
           1 - b2, eps, weight_decay)
    update.launches += launches(t.n)[1]


#: kernel launches since the count was last set to 0
norm.launches = 0
update.launches = 0
