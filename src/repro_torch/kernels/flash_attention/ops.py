"""Public wrapper for the flash-attention kernel (forward only).

Replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py``
(``_flash_kernel``, wrapped by ``ops.flash_attention``) with the CUDA C++
kernel in ``csrc/flash_fwd.cu``. On the H100 the kernel is bound by its
operations (about 17 GFLOP at B=4, S=1024, H=32, KV=4, hd=64, causal,
against 38 MB of traffic); this first version runs both products as fp32
FMAs on the CUDA cores, one thread per query row, and leaves the tensor
cores to later work. See the note at the head of the source.

A CPU tensor goes to the plain version (``ref.attention_ref``); a CUDA
tensor launches the kernel or raises. There is no fallback.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import load
from .ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    fn = lib.flash_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, S, heads, hd)")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} heads not a multiple of {KV} KV heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k, v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on one device")


def flash_attention(q, k, v, causal=True, window=0, block_q=512, block_k=512):
    """q: (B,S,H,hd); k, v: (B,S,KV,hd). Returns (B,S,H,hd) in q's dtype.
    ``block_q``/``block_k`` are the TPU kernel's tile sizes: accepted, and
    without effect on the result."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in {DTYPES}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if S == 0 or B == 0:
        raise ValueError("flash_attention: empty batch or sequence")
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                            B, S, H, k.shape[2], hd, int(bool(causal)), int(window),
                            int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_fwd: CUDA error {err}")
    flash_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0 (CPU calls not counted)
flash_attention.launches = 0
