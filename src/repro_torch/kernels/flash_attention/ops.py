"""Public wrapper for the flash-attention kernel.

Replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py``
(``_flash_kernel``, wrapped by ``ops.flash_attention``) with two CUDA C++
kernels, chosen by dtype and by nothing else:
  - bf16 and fp16: ``csrc/flash_fwd_sm90.cu``, both products on the tensor
    cores (``wgmma``), K/V tiles loaded by TMA through an mbarrier ring;
  - fp32: ``csrc/flash_fwd.cu``, exact fp32 FMAs on the CUDA cores
    (``wgmma`` has no fp32 inputs, and TF32 would miss the fp32 tolerance).
On the H100 the function is bound by its operations (about 17 GFLOP at B=4,
S=1024, H=32, KV=4, hd=64, causal, against 38 MB of traffic). See the notes
at the heads of the sources.

A CPU tensor goes to the plain version (``ref.attention_ref``); a CUDA
tensor launches its dtype's kernel or raises. There is no fallback.

The wrapper is a ``torch.autograd.Function``, as the reference's is a
``custom_vjp``: the forward is the kernel, the backward recomputes the plain
version from the saved inputs and differentiates it. It is not a kernel:
the reference has no backward kernel either.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import load
from .ref import attention_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
HEAD_DIMS = (32, 64, 80, 128)
#: dtype -> (source, C entry point, trailing int arguments before the stream)
ROUTES = {
    torch.bfloat16: (_CSRC / "flash_fwd_sm90.cu", "flash_fwd_sm90", (0,)),
    torch.float16: (_CSRC / "flash_fwd_sm90.cu", "flash_fwd_sm90", (1,)),
    torch.float32: (_CSRC / "flash_fwd.cu", "flash_fwd", ()),
}
#: every source the wrapper may launch, each built once
SOURCES = tuple(dict.fromkeys(src for src, _, _ in ROUTES.values()))


def route(dtype):
    """(source, entry point, extra int arguments) of ``dtype``'s kernel;
    ValueError for a dtype that neither kernel takes."""
    if dtype not in ROUTES:
        raise ValueError(f"flash_attention: dtype {dtype} not in {tuple(ROUTES)}")
    return ROUTES[dtype]


def _entry(source, name, n_extra):
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * (7 + n_extra)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


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


def _forward(q, k, v, causal, window):
    """The forward: the plain version on the CPU, else the kernel."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    source, name, extra = route(q.dtype)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if S == 0 or B == 0:
        raise ValueError("flash_attention: empty batch or sequence")
    if name == "flash_fwd_sm90" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: TMA needs q, k, v 16-byte aligned")
    fn = _entry(source, name, len(extra))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, k.shape[2], hd, int(bool(causal)), int(window), *extra, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
    flash_attention.launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """Forward through ``_forward``; backward through ``attention_ref``,
    recomputed from the saved q, k, v (the reference's ``_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v)
        with torch.no_grad():
            return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_ref(*qkv, causal=ctx.causal, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, window=0, block_q=512, block_k=512):
    """q: (B,S,H,hd); k, v: (B,S,KV,hd). Returns (B,S,H,hd) in q's dtype,
    differentiable in q, k and v. ``block_q``/``block_k`` are the TPU
    kernel's tile sizes: accepted, and without effect on the result."""
    _check(q, k, v)
    return FlashAttention.apply(q, k, v, causal, window)


#: kernel launches since the count was last set to 0 (CPU calls not counted)
flash_attention.launches = 0
