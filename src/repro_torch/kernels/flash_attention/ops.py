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

Both kernels are built for head dims ``WIDTHS``. Any other head dim up to
256 is zero-padded to the next of them: q and k on the contracted axis, v
on the output axis, with the scale of the true width; the output is sliced
back. Zero columns add exactly 0 to q.k, so padding changes no result. A
head dim over 256 (wgmma's largest n) is padded to a multiple of
``WIDE_STEP`` and runs in column passes of at most ``WIDE_BLOCK`` output
columns, one block of the grid each, every pass recomputing q.k over the
whole head dim (``launch_plan``).

A CPU tensor goes to the plain version (``ref.attention_ref``); a CUDA
tensor launches its dtype's kernel or raises. There is no fallback.

The wrapper is a ``torch.autograd.Function``, as the reference's is a
``custom_vjp``. Its backward takes one of two routes, by what it sees:
  - a CUDA bf16 / fp16 call at a width of ``BWD_WIDTHS`` (head dims up to
    128, others padded as the forward pads them): ``csrc/flash_bwd_sm90.cu``,
    dq, dk and dv on the tensor cores from q, k, v, the output, dO and each
    row's log-sum-exp, which the forward then writes beside its output
    (only when autograd will run a backward; a forward under ``no_grad``
    writes none); the same ``run_padded`` pads and slices both;
  - everything else (fp32, head dims past 128, CPU tensors): the
    reference's own ``_bwd``, the plain version recomputed from the saved
    q, k, v and differentiated.
"""
from __future__ import annotations

import math
from ctypes import c_float, c_int, c_void_p
from functools import partial
from pathlib import Path

import torch

from ..build import entry, launch
from .ref import attention_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
#: head dims the kernels are built for; any other up to the last is padded
WIDTHS = (32, 64, 80, 96, 128, 256)
#: past the last width: the head dim padded to a multiple of WIDE_STEP, the
#: output columns in passes of at most WIDE_BLOCK
WIDE_STEP, WIDE_BLOCK = 64, 256
#: each C entry point: (source, name, the types of its arguments before the
#: stream). 16-bit: q, k, v, o, lse; B, S, H, KV, hd, causal, window, is_f16;
#: the scale. fp32: the same without lse and is_f16.
FWD_SM90 = (_CSRC / "flash_fwd_sm90.cu", "flash_fwd_sm90",
            (c_void_p,) * 5 + (c_int,) * 8 + (c_float,))
FWD_FP32 = (_CSRC / "flash_fwd.cu", "flash_fwd", (c_void_p,) * 4 + (c_int,) * 7 + (c_float,))
#: dtype -> (*its entry point, trailing int arguments before the scale)
ROUTES = {
    torch.bfloat16: (*FWD_SM90, (0,)),
    torch.float16: (*FWD_SM90, (1,)),
    torch.float32: (*FWD_FP32, ()),
}
#: the backward kernel: bf16 and fp16 at these widths of ``launch_plan``.
#: q, k, v, o, lse, dO, dq, dk, dv, the rows' (LSE, D) scratch; B, S, H,
#: KV, hd, causal, window, is_f16; the scale
BWD_SOURCE, BWD_ENTRY, BWD_ARGS = (_CSRC / "flash_bwd_sm90.cu", "flash_bwd_sm90",
                                   (c_void_p,) * 10 + (c_int,) * 8 + (c_float,))
BWD_DTYPES = (torch.bfloat16, torch.float16)
BWD_WIDTHS = (32, 64, 80, 96, 128)
#: every source the wrapper may launch, each built once
SOURCES = tuple(dict.fromkeys([*(r[0] for r in ROUTES.values()), BWD_SOURCE]))


def route(dtype):
    """(source, entry point, its argument types, extra int arguments) of
    ``dtype``'s kernel; ValueError for a dtype that neither kernel takes."""
    if dtype not in ROUTES:
        raise ValueError(f"flash_attention: dtype {dtype} not in {tuple(ROUTES)}")
    return ROUTES[dtype]


def bwd_kernel_takes(q):
    """Whether a backward of q's call runs the backward kernel: a CUDA
    bf16 / fp16 tensor whose head dim runs at one of ``BWD_WIDTHS``."""
    return (q.device.type == "cuda" and q.dtype in BWD_DTYPES
            and launch_plan(q.shape[-1])[0] in BWD_WIDTHS)


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


def launch_plan(hd):
    """(width, passes) for head dim ``hd``: up to the last of ``WIDTHS`` the
    least of them that is at least ``hd``, in one pass; past it ``hd``
    rounded up to a multiple of ``WIDE_STEP``, in ceil(width / WIDE_BLOCK)
    column passes."""
    if hd < 1:
        raise ValueError(f"flash_attention: head_dim {hd} < 1")
    for w in WIDTHS:
        if hd <= w:
            return w, 1
    w = -(-hd // WIDE_STEP) * WIDE_STEP
    return w, -(-w // WIDE_BLOCK)


def run_padded(fn, tensors, *args, scale=None):
    """``fn(*tensors, *args, scale)`` at the kernel width of the head dim (the
    last axis of every tensor): each tensor zero-padded on the last axis up to
    ``launch_plan``'s width, ``scale`` by default 1/sqrt(true head dim), and each of
    ``fn``'s outputs (one tensor or a tuple) sliced back. Forward: q, k, v ->
    out; backward: q, k, v, o, dO -> dq, dk, dv, the ``lse`` among ``args``.
    Zero columns add 0 to q.k, to dO.V^T and to rowsum(dO * O), and give zero
    output columns and zero gradient."""
    hd = tensors[0].shape[-1]
    pad = launch_plan(hd)[0] - hd
    if pad:
        tensors = [torch.nn.functional.pad(t, (0, pad)) for t in tensors]
    out = fn(*tensors, *args, 1.0 / math.sqrt(hd) if scale is None else scale)
    if not pad:
        return out
    cut = lambda t: t[..., :hd].contiguous()
    return tuple(map(cut, out)) if isinstance(out, tuple) else cut(out)


def _forward(q, k, v, causal, window, with_lse=False, scale=None):
    """(out, lse): the plain version on the CPU, else the kernel; ``lse``
    is each row's log-sum-exp, (B, H, S) fp32, written by the kernel only
    ``with_lse``, else None. ``scale`` multiplies q.k (None: 1/sqrt(hd))."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale), None
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    route(q.dtype)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    lse = None
    if with_lse:
        B, S, H, _ = q.shape
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    return run_padded(partial(_launch, lse=lse), (q, k, v), causal, window, scale=scale), lse


def _launch(q, k, v, causal, window, scale, lse=None):
    """One launch of the kernel of q's dtype at a width of ``launch_plan``;
    a 16-bit launch also writes ``lse`` unless it is None."""
    B, S, H, hd = q.shape
    source, name, sig, extra = route(q.dtype)
    if S == 0 or B == 0:
        raise ValueError("flash_attention: empty batch or sequence")
    if name == "flash_fwd_sm90" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: TMA needs q, k, v 16-byte aligned")
    # the 16-bit route's entry takes the lse pointer after o
    lse_ptr = (None if lse is None else lse.data_ptr(),) if name == "flash_fwd_sm90" else ()
    fn = entry(source, name, sig)
    out = torch.empty_like(q)
    launch(fn, name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           *lse_ptr, B, S, H, k.shape[2], hd, int(bool(causal)), int(window), *extra, scale)
    flash_attention.launches += 1
    return out


def _launch_bwd(q, k, v, o, do, lse, causal, window, scale):
    """One call of the backward kernel (two launches: dq with each row's
    LSE and D, then dk and dv) at a width of ``BWD_WIDTHS``; counted in
    ``flash_attention.bwd_launches``."""
    B, S, H, hd = q.shape
    if q.dtype not in BWD_DTYPES or hd not in BWD_WIDTHS:
        raise ValueError(f"flash_attention: no backward kernel for {q.dtype} at width {hd}")
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError("flash_attention: TMA needs q, k, v, dO 16-byte aligned")
    fn = entry(BWD_SOURCE, BWD_ENTRY, BWD_ARGS)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # each row's (LSE * log2(e), rowsum(dO * O)), rows up to a multiple of 64
    rowstat = torch.empty((B, H, -(-S // 64) * 64, 2), dtype=torch.float32, device=q.device)
    launch(fn, BWD_ENTRY, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           rowstat.data_ptr(), B, S, H, k.shape[2], hd, int(bool(causal)), int(window),
           int(q.dtype == torch.float16), scale)
    flash_attention.bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Forward through ``_forward``. Backward: with the forward's ``lse``,
    the backward kernel; without it, ``attention_ref`` recomputed from the
    saved q, k, v and differentiated (the reference's ``_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, with_lse, scale):
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        with torch.no_grad():
            out, lse = _forward(q, k, v, causal, window, with_lse, scale)
        ctx.save_for_backward(q, k, v, *(() if lse is None else (out, lse)))
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if len(saved) == 5:
            q, k, v, out, lse = saved
            dq, dk, dv = run_padded(_launch_bwd, (q, k, v, out, g.contiguous()), lse,
                                    ctx.causal, ctx.window, scale=ctx.scale)
            return dq, dk, dv, None, None, None, None
        qkv = [t.detach().requires_grad_() for t in saved]
        with torch.enable_grad():
            out = attention_ref(*qkv, causal=ctx.causal, window=ctx.window, scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=True, window=0, scale=None):
    """q: (B,S,H,hd); k, v: (B,S,KV,hd). Returns (B,S,H,hd) in q's dtype,
    differentiable in q, k and v. ``scale`` multiplies q.k (None:
    1/sqrt(hd))."""
    _check(q, k, v)
    with_lse = (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
                and bwd_kernel_takes(q))
    return FlashAttention.apply(q, k, v, causal, window, with_lse, scale)


#: forward kernel launches since the count was last set to 0 (CPU calls not
#: counted)
flash_attention.launches = 0
#: backward kernel calls (each two launches: dq, then dk and dv) since the
#: count was last set to 0
flash_attention.bwd_launches = 0
