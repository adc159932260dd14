"""Public wrapper for the Mamba2 SSD chunked-scan kernel.

Replaces the TPU kernel ``repro/kernels/ssd_scan/kernel.py``
(``_ssd_kernel``, wrapped by ``ops.ssd_scan``) with two CUDA C++ kernels,
chosen by x's dtype and by nothing else:
  - bf16 and fp16: ``csrc/ssd_fwd_sm90.cu``, every product a TF32 ``wgmma`` on the
    tensor cores, B/C/CB tiles loaded by TMA through an mbarrier ring, and
    ``C.B^T`` computed once per (batch, chunk) by a first kernel into a
    scratch buffer the wrapper allocates;
  - fp32: ``csrc/ssd_fwd.cu``, exact fp32 FMAs on the CUDA cores (TF32
    would miss the fp32 tolerance).
At the mamba2-2.7b serving shape (b=4, nc=4, Q=256, H=80, P=64, N=128, x
bf16) the scan is bound by bytes (~101 MB against ~16.3 GFLOP). See the
notes at the heads of the sources.

Both kernels take any chunk length Q (past 256 steps a chunk is walked as
sub-chunks of 256, the state carried across them), any state N and any
head dim P. Past ``N_SLICE`` states the state is cut into slices of that
many rows, a block each; each slice's part of y goes to an fp32 scratch
buffer the wrapper allocates, and a last kernel adds the parts in a fixed
order. The wrapper zero-pads B and C to a multiple of 4 columns (TMA and
the float4 loads need 16-byte rows; zero state columns are exact) and, for
the 16-bit route, x to a multiple of 4 columns (its 8-byte copies); h_last
and y are sliced back.

A CPU tensor goes to the plain version (``ref.ssd_scan_ref``); a CUDA
tensor launches its dtype's kernel or raises. There is no fallback.

The wrapper is a ``torch.autograd.Function``, as the reference's is a
``custom_vjp``: the forward is the kernel, the backward recomputes the plain
version from the saved inputs and differentiates it. It is not a kernel:
the reference has no backward kernel either.
"""
from __future__ import annotations

from ctypes import c_int, c_void_p
from pathlib import Path

import torch

from ..build import entry, launch
from .ref import ssd_scan_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
#: each C entry point: (source, name, the types of its arguments before the
#: stream). 16-bit: x, dt, B, C, la, D, y, h_last, the CB scratch, the
#: scratch of the slices' parts of y; b, nc, Q, H, P, N, is_f16. fp32: the
#: same without the CB scratch and is_f16.
FWD_SM90 = (_CSRC / "ssd_fwd_sm90.cu", "ssd_fwd_sm90", (c_void_p,) * 10 + (c_int,) * 7)
FWD_FP32 = (_CSRC / "ssd_fwd.cu", "ssd_fwd", (c_void_p,) * 9 + (c_int,) * 6)
#: x's dtype -> (*its entry point, trailing int arguments before the stream)
ROUTES = {
    torch.bfloat16: (*FWD_SM90, (0,)),
    torch.float16: (*FWD_SM90, (1,)),
    torch.float32: (*FWD_FP32, ()),
}
#: every source the wrapper may launch, each built once
SOURCES = tuple(dict.fromkeys(r[0] for r in ROUTES.values()))
X_DTYPES = tuple(ROUTES)
#: steps of a sub-chunk, the state rows of a slice, the CB tiles' rows
SUB_CHUNK, N_SLICE, TILE = 256, 256, 64


def route(dtype):
    """(source, entry point, its argument types, extra int arguments) of
    the kernel for x of ``dtype``; ValueError for a dtype that neither
    kernel takes."""
    if dtype not in ROUTES:
        raise ValueError(f"ssd_scan: x dtype {dtype} not in {X_DTYPES}")
    return ROUTES[dtype]


def _pad_last(t, mult):
    """``t`` with zero columns appended up to a multiple of ``mult``."""
    pad = -t.shape[-1] % mult
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def _check(x, dt, B, C, la, D):
    if x.dim() != 5:
        raise ValueError("ssd_scan: x must be 5-D (b, nc, Q, H, P)")
    lead = x.shape[:4]
    # one pass on the fast path (the wrapper's host time is part of every
    # prefill layer); the loop below only names what is wrong
    if not (dt.shape == lead and la.shape == lead and B.dim() == 4 and B.shape == C.shape
            and B.shape[:3] == lead[:3] and D.shape == lead[3:]
            and dt.dtype == la.dtype == B.dtype == C.dtype == D.dtype == torch.float32):
        b, nc, Q, H, P = x.shape
        N = B.shape[-1] if B.dim() == 4 else -1
        want = {"dt": (dt, (b, nc, Q, H)), "la": (la, (b, nc, Q, H)),
                "B": (B, (b, nc, Q, N)), "C": (C, (b, nc, Q, N)), "D": (D, (H,))}
        for name, (t, shape) in want.items():
            if tuple(t.shape) != shape:
                raise ValueError(f"ssd_scan: {name} has shape {tuple(t.shape)}, "
                                 f"expected {shape} for x {tuple(x.shape)}")
            if t.dtype != torch.float32:
                raise ValueError(f"ssd_scan: {name} must be float32, not {t.dtype}")
    route(x.dtype)
    dev = x.device
    if not (dt.device == dev and B.device == dev and C.device == dev and la.device == dev
            and D.device == dev):
        raise ValueError("ssd_scan: all inputs must be on one device")


def _forward(x, dt, B, C, la, D):
    """The forward: the plain version on the CPU, else the kernel."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, B, C, la, D)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    b, nc, Q, H, P = x.shape
    N = B.shape[-1]
    if not all(t.is_contiguous() for t in (x, dt, B, C, la, D)):
        raise ValueError("ssd_scan: inputs must be contiguous")
    if x.numel() == 0 or N == 0:
        raise ValueError("ssd_scan: empty input")
    source, name, sig, extra = route(x.dtype)
    # zero columns: a state column of zeros stays 0 and adds 0 to C.h; an x
    # column of zeros gives y and h columns of zeros; both are sliced off
    B, C = _pad_last(B, 4), _pad_last(C, 4)
    if extra:
        x = _pad_last(x, 4)
    Np, Pp = B.shape[-1], x.shape[-1]
    if B.data_ptr() % 16 or C.data_ptr() % 16:
        raise ValueError("ssd_scan: B and C must be 16-byte aligned")
    if extra and x.data_ptr() % 8:
        raise ValueError("ssd_scan: x must be 8-byte aligned")
    fn = entry(source, name, sig)
    y = torch.empty((b, nc * Q, H, Pp), dtype=x.dtype, device=x.device)
    h_last = torch.empty((b, H, Np, Pp), dtype=torch.float32, device=x.device)
    # C.B^T of every (batch, chunk, sub-chunk of 256 steps), 64 x 64 tiles
    # (the 16-bit route only)
    nsub, qt = -(-Q // SUB_CHUNK), min(-(-Q // TILE) * TILE, SUB_CHUNK)
    cb = ([torch.empty((b * nc * nsub, qt, qt), dtype=torch.float32, device=x.device)]
          if extra else [])
    # each slice's part of y, fp32, where N takes two or more slices
    nsl = -(-Np // N_SLICE)
    yp = (torch.empty((nsl, b, nc * Q, H, Pp), dtype=torch.float32, device=x.device)
          if nsl > 1 else None)
    launch(fn, name, x.device, x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
           la.data_ptr(), D.data_ptr(), y.data_ptr(), h_last.data_ptr(),
           *(t.data_ptr() for t in cb), None if yp is None else yp.data_ptr(),
           b, nc, Q, H, Pp, Np, *extra)
    ssd_scan.launches += 1
    if Pp != P:
        y = y[..., :P].contiguous()
    if (Np, Pp) != (N, P):
        h_last = h_last[:, :, :N, :P].contiguous()
    return y, h_last


class SSDScan(torch.autograd.Function):
    """Forward through ``_forward``; backward through ``ssd_scan_ref``,
    recomputed from the saved inputs (the reference's ``_bwd``). A
    gradient of y, of h_last or of both may arrive; an input that the used
    outputs do not depend on (C and D for h_last alone) gets None."""

    @staticmethod
    def forward(ctx, x, dt, B, C, la, D):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, B, C, la, D)
        with torch.no_grad():
            return _forward(x, dt, B, C, la, D)

    @staticmethod
    def backward(ctx, gy, gh):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = [(o, g) for o, g in zip(ssd_scan_ref(*inputs), (gy, gh)) if g is not None]
            if not outs:
                return (None,) * len(inputs)
            return torch.autograd.grad([o for o, _ in outs], inputs, [g for _, g in outs],
                                       allow_unused=True)


def ssd_scan(x, dt, B, C, la, D):
    """x (b,nc,Q,H,P) f32, bf16 or fp16; dt, la (b,nc,Q,H), B, C (b,nc,Q,N) and
    D (H,) f32. Returns y (b, nc*Q, H, P) in x's dtype and h_last
    (b, H, N, P) in fp32, differentiable in all six inputs."""
    _check(x, dt, B, C, la, D)
    return SSDScan.apply(x, dt, B, C, la, D)


#: calls that reached a kernel since the count was last set to 0: one a call,
#: though the 16-bit route launches two kernels (the CB pass, then the scan)
#: and N over 256 one more (the sum of the slices); CPU calls are not counted
ssd_scan.launches = 0
