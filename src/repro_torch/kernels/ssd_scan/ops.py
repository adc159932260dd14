"""Public wrapper for the Mamba2 SSD chunked-scan kernel (forward only).

Replaces the TPU kernel ``repro/kernels/ssd_scan/kernel.py``
(``_ssd_kernel``, wrapped by ``ops.ssd_scan``) with the CUDA C++ kernel in
``csrc/ssd_fwd.cu``. At the mamba2-2.7b serving shape (b=4, nc=4, Q=256,
H=80, P=64, N=128, x bf16) the scan is bound by bytes (~101 MB against
~16.3 GFLOP); this first version runs every product as fp32 FMAs on the
CUDA cores, one block per (batch, head, P-tile) walking the chunks in
order, and leaves the tensor cores to later work. See the note at the head
of the source.

A CPU tensor goes to the plain version (``ref.ssd_scan_ref``); a CUDA
tensor launches the kernel or raises. There is no fallback.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import load
from .ref import ssd_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_fwd.cu"
X_DTYPES = (torch.float32, torch.bfloat16)
MAX_CHUNK, MAX_STATE, P_TILE = 256, 128, 64


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    fn = lib.ssd_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(x, dt, B, C, la, D):
    if x.dim() != 5:
        raise ValueError("ssd_scan: x must be 5-D (b, nc, Q, H, P)")
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
    if x.dtype not in X_DTYPES:
        raise ValueError(f"ssd_scan: x dtype {x.dtype} not in {X_DTYPES}")
    if any(t.device != x.device for t in (dt, B, C, la, D)):
        raise ValueError("ssd_scan: all inputs must be on one device")


def ssd_scan(x, dt, B, C, la, D):
    """x (b,nc,Q,H,P) f32 or bf16; dt, la (b,nc,Q,H), B, C (b,nc,Q,N) and
    D (H,) f32. Returns y (b, nc*Q, H, P) in x's dtype and h_last
    (b, H, N, P) in fp32."""
    _check(x, dt, B, C, la, D)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, B, C, la, D)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    b, nc, Q, H, P = x.shape
    N = B.shape[-1]
    if not all(t.is_contiguous() for t in (x, dt, B, C, la, D)):
        raise ValueError("ssd_scan: inputs must be contiguous")
    if x.numel() == 0:
        raise ValueError("ssd_scan: empty input")
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {Q} not in [1, {MAX_CHUNK}]")
    if N % 4 or not 4 <= N <= MAX_STATE:
        raise ValueError(f"ssd_scan: state {N} not a multiple of 4 in [4, {MAX_STATE}]")
    if P % 4 or (P > P_TILE and P % P_TILE):
        raise ValueError(f"ssd_scan: head dim {P} not a multiple of 4 up to "
                         f"{P_TILE}, or of {P_TILE}")
    if B.data_ptr() % 16 or C.data_ptr() % 16:
        raise ValueError("ssd_scan: B and C must be 16-byte aligned")
    lib = _lib()
    y = torch.empty((b, nc * Q, H, P), dtype=x.dtype, device=x.device)
    h_last = torch.empty((b, H, N, P), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_fwd(x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
                          la.data_ptr(), D.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                          b, nc, Q, H, P, N, int(x.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"ssd_fwd: CUDA error {err}")
    ssd_scan.launches += 1
    return y, h_last


#: kernel launches since the count was last set to 0 (CPU calls not counted)
ssd_scan.launches = 0
