"""Plain PyTorch version of the Mamba2 SSD chunked scan. Mirror of
``repro.kernels.ssd_scan.ref``.

Inputs (pre-chunked): x (b,nc,Q,H,P), dt (b,nc,Q,H), B,C (b,nc,Q,N),
la = dt * A (log-decay per step) (b,nc,Q,H), D (H,).
Returns y (b, nc*Q, H, P) in x's dtype and the final state (b, H, N, P) in
fp32 -- the contract of ``models/mamba2.ssd_chunked``.

One deliberate difference from the reference: the decay matrix is
``exp(where(causal, seg, -inf))``, not ``where(causal, exp(seg), 0)``. The
values are the same, bit for bit. The gradient differs where the
reference's is NaN: above the diagonal seg is a positive sum of decays,
and once it passes ~88.7 its exp overflows to inf in fp32, so the masked
branch's zero cotangent times inf gives NaN (at random init, full-width
mamba2-2.7b reaches 57-104 in a chunk of 256, past 88.7 in 16 of its 64
layers). The wrapper's backward differentiates this function, so training
through the kernel needs the finite form.
"""
from __future__ import annotations

import torch


def ssd_scan_ref(x, dt, B, C, la, D):
    b, nc, Q, H, P = x.shape
    N = B.shape[-1]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    Bf, Cf = B.float(), C.float()
    h = torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):     # the state is carried from chunk to chunk
        la_c, x_c, b_c, c_c, dt_c = la[:, c], x[:, c], Bf[:, c], Cf[:, c], dt[:, c]
        lcum = torch.cumsum(la_c, dim=1)                             # (b,Q,H)
        seg = lcum[:, :, None, :] - lcum[:, None, :, :]              # (b,Q,Q,H)
        L = torch.exp(torch.where(causal[None, :, :, None], seg, -torch.inf))
        cb = torch.einsum("bin,bjn->bij", c_c, b_c)
        w = cb[..., None] * L
        xdt = x_c.float() * dt_c[..., None]
        y = torch.einsum("bijh,bjhp->bihp", w, xdt)
        y = y + torch.einsum("bin,bhnp->bihp", c_c, h) * torch.exp(lcum)[..., None]
        decay_to_end = torch.exp(lcum[:, -1:, :] - lcum)
        s_c = torch.einsum("bjn,bjhp->bhnp", b_c, xdt * decay_to_end[..., None])
        h = h * torch.exp(lcum[:, -1, :])[..., None, None] + s_c
        ys.append(y)
    y = torch.stack(ys, dim=1).to(x.dtype).reshape(b, nc * Q, H, P)
    y = y + (D[:, None] * x.float().reshape(b, nc * Q, H, P)).to(x.dtype)
    return y, h


def tf32(t):
    """``t`` in fp32 with the 13 low mantissa bits cleared: the value the
    tensor cores read when a wgmma takes raw fp32 as tf32 (truncation)."""
    return (t.float().contiguous().view(torch.int32) & -8192).view(torch.float32)


def ssd_scan_tf32_ref(x, dt, B, C, la, D):
    """The same function as ``ssd_scan_ref``, rounded where the 16-bit CUDA
    route (``csrc/ssd_fwd_sm90.cu``, x in bf16 or fp16, both exact in tf32)
    rounds: each product's operands are read as tf32 (``tf32``), every sum
    and every other step is fp32, and ``D.x`` is added in fp32 before the
    one cast to x's dtype. The four products: ``CB = C.B^T``; ``W.x`` with
    ``W = CB o L o dt_j``; ``C.h``; and the state update
    ``(B o dt o decay_to_end)^T.x``. Past 256 states the kernel takes
    ``C.B^T`` in exact fp32 (its TF32 form put outputs where y cancels past
    the bf16 tolerance at N 512), and so does this model. A chunk past 256
    steps, which the kernel walks as sub-chunks of 256, is modelled whole
    (the same recurrence, its sums in another order); so is a state past
    256, which the kernel cuts into slices of 256 rows. The main path never
    calls it: the tests hold the kernel against it, and it against the
    reference."""
    b, nc, Q, H, P = x.shape
    N = B.shape[-1]
    cb_operand = (lambda t: t.float()) if N > 256 else tf32
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    h = torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        la_c, dt_c = la[:, c].float(), dt[:, c].float()
        c_c, x_c = tf32(C[:, c]), x[:, c].float()
        lcum = torch.cumsum(la_c, dim=1)                             # (b,Q,H)
        seg = lcum[:, :, None, :] - lcum[:, None, :, :]              # (b,Q,Q,H)
        L = torch.where(causal[None, :, :, None], torch.exp(seg), 0.0)
        cb = torch.einsum("bin,bjn->bij", cb_operand(C[:, c]), cb_operand(B[:, c]))
        w = tf32(cb[..., None] * L * dt_c[:, None, :, :])
        y = torch.einsum("bijh,bjhp->bihp", w, x_c)
        y = y + torch.einsum("bin,bhnp->bihp", c_c, tf32(h)) * torch.exp(lcum)[..., None]
        scl = dt_c * torch.exp(lcum[:, -1:, :] - lcum)               # (b,Q,H)
        bd = tf32(B[:, c].float()[:, :, None, :] * scl[..., None])  # (b,Q,H,N)
        s_c = torch.einsum("bjhn,bjhp->bhnp", bd, x_c)
        h = h * torch.exp(lcum[:, -1, :])[..., None, None] + s_c
        ys.append(y + D[:, None] * x_c)
    return torch.stack(ys, dim=1).to(x.dtype).reshape(b, nc * Q, H, P), h
