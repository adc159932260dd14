"""How far the SSD-scan kernel and its plain fp32 version each are from the
same scan in float64, on one GPU, at mamba2-2.7b's serving shape.

  python3 scripts/ssd_fp64_check.py

Both fp32 evaluations sum 256 steps x 128 states in different orders, so
they differ from each other by up to a few 1e-6 of the largest output;
this shows whether the kernel is any less accurate than the plain version.
Inputs are drawn as chip_smoke.py draws them (seed 0, x in f32).
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASE = (4, 4, 256, 80, 64, 128)   # (b, nc, Q, H, P, N)


def scan_fp64(torch, x, dt, B, C, la, D):
    """The plain version's algorithm (``ssd_scan_ref``) with every input and
    intermediate in float64."""
    b, nc, Q, H, P = x.shape
    N = B.shape[-1]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    h = torch.zeros((b, H, N, P), dtype=torch.float64, device=x.device)
    ys = []
    for c in range(nc):
        la_c, x_c, b_c, c_c, dt_c = la[:, c], x[:, c], B[:, c], C[:, c], dt[:, c]
        lcum = torch.cumsum(la_c, dim=1)
        seg = lcum[:, :, None, :] - lcum[:, None, :, :]
        L = torch.where(causal[None, :, :, None], torch.exp(seg), 0.0)
        w = torch.einsum("bin,bjn->bij", c_c, b_c)[..., None] * L
        xdt = x_c * dt_c[..., None]
        y = torch.einsum("bijh,bjhp->bihp", w, xdt)
        y = y + torch.einsum("bin,bhnp->bihp", c_c, h) * torch.exp(lcum)[..., None]
        s_c = torch.einsum("bjn,bjhp->bhnp", b_c,
                           xdt * torch.exp(lcum[:, -1:, :] - lcum)[..., None])
        h = h * torch.exp(lcum[:, -1, :])[..., None, None] + s_c
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, nc * Q, H, P)
    return y + D[:, None] * x.reshape(b, nc * Q, H, P), h


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_fp64_check: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.ssd_scan import ops, ssd_scan_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    b, nc, Q, H, P, N = CASE
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    x = randn(b, nc, Q, H, P) * 0.5
    dt = torch.nn.functional.softplus(randn(b, nc, Q, H))
    B, C = randn(b, nc, Q, N), randn(b, nc, Q, N)
    la = dt * -torch.exp(randn(H) * 0.2)
    D = 1 + 0.1 * randn(H)
    args = (x, dt, B, C, la, D)
    exact = scan_fp64(torch, *(t.double() for t in args))
    for name, got in (("kernel", ops.ssd_scan(*args)), ("plain", ssd_scan_ref(*args))):
        for out, ref, what in zip(got, exact, ("y", "h_last")):
            err = (out.double() - ref).abs().max().item()
            print(f"[fp64] {CASE} f32 {name} {what}: max|err| {err:.3g} against "
                  f"float64, max|float64| {ref.abs().max().item():.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
