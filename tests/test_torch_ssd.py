"""The port's ssd_scan against the JAX package's: on the CPU the port's
wrapper runs its plain version, the JAX wrapper runs the Pallas kernel in
interpret mode. The CUDA kernel itself is held against the plain version by
the test marked ``cuda`` (skipped without a GPU) and by chip_smoke.py.

JAX is imported inside the tests that use it, so that the ``cuda`` tests
also run where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd.py``."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import ops, ssd_scan, ssd_scan_ref, ssd_scan_tf32_ref

# (b, nc, Q, H, P, N): copied from tests/test_kernels.py
SSD_CASES = [
    (1, 4, 32, 8, 32, 16),
    (2, 2, 64, 4, 16, 32),
    (1, 8, 16, 16, 64, 128),
    (1, 2, 128, 8, 64, 64),
]
# the mamba2 smoke config's shape (2 chunks), then one serving prefill of
# mamba2-2.7b (batch 4, 1024 tokens)
SMOKE_CASE = (4, 2, 8, 8, 16, 16)
SLICE_CASE = (4, 4, 256, 80, 64, 128)
# shapes past the serving ones, all of which the JAX kernel takes: chunks
# over 256 steps (the CUDA kernels walk them as sub-chunks of 256), states
# not a multiple of 4 (padded by the wrapper), up to 256 or past it (the
# CUDA kernels cut 320 and 512 into slices of 256 states), head dims that
# end in a ragged P-tile (20, 96) and P = 128
LARGE_CASES = [
    (1, 2, 300, 2, 20, 6),
    (1, 1, 512, 2, 96, 256),
    (1, 2, 300, 2, 128, 256),
    (1, 1, 512, 3, 20, 6),
    (1, 2, 64, 2, 16, 320),
    (1, 2, 128, 2, 20, 512),
]
# f32: the two sides sum in different orders; bf16: the reference's own
# tolerance (tests/test_kernels.py), which also covers the one rounding by
# which the kernel's fp32 D.x add differs from the plain cast-then-add;
# fp16: that rounding is 8x finer (the two sides differed by up to 1e-3 of
# 1 + |y| on the CPU)
DTYPES = [("float32", 1e-4), ("bfloat16", 5e-2), ("float16", 1e-2)]
# the CUDA kernels against the plain version on the card: both 16-bit routes
# take every product in TF32, so fp16 is held to bf16's tolerance there, and
# both to the CPU model of those roundings at MODEL_TOL
CUDA_DTYPES = [("float32", 1e-4), ("bfloat16", 5e-2), ("float16", 5e-2)]
# The bf16 CUDA route against its CPU model (ssd_scan_tf32_ref) on the same
# inputs: |kernel - model| <= 1e-3 max|model| + 1e-2 |model|. They differ
# where a tf32 truncation falls on the other side in one of them (2^-11 of a
# term, the terms up to the size of the largest output) and by a bf16
# rounding of y (2^-8); 5x tighter in relative terms than 5e-2, so a fragment
# layout or mask slip that stays inside 5e-2 still shows
MODEL_TOL = (1e-3, 1e-2)
# At SLICE_CASE the sums run over 256 steps x 128 states with terms up to the
# size of the largest output; two fp32 orders differ there by up to a few
# 1e-6 of it, so in f32 that case's absolute tolerance is 1e-4 of the largest
# |output| (the kernel and the plain version differed by 4.4e-4 on the H100).
# The same holds for every case whose sums are at least that long (Q x N of
# 512 x 256 and 300 x 256: the port and JAX differed by up to 2.2e-4 there)


def long_sums(case):
    return case[2] * case[5] >= 256 * 128


def inputs(case, seed=0):
    """x, dt, B, C, la, D as float32 numpy arrays, drawn as the reference's
    tests draw them: dt = softplus(.), la = dt * -exp(.)."""
    b, nc, Q, H, P, N = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, nc, Q, H, P)).astype(np.float32) * 0.5
    dt = np.logaddexp(rng.standard_normal((b, nc, Q, H)), 0).astype(np.float32)
    B = rng.standard_normal((b, nc, Q, N)).astype(np.float32)
    C = rng.standard_normal((b, nc, Q, N)).astype(np.float32)
    A = -np.exp(rng.standard_normal(H).astype(np.float32) * 0.2)
    la = (dt * A).astype(np.float32)
    D = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    return x, dt, B, C, la, D


def as_torch(arrs, dtype, device="cpu"):
    x, *rest = (torch.from_numpy(a).to(device) for a in arrs)
    return [x.to(getattr(torch, dtype)), *rest]


def f32(t):
    return np.asarray(t.float().cpu() if isinstance(t, torch.Tensor) else t, np.float32)


@pytest.fixture
def jx():
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import ssd_scan as kern
    from repro.kernels.ssd_scan import ssd_scan_ref as ref

    def inputs(arrs, dtype):
        x, *rest = (jnp.asarray(a) for a in arrs)
        return [x.astype(getattr(jnp, dtype)), *rest]
    return SimpleNamespace(inputs=inputs, kern=kern, ref=ref)


@pytest.mark.parametrize("case", SSD_CASES + LARGE_CASES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_ssd_matches_jax(case, dtype, tol, jx):
    b, nc, Q, H, P, N = case
    arrs = inputs(case)
    y, h = ssd_scan(*as_torch(arrs, dtype))
    assert y.dtype == getattr(torch, dtype) and y.shape == (b, nc * Q, H, P)
    assert h.dtype == torch.float32 and h.shape == (b, H, N, P)
    jargs = jx.inputs(arrs, dtype)
    for jy, jh in (jx.kern(*jargs), jx.ref(*jargs)):
        for out, ref in ((f32(y), f32(jy)), (f32(h), f32(jh))):
            scale = np.abs(ref).max() if dtype == "float32" and long_sums(case) else 1.0
            np.testing.assert_allclose(out, ref, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("case", SSD_CASES + [SMOKE_CASE])
def test_tf32_model_matches_jax(case, jx):
    """The CPU model of the bf16 CUDA route's roundings (every product's
    operands read as tf32) stays within the bf16 tolerance of the JAX
    kernel (interpret mode) and of both references."""
    arrs = inputs(case)
    y, h = ssd_scan_tf32_ref(*as_torch(arrs, "bfloat16"))
    ry, rh = ssd_scan_ref(*as_torch(arrs, "bfloat16"))
    jargs = jx.inputs(arrs, "bfloat16")
    for want_y, want_h in (jx.kern(*jargs), jx.ref(*jargs), (ry, rh)):
        np.testing.assert_allclose(f32(y), f32(want_y), atol=5e-2, rtol=5e-2)
        np.testing.assert_allclose(f32(h), f32(want_h), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("case", SSD_CASES + [SMOKE_CASE] + LARGE_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_tf32_model_matches_jax_kernel_at_model_tol(case, dtype, jx):
    """The CPU model of the 16-bit CUDA route (fp16 x is exact in tf32, as
    bf16 x is) against the JAX kernel (interpret mode) at MODEL_TOL, the
    tolerance the card holds the kernel to against the model: the tf32
    truncations move no output past it (at most 0.69 of it in bf16, 0.23 in
    fp16 on these cases)."""
    arrs = inputs(case)
    y, h = ssd_scan_tf32_ref(*as_torch(arrs, dtype))
    assert y.dtype == getattr(torch, dtype)
    jy, jh = jx.kern(*jx.inputs(arrs, dtype))
    for out, ref in ((f32(y), f32(jy)), (f32(h), f32(jh))):
        np.testing.assert_allclose(out, ref, atol=MODEL_TOL[0] * np.abs(ref).max(),
                                   rtol=MODEL_TOL[1])


@pytest.mark.parametrize("case", LARGE_CASES)
def test_zero_padding_of_state_and_head_dim_is_exact(case):
    """What the CUDA wrapper does for N or P not a multiple of 4: B and C
    (and x) padded with zero columns, the outputs sliced back, give the
    unpadded scan: a zero state column stays 0 and adds 0 to C.h, and a zero
    x column gives zero columns of y and h."""
    b, nc, Q, H, P, N = case
    x, dt, B, C, la, D = as_torch(inputs(case, seed=5), "float32")
    y, h = ssd_scan_ref(x, dt, B, C, la, D)
    yp, hp = ssd_scan_ref(ops._pad_last(x, 8), dt, ops._pad_last(B, 8), ops._pad_last(C, 8),
                          la, D)
    assert hp.shape[-2] % 8 == 0 and yp.shape[-1] % 8 == 0
    np.testing.assert_allclose(f32(yp[..., :P]), f32(y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(f32(hp[:, :, :N, :P]), f32(h), atol=1e-5, rtol=1e-5)
    assert not yp[..., P:].any() and not hp[:, :, N:].any() and not hp[..., P:].any()


def test_tf32_model_matches_plain_version_at_the_slice():
    """At the serving shape, where the sums are longest (256 steps x 128
    states), the tf32 roundings still keep to the bf16 tolerance (the worst
    output is at ~0.58 of it)."""
    args = as_torch(inputs(SLICE_CASE), "bfloat16")
    y, h = ssd_scan_tf32_ref(*args)
    ry, rh = ssd_scan_ref(*args)
    np.testing.assert_allclose(f32(y), f32(ry), atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(f32(h), f32(rh), atol=5e-2, rtol=5e-2)


def test_ssd_state_continuity():
    """The chunked scan equals a plain step-by-step recurrence, in y and in
    the final state that seeds decode."""
    case = b, nc, Q, H, P, N = (1, 2, 16, 4, 8, 8)
    x, dt, B, C, la, D = (torch.from_numpy(a).double() for a in inputs(case, seed=3))
    y, h_last = ssd_scan(*as_torch(inputs(case, seed=3), "float32"))
    S = nc * Q
    xf, dtf, laf = x.reshape(b, S, H, P), dt.reshape(b, S, H), la.reshape(b, S, H)
    Bf, Cf = B.reshape(b, S, N), C.reshape(b, S, N)
    h = torch.zeros((b, H, N, P), dtype=torch.float64)
    ys = []
    for t in range(S):
        h = h * torch.exp(laf[:, t])[..., None, None] + torch.einsum(
            "bn,bhp->bhnp", Bf[:, t], xf[:, t] * dtf[:, t][..., None])
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h) + D[:, None] * xf[:, t])
    np.testing.assert_allclose(f32(h_last), f32(h), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(f32(y), f32(torch.stack(ys, 1)), atol=1e-4, rtol=1e-4)


def test_cpu_calls_are_not_counted_as_launches():
    before = ops.ssd_scan.launches
    ssd_scan(*as_torch(inputs(SSD_CASES[0]), "float32"))
    assert ops.ssd_scan.launches == before


@pytest.mark.parametrize("bad", ["rank", "x_dtype", "B_dtype", "shape", "device_mix", "meta"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, dt, B, C, la, D = as_torch(inputs(SSD_CASES[1]), "float32")
    if bad == "rank":
        x = x[0]
    elif bad == "x_dtype":      # neither package's kernel takes float64
        x = x.double()
    elif bad == "B_dtype":
        B = B.to(torch.bfloat16)
    elif bad == "shape":
        C = C[..., :-4]
    elif bad == "device_mix":
        D = D.to("meta")
    else:
        x, dt, B, C, la, D = (t.to("meta") for t in (x, dt, B, C, la, D))
    with pytest.raises(ValueError):
        ssd_scan(x, dt, B, C, la, D)


@pytest.fixture
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# shapes on which earlier forms of the bf16 route raced (2-3 row tiles a
# chunk, more blocks than SMs): wrong rows at random, so a run here that
# passes says little, one that fails says a lot
RACE_CASES = [(2, 3, 128, 100, 64, 64), (3, 3, 192, 90, 64, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES + [SMOKE_CASE, SLICE_CASE] + LARGE_CASES)
@pytest.mark.parametrize("dtype,tol", CUDA_DTYPES)
def test_cuda_kernel_matches_plain_version(case, dtype, tol, no_tf32):
    check_cuda_kernel(case, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", RACE_CASES)
def test_cuda_bf16_route_on_race_prone_shapes(case, no_tf32):
    check_cuda_kernel(case, "bfloat16", 5e-2)


def check_cuda_kernel(case, dtype, tol):
    """The CUDA kernel of ``dtype``'s route against the plain version and,
    for the 16-bit route, against the CPU model of its roundings, on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = as_torch(inputs(case), dtype, "cuda")
    before = ops.ssd_scan.launches
    y, h = ssd_scan(*args)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    ry, rh = ssd_scan_ref(*args)
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    for out, ref in ((f32(y), f32(ry)), (f32(h), f32(rh))):
        scale = np.abs(ref).max() if dtype == "float32" and long_sums(case) else 1.0
        np.testing.assert_allclose(out, ref, atol=tol * scale, rtol=tol)
    if dtype != "float32":
        my, mh = ssd_scan_tf32_ref(*args)
        for out, ref in ((f32(y), f32(my)), (f32(h), f32(mh))):
            np.testing.assert_allclose(out, ref, atol=MODEL_TOL[0] * np.abs(ref).max(),
                                       rtol=MODEL_TOL[1])
