"""The port's flash_attention against the JAX package's: on the CPU the
port's wrapper runs its plain version, the JAX wrapper runs the Pallas
kernel in interpret mode. The CUDA kernel itself is held against the plain
version by the test marked ``cuda`` (skipped without a GPU) and by
chip_smoke.py.

JAX is imported inside the tests that use it, so that the ``cuda`` tests
also run where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash.py``."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import ops

# copied from tests/test_kernels.py
FLASH_CASES = [
    # (B, S, H, KV, hd, causal, window, bq, bk)
    (1, 128, 4, 4, 64, True, 0, 64, 64),
    (2, 256, 8, 2, 64, True, 0, 128, 64),
    (1, 256, 4, 4, 32, False, 0, 128, 128),
    (2, 128, 4, 2, 64, True, 32, 64, 64),
    (1, 512, 2, 1, 128, True, 128, 128, 128),
    (1, 128, 4, 4, 64, True, 0, 128, 32),
]
RAGGED_CASES = [
    (1, 100, 4, 2, 64, True, 0, 64, 64),
    (2, 100, 4, 4, 32, False, 16, 64, 64),
]
DTYPES = [("float32", 2e-5), ("bfloat16", 2e-2)]


def inputs(case, dtype, seed=0):
    B, S, H, KV, hd = case[:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def as_torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


@pytest.fixture
def jx():
    import jax.numpy as jnp
    from repro.kernels.flash_attention import attention_ref as ref
    from repro.kernels.flash_attention import flash_attention as flash

    def inputs(arrs, dtype):
        return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    return SimpleNamespace(inputs=inputs, ref=ref, flash=flash)


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flash_matches_jax(case, dtype, tol, jx):
    B, S, H, KV, hd, causal, win, bq, bk = case
    arrs = inputs(case, dtype)
    out = flash_attention(*as_torch(arrs, dtype), causal, win, bq, bk)
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, S, H, hd)
    jq, jk, jv = jx.inputs(arrs, dtype)
    kern = jx.flash(jq, jk, jv, causal, win, bq, bk)
    ref = jx.ref(jq, jk, jv, causal=causal, window=win)
    np.testing.assert_allclose(f32(out), f32(kern), atol=tol, rtol=tol)
    np.testing.assert_allclose(f32(out), f32(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", RAGGED_CASES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flash_ragged_matches_jax_ref(case, dtype, tol, jx):
    B, S, H, KV, hd, causal, win, bq, bk = case
    arrs = inputs(case, dtype, seed=1)
    out = flash_attention(*as_torch(arrs, dtype), causal, win, bq, bk)
    ref = jx.ref(*jx.inputs(arrs, dtype), causal=causal, window=win)
    np.testing.assert_allclose(f32(out), f32(ref), atol=tol, rtol=tol)


def test_cpu_calls_are_not_counted_as_launches():
    before = ops.flash_attention.launches
    flash_attention(*as_torch(inputs(FLASH_CASES[0], "float32"), "float32"))
    assert ops.flash_attention.launches == before


@pytest.mark.parametrize("bad", ["rank", "heads", "dtype_mix", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = as_torch(inputs(FLASH_CASES[1], "float32"), "float32")
    if bad == "rank":
        q = q[0]
    elif bad == "heads":
        k, v = k[:, :, :1].repeat(1, 1, 3, 1), v[:, :, :1].repeat(1, 1, 3, 1)
    elif bad == "dtype_mix":
        k = k.to(torch.bfloat16)
    else:
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises(ValueError):
        flash_attention(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES + RAGGED_CASES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_kernel_matches_plain_version(case, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, S, H, KV, hd, causal, win, bq, bk = case
    q, k, v = (t.cuda() for t in as_torch(inputs(case, dtype), dtype))
    before = ops.flash_attention.launches
    out = flash_attention(q, k, v, causal, win, bq, bk)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = attention_ref(q, k, v, causal=causal, window=win)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    np.testing.assert_allclose(f32(out.cpu()), f32(ref.cpu()), atol=tol, rtol=tol)
