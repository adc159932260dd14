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
# the ragged edges of the CUDA kernels' tiles (64 keys, 64 query rows) at
# the serving slice's grouping of 8 query heads a KV head: S on either side
# of 64 and 128, a single row, a long ragged tail, a window of 100 that
# crosses 64- and 128-row tiles, and one bidirectional case
BOUNDARY_CASES = [
    (1, 1, 8, 1, 64, True, 0, 64, 64),
    (1, 63, 8, 1, 32, True, 0, 64, 64),
    (1, 65, 8, 1, 128, True, 0, 64, 64),
    (2, 127, 8, 1, 64, True, 0, 64, 64),
    (1, 129, 8, 1, 64, True, 0, 64, 64),
    (1, 1000, 8, 1, 64, True, 0, 128, 128),
    (1, 300, 8, 1, 64, True, 100, 128, 128),
    (1, 129, 8, 1, 64, False, 0, 64, 64),
]
# head dim 80 (hubert-xlarge's): the kernels' five 16-column atoms, causal and
# bidirectional; then, held against the JAX package's plain version as the
# ragged cases are, a ragged tail under a window and a 129-row boundary
HD80_CASES = [
    (1, 128, 4, 4, 80, True, 0, 64, 64),
    (2, 192, 4, 2, 80, False, 0, 64, 64),
]
HD80_RAGGED_CASES = [
    (1, 100, 4, 2, 80, True, 16, 64, 64),
    (1, 129, 8, 1, 80, True, 0, 64, 64),
]
# every other head dim, which the JAX kernel takes as it takes any: 96 and
# 256 are built natively, the rest up to 256 zero-padded by the wrapper to
# the next width of ops.WIDTHS (8, 16, 20 -> 32; 48 -> 64; 112 -> 128; 160,
# 192 -> 256); past 256 padded to a multiple of 64 and run in column passes
# of at most 256 (264 -> 320 in 2 passes, 320 in 2, 512 in 2); causal,
# bidirectional and windowed. S is a multiple of the JAX block (interpret
# mode gives NaN on ragged tails)
ANY_HD_CASES = [
    (1, 128, 4, 2, 8, True, 0, 64, 64),
    (1, 128, 4, 4, 16, False, 0, 64, 64),
    (2, 128, 4, 2, 20, True, 32, 64, 64),
    (1, 128, 4, 2, 48, False, 0, 64, 64),
    (1, 256, 4, 2, 96, True, 0, 128, 128),
    (1, 128, 4, 4, 112, True, 48, 64, 64),
    (1, 128, 2, 1, 160, False, 0, 64, 64),
    (1, 128, 4, 2, 192, True, 0, 64, 64),
    (1, 256, 4, 2, 256, True, 100, 128, 128),
    (1, 128, 4, 2, 264, True, 0, 64, 64),
    (1, 128, 2, 1, 320, False, 0, 64, 64),
    (1, 128, 4, 2, 512, True, 48, 64, 64),
]
# f32: summation orders differ. bf16: P and the output are rounded to the
# input type. fp16 has 3 more mantissa bits than bf16, so bf16's tolerance
# covers it against the JAX package on the CPU.
DTYPES = [("float32", 2e-5), ("bfloat16", 2e-2), ("float16", 2e-2)]
# the CUDA kernels against the plain version on the card: fp16's rounding is
# 8x finer than bf16's (one step is ~0.002 at outputs of 2-4, bf16's
# ~0.016), so its tolerance lies between the two, and a route that rounded
# anything to bf16 would fail it
CUDA_DTYPES = [("float32", 2e-5), ("bfloat16", 2e-2), ("float16", 5e-3)]


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


@pytest.mark.parametrize("case", FLASH_CASES + HD80_CASES + ANY_HD_CASES)
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


@pytest.mark.parametrize("case", RAGGED_CASES + BOUNDARY_CASES + HD80_RAGGED_CASES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flash_ragged_matches_jax_ref(case, dtype, tol, jx):
    B, S, H, KV, hd, causal, win, bq, bk = case
    arrs = inputs(case, dtype, seed=1)
    out = flash_attention(*as_torch(arrs, dtype), causal, win, bq, bk)
    ref = jx.ref(*jx.inputs(arrs, dtype), causal=causal, window=win)
    np.testing.assert_allclose(f32(out), f32(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ANY_HD_CASES)
def test_padding_equals_the_unpadded_plain_version(case):
    """The wrapper's padding (q, k, v zero-padded to the kernel width, the
    true width's scale, the output sliced back) around the plain version
    equals the plain version on the unpadded inputs, to fp32 rounding: zero
    columns add exactly 0 to q.k and give zero output columns."""
    B, S, H, KV, hd, causal, win = case[:7]
    q, k, v = as_torch(inputs(case, "float32", seed=3), "float32")
    seen = []

    def plain(q, k, v, causal, window, scale):
        seen.append(q.shape[-1])
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    out = ops.run_padded(q, k, v, causal, win, plain)
    width, passes = ops.launch_plan(hd)
    assert seen == [width]
    assert width in ops.WIDTHS if hd <= 256 else width % ops.WIDE_STEP == 0 and passes > 1
    assert out.shape == (B, S, H, hd) and out.is_contiguous()
    want = attention_ref(q, k, v, causal=causal, window=win)
    np.testing.assert_allclose(f32(out), f32(want), atol=1e-6, rtol=1e-6)


def test_every_head_dim_up_to_1024_has_a_launch_plan():
    """Each head dim 1-1024 gets a width (a built one up to 256, past it a
    multiple of 64 less than 64 above the head dim) and its column passes
    (one up to 256, past it one a 256 output columns, the last ragged);
    none raises."""
    assert {64, 80, 96, 128, 256} <= set(ops.WIDTHS)
    for hd in range(1, 1025):
        width, passes = ops.launch_plan(hd)
        assert hd <= width
        if hd <= 256:
            assert width in ops.WIDTHS and passes == 1
        else:
            assert width % 64 == 0 and width - hd < 64
            assert passes == -(-width // 256) and 0 < width - 256 * (passes - 1) <= 256
    assert ops.launch_plan(1024) == (1024, 4) and ops.launch_plan(264) == (320, 2)


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
@pytest.mark.parametrize("case", FLASH_CASES + RAGGED_CASES + BOUNDARY_CASES + HD80_CASES
                         + HD80_RAGGED_CASES + ANY_HD_CASES)
@pytest.mark.parametrize("dtype,tol", CUDA_DTYPES)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_cuda_masked_keys_add_exactly_zero(dtype):
    """window=1, causal: each query sees only its own key; every other key,
    in its tile or in tiles masked for the whole row, must add exactly 0.
    (Every query in [0, S) sees at least its own key, so a row masked in
    every tile exists only past S, where nothing is stored.) The own key's
    p is 1 (the 16-bit route: 1 up to an fp32 rounding, exactly 1 once
    rounded to the input type), and l is p, so the output is the own value
    row, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    case = (2, 300, 8, 2, 64, True, 1, 64, 64)
    q, k, v = (t.cuda() for t in as_torch(inputs(case, dtype, seed=2), dtype))
    out = flash_attention(q, k, v, True, 1)
    torch.cuda.synchronize()
    assert torch.equal(out, v.repeat_interleave(4, dim=2))
