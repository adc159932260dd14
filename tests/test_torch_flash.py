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

from repro_torch.kernels.flash_attention import (attention_bwd_ref, attention_lse_ref,
                                                 attention_ref, flash_attention)
from repro_torch.kernels.flash_attention import ops

# copied from tests/test_kernels.py
FLASH_CASES = [
    # (B, S, H, KV, hd, causal, window, bq, bk); bq, bk: the TPU kernel's tiles,
    # passed to the JAX wrapper only
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
    out = flash_attention(*as_torch(arrs, dtype), causal, win)
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, S, H, hd)
    jq, jk, jv = jx.inputs(arrs, dtype)
    kern = jx.flash(jq, jk, jv, causal, win, bq, bk)
    ref = jx.ref(jq, jk, jv, causal=causal, window=win)
    np.testing.assert_allclose(f32(out), f32(kern), atol=tol, rtol=tol)
    np.testing.assert_allclose(f32(out), f32(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", RAGGED_CASES + BOUNDARY_CASES + HD80_RAGGED_CASES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flash_ragged_matches_jax_ref(case, dtype, tol, jx):
    B, S, H, KV, hd, causal, win, _, _ = case
    arrs = inputs(case, dtype, seed=1)
    out = flash_attention(*as_torch(arrs, dtype), causal, win)
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
    out = ops.run_padded(plain, (q, k, v), causal, win)
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
    B, S, H, KV, hd, causal, win, _, _ = case
    q, k, v = (t.cuda() for t in as_torch(inputs(case, dtype), dtype))
    before = ops.flash_attention.launches
    out = flash_attention(q, k, v, causal, win)
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


# ------------------------------------------------------------ the backward
# (B, S, H, KV, hd, causal, window): causal, bidirectional and windowed; G = 1,
# 3 and 8, and MQA (one KV head); head dims 32, 64, 80, 128 and 48 (padded to
# 64); S 128, 192 and tails off the 64-row tiles (100, 150)
BWD_CASES = [
    (1, 128, 4, 4, 64, True, 0),
    (2, 192, 6, 2, 32, True, 0),
    (1, 128, 16, 2, 64, True, 0),
    (1, 128, 8, 1, 128, False, 0),
    (1, 192, 3, 1, 80, True, 50),
    (1, 100, 8, 1, 64, True, 0),
    (2, 150, 4, 2, 48, False, 30),
]
# the backward kernel against attention_bwd_ref in fp32 on the same inputs,
# output and log-sum-exp: P and dS are rounded to the input type for their
# products and each gradient once more on output, so max |err| is held to
# this share of the gradient's largest |value|; fp16's rounding is 8x finer
# (on the H100 the kernel read 1.6e-3-6.0e-3 in bf16, 2.3e-4-6.0e-4 in fp16)
BWD_TOL = {"bfloat16": 2e-2, "float16": 5e-3}


def bwd_inputs(case, seed=0):
    """q, k, v and the cotangent dO, from numpy."""
    B, S, H, KV, hd = case[:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd))]


def share(got, want):
    """max |got - want| over max |want|."""
    got, want = f32(got), f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", BWD_CASES)
def test_bwd_ref_matches_autograd_of_the_plain_version(case):
    """attention_bwd_ref, from the output and its log-sum-exp through
    D = rowsum(dO * O), equals autograd of attention_ref in fp32, and the
    log-sum-exp is each row's softmax normaliser."""
    B, S, H, KV, hd, causal, win = case[:7]
    q, k, v, do = (torch.from_numpy(a) for a in bwd_inputs(case))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention_ref(*qkv, causal=causal, window=win)
    want = torch.autograd.grad(out, qkv, do)
    lse = attention_lse_ref(q, k, causal=causal, window=win)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    got = attention_bwd_ref(q, k, v, out.detach(), lse, do, causal=causal, window=win)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert share(g, w) < 1e-5
    # softmax(scores) = exp(scores - lse): the weights of each row sum to 1
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k) / hd ** 0.5
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask = mask.tril()
    if win:
        mask &= torch.arange(S)[None, :] > torch.arange(S)[:, None] - win
    w = torch.exp(scores - lse.reshape(B, KV, H // KV, S, 1)) * mask
    np.testing.assert_allclose(f32(w.sum(-1)), 1.0, atol=1e-5)


@pytest.mark.parametrize("case", BWD_CASES)
def test_bwd_ref_matches_jax_grads(case, jx):
    """attention_bwd_ref against the gradients of the JAX wrapper (its
    custom_vjp, the Pallas forward in interpret mode) or, where S is not a
    multiple of the JAX block (interpret mode gives NaN on ragged tails), of
    the JAX package's plain version."""
    import jax
    B, S, H, KV, hd, causal, win = case[:7]
    arrs = bwd_inputs(case, seed=1)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    out = attention_ref(q, k, v, causal=causal, window=win)
    lse = attention_lse_ref(q, k, causal=causal, window=win)
    got = attention_bwd_ref(q, k, v, out, lse, do, causal=causal, window=win)
    jq, jk, jv, jdo = jx.inputs(arrs, "float32")
    if S % 64 == 0:
        fn = lambda a, b, c: jx.flash(a, b, c, causal, win, 64, 64)
    else:
        fn = lambda a, b, c: jx.ref(a, b, c, causal=causal, window=win)
    _, vjp = jax.vjp(fn, jq, jk, jv)
    for g, w in zip(got, vjp(jdo)):
        assert share(g, w) < 1e-5


@pytest.mark.parametrize("case", [c for c in ANY_HD_CASES if c[4] <= 128])
def test_backward_padding_equals_the_unpadded_backward(case):
    """The backward's padding (q, k, v, o and dO zero-padded to the kernel
    width, the true width's scale, dq, dk, dv sliced back) around the plain
    backward equals the plain backward on the unpadded inputs: zero columns
    add 0 to the scores, to dO.V^T and to rowsum(dO * O), and get zero
    gradient."""
    B, S, H, KV, hd, causal, win = case[:7]
    q, k, v, do = (torch.from_numpy(a) for a in bwd_inputs(case, seed=2))
    o = attention_ref(q, k, v, causal=causal, window=win)
    lse = attention_lse_ref(q, k, causal=causal, window=win)
    seen = []

    def plain(q, k, v, o, do, lse, causal, window, scale):
        seen.append(q.shape[-1])
        assert all(t.shape[-1] == q.shape[-1] for t in (k, v, o, do))
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window,
                                 scale=scale)
    got = ops.run_padded(plain, (q, k, v, o, do), lse, causal, win)
    assert seen == [ops.launch_plan(hd)[0]] and seen[0] in ops.BWD_WIDTHS
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=win)
    for g, w in zip(got, want):
        assert g.shape == w.shape and (g.is_contiguous() or hd in ops.BWD_WIDTHS)
        np.testing.assert_allclose(f32(g), f32(w), atol=1e-6, rtol=1e-6)


def test_the_backward_kernel_takes_16_bit_cuda_calls_up_to_width_128():
    """The route is chosen by what the wrapper sees: CUDA, bf16 or fp16, a
    head dim whose width is at most 128; fp32, widths 256 and the column
    passes past it, and CPU tensors keep the plain recompute."""
    def call(device, dtype, hd):
        return SimpleNamespace(device=torch.device(device), dtype=dtype, shape=(1, 8, 2, hd))
    for hd in range(1, 1025, 7):
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            want = dtype != torch.float32 and hd <= 128
            assert ops.bwd_kernel_takes(call("cuda", dtype, hd)) == want, (hd, dtype)
            assert not ops.bwd_kernel_takes(call("cpu", dtype, hd))
    assert set(ops.BWD_WIDTHS) == {w for w in ops.WIDTHS if w <= 128}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_backward_is_the_plain_recompute(dtype):
    """On the CPU the forward writes no log-sum-exp, saves q, k and v alone,
    and the backward differentiates the plain version; the backward
    kernel's count does not move."""
    case = BWD_CASES[1]
    q, k, v, do = as_torch(bwd_inputs(case), dtype)
    qkv = [t.requires_grad_() for t in (q, k, v)]
    before = ops.flash_attention.bwd_launches
    out = flash_attention(*qkv, True, 0)
    assert len(out.grad_fn.saved_tensors) == 3
    got = torch.autograd.grad(out, qkv, do)
    ref_in = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*ref_in, causal=True), ref_in, do)
    assert ops.flash_attention.bwd_launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------------ the backward on the card
def cuda_bwd(case, dtype, seed=0):
    """The kernel's gradients through autograd, the forward's output and
    log-sum-exp, and the inputs, on the card."""
    B, S, H, KV, hd, causal, win = case[:7]
    q, k, v, do = (t.cuda() for t in as_torch(bwd_inputs(case, seed), dtype))
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    before = ops.flash_attention.bwd_launches
    out = flash_attention(*qkv, causal, win)
    got = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    assert ops.flash_attention.bwd_launches == before + 1
    o, lse = ops._forward(q, k, v, causal, win, with_lse=True)
    return got, (q, k, v, o, lse, do)


def check_cuda_bwd(case, dtype, seed=0):
    B, S, H, KV, hd, causal, win = case[:7]
    got, (q, k, v, o, lse, do) = cuda_bwd(case, dtype, seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    np.testing.assert_allclose(f32(lse.cpu()),
                               f32(attention_lse_ref(q, k, causal=causal, window=win).cpu()),
                               atol=1e-5, rtol=1e-5)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=win)
    for g, w in zip(got, want):
        assert g.dtype == q.dtype and torch.isfinite(g).all()
        assert share(g.cpu(), w.cpu()) <= BWD_TOL[dtype]
    del want
    # the plain recompute on the same inputs rounds at other places, within
    # the same share of each gradient
    ref_in = [t.detach().requires_grad_() for t in (q, k, v)]
    plain = torch.autograd.grad(attention_ref(*ref_in, causal=causal, window=win), ref_in, do)
    for g, w in zip(got, plain):
        assert share(g.cpu(), w.cpu()) <= BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cuda_backward_kernel_matches_bwd_ref_and_the_plain_recompute(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    check_cuda_bwd(case, dtype)


@pytest.mark.cuda
def test_cuda_backward_kernel_at_the_train_shape():
    """smollm-360m's training attention: 8 x 2048 tokens, 15 heads on 5, hd 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    check_cuda_bwd((8, 2048, 15, 5, 64, True, 0), "bfloat16")


@pytest.mark.cuda
def test_cuda_bwd_launches_count_one_per_backward_through_the_kernel():
    """One count a backward that runs the kernel; none for fp32 or width 256
    (the plain recompute), and none for a forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for dtype, hd, n in (("bfloat16", 64, 1), ("float16", 112, 1), ("float32", 64, 0),
                         ("bfloat16", 160, 0)):
        q, k, v, do = (t.cuda() for t in as_torch(bwd_inputs((1, 128, 4, 2, hd)), dtype))
        qkv = [t.requires_grad_() for t in (q, k, v)]
        before = ops.flash_attention.bwd_launches, ops.flash_attention.launches
        for i in range(3):
            out = flash_attention(*qkv, True, 0)
            assert ops.flash_attention.bwd_launches == before[0] + n * i
            torch.autograd.grad(out, qkv, do)
        torch.cuda.synchronize()
        assert ops.flash_attention.bwd_launches == before[0] + 3 * n, (dtype, hd)
        assert ops.flash_attention.launches == before[1] + 3


@pytest.mark.cuda
def test_cuda_serving_writes_no_lse(monkeypatch):
    """Under no_grad, and for inputs that need no gradient, the forward
    launches with a null lse and allocates none; only a forward that a
    backward kernel will follow gets a (B, H, S) fp32 buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    seen = []
    launch = ops._launch

    def spy(q, k, v, causal, window, scale, lse=None):
        seen.append(lse)
        return launch(q, k, v, causal, window, scale, lse=lse)
    monkeypatch.setattr(ops, "_launch", spy)
    q, k, v = (t.cuda() for t in as_torch(inputs(FLASH_CASES[1], "bfloat16"), "bfloat16"))
    with torch.no_grad():
        flash_attention(*(t.requires_grad_() for t in (q, k, v)))
    flash_attention(*(t.detach() for t in (q, k, v)))
    with torch.inference_mode():
        flash_attention(q.detach(), k.detach(), v.detach())
    assert seen == [None, None, None]
    out = flash_attention(q.detach().requires_grad_(), k.detach(), v.detach())
    B, S, H, _ = q.shape
    assert seen[-1].shape == (B, H, S) and seen[-1].dtype == torch.float32
    assert len(out.grad_fn.saved_tensors) == 5
