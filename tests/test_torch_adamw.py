"""The port's AdamW (repro_torch.optim) against the JAX package's: the same
parameters, gradients and state from one numpy seed through
``adamw_update``, ``schedule`` and ``global_norm`` in both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw as tadamw

SHAPES = {"embed": (16, 8), "head": (8, 16), "ln": (8,), "w": (3, 4, 5)}
# fp32 state and fp32 params: the two packages round the same fp32
# operations, in orders that differ by a few ulps
TOL = 1e-6


def tree(seed, scale=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(dtype) for k, s in SHAPES.items()}


def to_jax(t, dtype):
    return {k: jnp.asarray(v).astype(dtype) for k, v in t.items()}


def to_torch(t, dtype):
    return {k: torch.from_numpy(v).to(dtype) for k, v in t.items()}


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, dtype=np.float32)


def run_both(kw, n_steps, dtype, grad_scale=1.0):
    """``n_steps`` updates of the same params with the same grads each step
    (grads of step i from seed 100 + i), each package with its own
    ``AdamWConfig(**kw)``. Returns the two final (params, state, gnorm)."""
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    p = tree(0)
    jp, tp = to_jax(p, getattr(jnp, dtype)), to_torch(p, getattr(torch, dtype))
    js, ts = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for i in range(n_steps):
        g = tree(100 + i, grad_scale)
        jp, js, jn = jadamw.adamw_update(to_jax(g, getattr(jnp, dtype)), jp, js, jcfg)
        tp, ts, tn = tadamw.adamw_update(to_torch(g, getattr(torch, dtype)), tp, ts, tcfg)
    return (jp, js, jn), (tp, ts, tn)


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(n_steps, dtype):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    (jp, js, jn), (tp, ts, tn) = run_both(kw, n_steps, dtype)
    assert int(ts.count) == int(js.count) == n_steps
    assert ts.count.dtype == torch.int32
    np.testing.assert_allclose(f32(tn), f32(jn), rtol=TOL)
    # bf16 params: the update is fp32 and the result one bf16 rounding, so
    # the two agree to that rounding (2^-8 relative) where an fp32 ulp
    # tips it; the fp32 moments agree as in fp32
    ptol = TOL if dtype == "float32" else 2 ** -8
    for k in SHAPES:
        assert tp[k].dtype == getattr(torch, dtype)
        assert ts.m[k].dtype == ts.v[k].dtype == torch.float32
        np.testing.assert_allclose(f32(tp[k]), f32(jp[k]), rtol=ptol, atol=ptol)
        np.testing.assert_allclose(f32(ts.m[k]), f32(js.m[k]), rtol=1e-5, atol=TOL)
        np.testing.assert_allclose(f32(ts.v[k]), f32(js.v[k]), rtol=1e-5, atol=TOL)


def test_update_is_in_place_and_returns_the_same_tensors():
    p = to_torch(tree(0), torch.float32)
    before = {k: v.clone() for k, v in p.items()}
    s = tadamw.adamw_init(p)
    out, s2, _ = tadamw.adamw_update(to_torch(tree(1), torch.float32), p, s,
                                     tadamw.AdamWConfig())
    assert out is p and s2.m is s.m and s2.v is s.v
    assert not any(torch.equal(p[k], before[k]) for k in p)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 150])
def test_schedule_matches_jax(step):
    """warmup (0-10), the cosine from 10 to 100 (midpoint 55), the end and
    past it."""
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    want = float(jadamw.schedule(jadamw.AdamWConfig(**kw), jnp.asarray(step, jnp.int32)))
    got = float(tadamw.schedule(tadamw.AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6)


def test_schedule_landmarks():
    cfg = tadamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    assert float(tadamw.schedule(cfg, 5)) == pytest.approx(0.5)
    assert float(tadamw.schedule(cfg, 60)) == pytest.approx(0.55)
    assert float(tadamw.schedule(cfg, 110)) == pytest.approx(0.1)


@pytest.mark.parametrize("grad_scale", [0.0, 1e-3, 10.0])
def test_clip_matches_jax(grad_scale):
    """A zero gradient (clip factor 1, no NaN from 0/0), one under the clip
    and one far over it."""
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=1.0)
    (jp, js, jn), (tp, ts, tn) = run_both(kw, 1, "float32", grad_scale)
    np.testing.assert_allclose(f32(tn), f32(jn), rtol=TOL)
    for k in SHAPES:
        assert torch.isfinite(tp[k]).all()
        np.testing.assert_allclose(f32(tp[k]), f32(jp[k]), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(f32(ts.m[k]), f32(js.m[k]), rtol=1e-5, atol=TOL)


def test_global_norm_matches_jax():
    g = tree(3)
    want = float(jadamw.global_norm(to_jax(g, jnp.float32)))
    got = float(tadamw.global_norm(to_torch(g, torch.float32)))
    assert got == pytest.approx(want, rel=1e-6)


def test_missing_gradient_raises():
    p = to_torch(tree(0), torch.float32)
    g = to_torch(tree(1), torch.float32)
    g["ln"] = None
    with pytest.raises(ValueError, match="no gradient for \\['ln'\\]"):
        tadamw.adamw_update(g, p, tadamw.adamw_init(p), tadamw.AdamWConfig())
