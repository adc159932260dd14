"""The train slice of the port against the JAX package, at fp32 on the CPU:
the kernels' gradients, the losses and their gradients, a train step, and
``train`` itself (the JAX package's tests/test_train_e2e.py on the port).
Inputs come from numpy seeds; weights from the JAX package's own init,
brought across by repro_torch.convert.

JAX is imported inside the tests that use it, so that the ``cuda`` test
also runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train.py``."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import attention_ref, ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops, ssd_scan_ref
from repro_torch.launch.train import PRESETS, train, train_step
from repro_torch.models import Model
from repro_torch.models.layers import softmax_xent
from repro_torch.optim import AdamWConfig, adamw_init

# (b, nc, Q, H, P, N): tests/test_kernels.py's SSD_CASES
SSD_CASES = [
    (1, 4, 32, 8, 32, 16),
    (2, 2, 64, 4, 16, 32),
    (1, 8, 16, 16, 64, 128),
    (1, 2, 128, 8, 64, 64),
]
# fp32 loss of the same weights and batch: XLA and torch sum the logits and
# the layers in different orders
LOSS_TOL = 1e-5
# fp32 gradients: each leaf within this fraction of its largest |g|
GRAD_TOL = 1e-4


def f32(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else t, np.float32)


@pytest.fixture
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as smoke
    from repro.kernels.flash_attention import attention_ref as jattention_ref
    from repro.kernels.flash_attention import flash_attention as jflash
    from repro.kernels.ssd_scan import ssd_scan as jssd
    from repro.launch.train import PRESETS as JPRESETS
    from repro.models import Model as JModel
    from repro.models.layers import softmax_xent as jxent
    from repro.optim import adamw as jadamw
    return SimpleNamespace(jax=jax, jnp=jnp, smoke=smoke, attention_ref=jattention_ref,
                           flash=jflash, ssd=jssd, PRESETS=JPRESETS, Model=JModel,
                           xent=jxent, adamw=jadamw)


# ------------------------------------------------------------ kernel grads
def flash_inputs(seed=4, hd=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((1, 128, 4, hd), (1, 128, 2, hd), (1, 128, 2, hd))]


def check_flash_grads(jx, arrs, causal):
    """The gradients of sum(out) through the wrapper's backward against
    autograd of the plain version and against the JAX wrapper's custom_vjp
    (its Pallas forward in interpret mode) and its plain version."""
    qkv = [torch.from_numpy(a).requires_grad_() for a in arrs]
    out = flash_ops.flash_attention(*qkv, causal, 0, 64, 64)
    assert type(out.grad_fn) is flash_ops.FlashAttention._backward_cls
    got = torch.autograd.grad(out.sum(), qkv)
    ref_in = [torch.from_numpy(a).requires_grad_() for a in arrs]
    want = torch.autograd.grad(attention_ref(*ref_in, causal=causal).sum(), ref_in)
    jin = [jx.jnp.asarray(a) for a in arrs]
    for argnum in range(3):
        g_jax = jx.jax.grad(lambda *a: jx.flash(*a, causal, 0, 64, 64).sum(),
                            argnums=argnum)(*jin)
        g_jref = jx.jax.grad(lambda *a: jx.attention_ref(*a, causal=causal).sum(),
                             argnums=argnum)(*jin)
        for other in (want[argnum], g_jax, g_jref):
            np.testing.assert_allclose(f32(got[argnum]), f32(other), atol=1e-5, rtol=1e-5)


def test_flash_grads_match_ref_and_jax(jx):
    """tests/test_kernels.py::test_flash_grads_match_ref on the port."""
    check_flash_grads(jx, flash_inputs(), causal=True)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_at_head_dim_80_match_ref_and_jax(causal, jx):
    """The same at hubert-xlarge's head dim 80, bidirectional (its
    encoder's mask) and causal."""
    check_flash_grads(jx, flash_inputs(seed=5, hd=80), causal=causal)


def ssd_inputs(case, seed=0):
    """x, dt, B, C, la, D as the reference's tests draw them, and fixed
    weights for y and h_last (so both cotangents are non-trivial)."""
    b, nc, Q, H, P, N = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, nc, Q, H, P)).astype(np.float32) * 0.5
    dt = np.logaddexp(rng.standard_normal((b, nc, Q, H)), 0).astype(np.float32)
    B = rng.standard_normal((b, nc, Q, N)).astype(np.float32)
    C = rng.standard_normal((b, nc, Q, N)).astype(np.float32)
    la = (dt * -np.exp(rng.standard_normal(H).astype(np.float32) * 0.2)).astype(np.float32)
    D = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    wy = rng.standard_normal((b, nc * Q, H, P)).astype(np.float32)
    wh = rng.standard_normal((b, H, N, P)).astype(np.float32)
    return [x, dt, B, C, la, D], wy, wh


def jax_ssd_grads(jx, arrs, wy, wh):
    def jloss(*a):
        jy, jh = jx.ssd(*a)
        return (jy * wy).sum() + (jh * wh).sum()
    return jx.jax.grad(jloss, argnums=tuple(range(6)))(*map(jx.jnp.asarray, arrs))


def port_ssd_grads(fn, arrs, wy, wh):
    ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, h = fn(*ins)
    return y, torch.autograd.grad((y * torch.from_numpy(wy)).sum()
                                  + (h * torch.from_numpy(wh)).sum(), ins)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_grads_match_ref_and_jax(case, jx):
    """All six inputs' gradients of sum(y*wy) + sum(h*wh) through the
    wrapper's backward, against autograd of the plain version and the JAX
    wrapper's custom_vjp (Pallas forward in interpret mode), at 1e-4: each
    gradient element is a sum over the chunk of terms up to the size of the
    input's largest gradient, which cancel to much smaller values (dt at
    Q=128), so the absolute part is 1e-4 of that largest |g|.

    At Q=128 half of la's gradient is NaN in the JAX package (see
    test_ssd_grads_past_fp32_exp_range); everywhere else the two agree, and
    the port's is finite everywhere."""
    arrs, wy, wh = ssd_inputs(case)
    y, got = port_ssd_grads(ssd_ops.ssd_scan, arrs, wy, wh)
    assert type(y.grad_fn) is ssd_ops.SSDScan._backward_cls
    _, want = port_ssd_grads(ssd_scan_ref, arrs, wy, wh)
    g_jax = jax_ssd_grads(jx, arrs, wy, wh)
    for i, name in enumerate(("x", "dt", "B", "C", "la", "D")):
        assert torch.isfinite(got[i]).all(), name
        for other in (f32(want[i]), f32(g_jax[i])):
            ok = np.isfinite(other)
            atol = 1e-4 * np.abs(other[ok]).max()
            np.testing.assert_allclose(f32(got[i])[ok], other[ok], atol=atol, rtol=1e-4,
                                       err_msg=name)
    assert np.isnan(f32(g_jax[4])).any() == (case[2] == 128)


def recurrence_f64(x, dt, B, C, la, D):
    """The SSD scan as its step-by-step recurrence in float64: no exp of a
    positive number, so its gradient is finite for any decays."""
    b, nc, Q, H, P = x.shape
    S, N = nc * Q, B.shape[-1]
    xf, dtf, laf = x.reshape(b, S, H, P), dt.reshape(b, S, H), la.reshape(b, S, H)
    Bf, Cf = B.reshape(b, S, N), C.reshape(b, S, N)
    h = x.new_zeros((b, H, N, P))
    ys = []
    for t in range(S):
        h = h * torch.exp(laf[:, t])[..., None, None] + torch.einsum(
            "bn,bhp->bhnp", Bf[:, t], xf[:, t] * dtf[:, t][..., None])
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h) + D[:, None] * xf[:, t])
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_ssd_grads_past_fp32_exp_range(route, jx):
    """A fault of the JAX package, closed in the port. Its plain SSD scan
    (``ssd_scan_ref``, which the kernel's backward differentiates, and
    ``models/mamba2.ssd_chunked``, the plain route) builds the decay matrix
    as where(causal, exp(seg), 0); above the diagonal seg is a positive sum
    of decays, and where it passes ~88.7 (as here; 57-104 in the layers of
    mamba2-2.7b at full width, scripts/ssd_decay_range.py) exp overflows to
    inf and the gradient becomes 0 * inf = NaN. The port masks before the exp: the same values, and, on
    both routes, the gradient of a float64 recurrence."""
    from repro_torch.models.mamba2 import ssd_chunked
    case = b, nc, Q, H, P, N = (1, 2, 128, 8, 64, 64)
    arrs, wy, wh = ssd_inputs(case)
    x, dt, B, C, la, D = arrs
    A_log = np.log(la[0, 0, 0] / -dt[0, 0, 0]).astype(np.float32)     # la = dt * -exp(A_log)
    lcum = np.cumsum(la, axis=2)
    assert (lcum[:, :, :1] - lcum[:, :, -1:]).max() > 88.8     # the precondition

    def unchunked(t, tail):
        return t.reshape(b, nc * Q, *tail)

    def kernel_route(x, dt, B, C, A_log, D):
        return ssd_ops.ssd_scan(x, dt, B, C, dt * -torch.exp(A_log), D)

    def plain_route(x, dt, B, C, A_log, D):
        return ssd_chunked(unchunked(x, (H, P)), unchunked(dt, (H,)), unchunked(B, (N,)),
                           unchunked(C, (N,)), A_log, D, Q)

    def oracle(x, dt, B, C, A_log, D):
        x, dt, B, C, A_log, D = (t.double() for t in (x, dt, B, C, A_log, D))
        return recurrence_f64(x, dt, B, C, dt * -torch.exp(A_log), D)

    ins = [x, dt, B, C, A_log, D]
    fn = kernel_route if route == "kernel" else plain_route
    y, got = port_ssd_grads(fn, ins, wy, wh)
    assert y.shape == wy.shape
    _, want = port_ssd_grads(oracle, ins, wy, wh)
    for i, name in enumerate(("x", "dt", "B", "C", "A_log", "D")):
        w = f32(want[i])
        np.testing.assert_allclose(f32(got[i]), w, atol=1e-4 * np.abs(w).max(), rtol=1e-4,
                                   err_msg=name)
    g_jax = jax_ssd_grads(jx, arrs, wy, wh)
    assert np.isnan(f32(g_jax[4])).any()                        # the reference's fault


def test_ssd_grads_with_one_cotangent():
    """Only y used (h_last gets no gradient), and only h_last used (C and D
    then get none)."""
    arrs, _, _ = ssd_inputs((1, 2, 16, 4, 8, 8), seed=1)
    for pick in (0, 1):
        ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
        got = torch.autograd.grad(ssd_ops.ssd_scan(*ins)[pick].sum(), ins, allow_unused=True)
        ref_in = [torch.from_numpy(a).requires_grad_() for a in arrs]
        want = torch.autograd.grad(ssd_scan_ref(*ref_in)[pick].sum(), ref_in,
                                   allow_unused=True)
        assert [g is None for g in got] == [w is None for w in want]
        assert sum(g is None for g in got) == (0 if pick == 0 else 2)
        for g, w in zip(got, want):
            if w is not None:
                np.testing.assert_allclose(f32(g), f32(w), atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------- losses
def batch_of(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, size=(B, S)).astype(np.int32),
            "targets": rng.integers(0, vocab, size=(B, S)).astype(np.int32)}


def batch_for(cfg, B, S, seed):
    """``batch_of``'s tokens and targets, with the inputs of ``cfg``'s input
    mode: frame embeddings in place of the tokens (encoder), or vision
    embeddings ahead of them (VLM; the targets cover the text)."""
    b = batch_of(cfg.vocab_size, B, S, seed)
    rng = np.random.default_rng(seed + 1000)
    if cfg.input_mode == "embeds":
        del b["tokens"]
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    elif cfg.input_mode == "vlm":
        b["vision_embeds"] = rng.standard_normal((B, cfg.vision_seq, cfg.d_model)).astype(
            np.float32)
    return b


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("arch,flag", [("tinyllama-1.1b", "use_flash"),
                                       ("mamba2-2.7b", "use_ssd_kernel"),
                                       ("zamba2-1.2b", "use_ssd_kernel"),
                                       ("zamba2-1.2b", "use_flash"),
                                       ("hubert-xlarge", "use_flash"),
                                       ("qwen2-moe-a2.7b", "use_flash")])
def test_model_level_kernel_equivalence(arch, flag):
    """The rows of tests/test_kernels.py's test (tinyllama, mamba2, and
    zamba2 with the SSD kernel), zamba2 with the flash kernel, and the
    encoder (bidirectional) and MoE families with it: the loss with the
    kernel flag on and off agree within 1e-3, and so do the gradients
    (within 1e-4 of each leaf's largest |g|)."""
    cfg0 = get_smoke_config(arch).replace(dtype=torch.float32)
    params = Model(cfg0).init(1, device="cpu")
    b = torch_batch(batch_for(cfg0, 2, 64, 2))
    losses, grads = [], []
    for on in (False, True):
        loss = Model(cfg0.replace(**{flag: on})).loss(params, b)
        losses.append(float(loss.detach()))
        grads.append(torch.autograd.grad(loss, list(params.parameters())))
    assert abs(losses[0] - losses[1]) < 1e-3, arch
    for g0, g1 in zip(*grads):
        assert float((g0 - g1).abs().max()) <= GRAD_TOL * float(g0.abs().max())


XENT_CASES = {
    # (padded width, real vocab, fraction of labels -1, z_loss)
    "padded_vocab": (384, 300, 0.0, 0.0),
    "ignored_labels": (256, 256, 0.3, 0.0),
    "all_ignored": (384, 300, 1.0, 0.0),
    "z_loss": (384, 300, 0.2, 1e-4),
}


@pytest.mark.parametrize("name", list(XENT_CASES))
def test_softmax_xent_matches_jax(name, jx):
    vpad, vocab, ignored, z = XENT_CASES[name]
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((2, 16, vpad)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, size=(2, 16)).astype(np.int32)
    labels[rng.random((2, 16)) < ignored] = -1
    t_logits = torch.from_numpy(logits).requires_grad_()
    loss = softmax_xent(t_logits, torch.from_numpy(labels), vocab, z_loss=z)
    (g,) = torch.autograd.grad(loss, t_logits)
    jloss, jg = jx.jax.value_and_grad(
        lambda lg: jx.xent(lg, jx.jnp.asarray(labels), vocab, z_loss=z))(jx.jnp.asarray(logits))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6, abs=1e-6)
    np.testing.assert_allclose(f32(g), f32(jg), atol=1e-7, rtol=1e-5)
    assert not g[..., vocab:].any()      # no gradient reaches the padded columns
    if ignored == 1.0:
        assert float(loss.detach()) == 0.0


LOSS_CONFIGS = {
    # name: (config source, arch or preset)
    "tinyllama-smoke": ("smoke", "tinyllama-1.1b"),
    "preset-5m": ("preset", "5m"),
    "mamba2-smoke": ("smoke", "mamba2-2.7b"),
    "smollm-smoke": ("smoke", "smollm-360m"),          # tied embeddings
    "granite-20b-smoke": ("smoke", "granite-20b"),     # MQA
    "granite-34b-smoke": ("smoke", "granite-34b"),
    "zamba2-smoke": ("smoke", "zamba2-1.2b"),          # hybrid: shared block at 3 sites
    "qwen2-moe-smoke": ("smoke", "qwen2-moe-a2.7b"),   # MoE top-4 of 8 + shared experts
    "mixtral-smoke": ("smoke", "mixtral-8x22b"),       # MoE top-2 of 4, window 16
    "hubert-smoke": ("smoke", "hubert-xlarge"),        # encoder: frame embeddings, no embed
    "llava-smoke": ("smoke", "llava-next-mistral-7b"),  # VLM: loss over the text tail
}


def configs(jx, name, **kw):
    """The JAX and port configs of ``name`` at fp32, with ``kw`` on both."""
    src, key = LOSS_CONFIGS[name]
    if src == "smoke":
        jcfg, tcfg = jx.smoke(key), get_smoke_config(key)
    else:
        jcfg, tcfg = jx.PRESETS[key], PRESETS[key]
    return (jcfg.replace(dtype=jx.jnp.float32, **kw),
            tcfg.replace(dtype=torch.float32, **kw))


def compare_grads(tgrads: dict, jgrads, msg=""):
    """Port gradients keyed by state_dict name against the JAX grad tree."""
    from repro_torch.convert import named_to_jax
    jflat = dict(_flat(jgrads))
    tflat = dict(_flat(named_to_jax(tgrads)))
    assert tflat.keys() == jflat.keys()
    for k, want in jflat.items():
        want = np.asarray(want)
        err = np.abs(tflat[k] - want).max()
        assert err <= GRAD_TOL * np.abs(want).max(), (msg, k, err, np.abs(want).max())


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("name", list(LOSS_CONFIGS))
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(name, remat, jx):
    """transformer_loss (tinyllama, smollm, granite-20b and granite-34b
    smoke, PRESETS['5m']; qwen2-moe and mixtral smoke with the MoE aux
    term; hubert smoke on frame embeddings; llava smoke past its vision
    prefix), ssm_loss (mamba2 smoke) and hybrid_loss (zamba2 smoke, the
    shared block's gradients summed over its sites) and their gradients,
    with remat on and off, from the JAX package's init."""
    from repro_torch.convert import from_jax
    jcfg, tcfg = configs(jx, name, remat=remat)
    jp = jx.Model(jcfg).init(jx.jax.random.PRNGKey(0))[0]
    tp = from_jax(tcfg, jp, device="cpu")
    b = batch_for(jcfg, 2, 32, 6)
    jl, jg = jx.jax.value_and_grad(jx.Model(jcfg).loss)(
        jp, {k: jx.jnp.asarray(v) for k, v in b.items()})
    loss = Model(tcfg).loss(tp, torch_batch(b))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_TOL, (loss.item(), float(jl))
    compare_grads({k: p.grad for k, p in tp.named_parameters()}, jg, name)


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("name", ["preset-5m", "tinyllama-smoke", "zamba2-smoke",
                                  "qwen2-moe-smoke"])
def test_three_train_steps_match_jax(name, jx):
    """Three steps of the port's train_step against the reference train loop's
    (value_and_grad of the loss, then adamw_update) from converted weights
    on the same SyntheticCorpus batches: the per-step losses within 1e-4."""
    from repro.data import SyntheticCorpus
    from repro_torch.convert import from_jax
    jcfg, tcfg = configs(jx, name, remat=name != "preset-5m")
    kw = dict(lr=1e-3, total_steps=3, warmup_steps=1)
    jopt, topt = jx.adamw.AdamWConfig(**kw), AdamWConfig(**kw)
    jp = jx.Model(jcfg).init(jx.jax.random.PRNGKey(0))[0]
    tp = from_jax(tcfg, jp, device="cpu")
    js, ts = jx.adamw.adamw_init(jp), adamw_init(tp.state_dict())
    corpus = SyntheticCorpus(jcfg.vocab_size, 32, 2, seed=0)
    jmodel, tmodel = jx.Model(jcfg), Model(tcfg)

    @jx.jax.jit
    def jstep(p, s, b):
        loss, g = jx.jax.value_and_grad(jmodel.loss)(p, b)
        p, s, gnorm = jx.adamw.adamw_update(g, p, s, jopt)
        return p, s, loss, gnorm

    for step in range(3):
        b = corpus.batch(step)
        jp, js, jl, jn = jstep(jp, js, {k: jx.jnp.asarray(v) for k, v in b.items()})
        ts, tl, tn = train_step(tmodel, tp, ts, b, topt)
        assert abs(float(tl) - float(jl)) <= 1e-4, (step, float(tl), float(jl))
        assert float(tn) == pytest.approx(float(jn), rel=1e-4)
    assert int(ts.count) == 3


# ----------------------------------------------------- train() end to end
def test_train_loss_improves():
    out = train(PRESETS["5m"], steps=16, batch=2, seq=32, ckpt_dir=None,
                ckpt_every=0, io_aware=True, device="cpu")
    assert out["steps_run"] == 16
    # every step's loss is measured on a different (noisy) batch of 2, so the
    # endpoints alone are dominated by batch variance: compare window means
    ls = out["losses"]
    assert sum(ls[-3:]) / 3 < sum(ls[:3]) / 3


def test_resume_continues_from_checkpoint(tmp_path):
    ck = tmp_path / "ck"
    kw = dict(batch=2, seq=32, ckpt_every=3, io_aware=True, device="cpu")
    train(PRESETS["5m"], steps=6, ckpt_dir=str(ck), **kw)
    out2 = train(PRESETS["5m"], steps=10, ckpt_dir=str(ck), resume=True, **kw)
    # resumed from step 5 -> only 4 more steps run
    assert out2["steps_run"] == 4
    # deterministic data + restored state: the continued run must match a
    # straight 10-step run's tail losses closely
    full = train(PRESETS["5m"], steps=10, ckpt_dir=None, **kw)
    for a, b in zip(out2["losses"], full["losses"][6:]):
        assert abs(a - b) < 0.05, (out2["losses"], full["losses"][6:])


def test_baseline_mode_syncs(tmp_path):
    ck = tmp_path / "ck"
    out = train(PRESETS["5m"], steps=4, batch=2, seq=32, ckpt_dir=str(ck),
                ckpt_every=2, io_aware=False, device="cpu")
    assert out["steps_run"] == 4
    assert (ck / "step_00000003").exists()


# ------------------------------------------------------------ on the card
CUDA_FLASH = [("float32", 2e-5, 1e-3), ("bfloat16", 2e-2, 5e-2), ("float16", 5e-3, 5e-2)]
CUDA_SSD = [("float32", 1e-4, 1e-3), ("bfloat16", 5e-2, 5e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype,out_tol,grad_tol",
                         [("flash", *c) for c in CUDA_FLASH] + [("ssd", *c) for c in CUDA_SSD])
def test_cuda_grads_through_the_kernel(kernel, dtype, out_tol, grad_tol):
    """On the card, each kernel route (by dtype) against the plain route: a
    model whose loss goes through the kernel gives every parameter a
    gradient, and gradients that agree with the plain path's within
    ``grad_tol`` of each leaf's largest |g| (the forwards differ by the
    kernel's tolerance ``out_tol``, the backwards are the same recompute)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if kernel == "flash":       # head_dim 64, a size the kernel takes
        cfg, flag = get_smoke_config("tinyllama-1.1b").replace(
            d_model=256, n_heads=4, n_kv_heads=2), "use_flash"
        counter, S = flash_ops.flash_attention, 192
    else:
        cfg, flag, counter, S = get_smoke_config("mamba2-2.7b"), "use_ssd_kernel", \
            ssd_ops.ssd_scan, 64
    cfg = cfg.replace(dtype=getattr(torch, dtype), remat=True)
    params = Model(cfg).init(0, device="cuda")
    b = {k: v.cuda() for k, v in torch_batch(batch_of(cfg.vocab_size, 2, S, 7)).items()}
    grads, losses = [], []
    for on in (True, False):
        n0 = counter.launches
        loss = Model(cfg.replace(**{flag: on})).loss(params, b)
        loss.backward()
        torch.cuda.synchronize()
        assert counter.launches - n0 == (2 * cfg.n_layers if on else 0)
        missing = [k for k, p in params.named_parameters() if p.grad is None]
        assert not missing, f"no gradient through the kernel for {missing}"
        grads.append({k: p.grad.float() for k, p in params.named_parameters()})
        losses.append(loss.item())
        params.zero_grad(set_to_none=True)
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) <= max(out_tol, 1e-3) * max(1.0, abs(losses[1]))
    for k, g in grads[0].items():
        want = grads[1][k]
        assert float((g - want).abs().max()) <= grad_tol * float(want.abs().max()), k
