"""The SSM serving slice: the port's Mamba2 block, the SSM model's prefill /
decode and ``serve`` on the mamba2-2.7b smoke config at fp32, with weights
carried over from the JAX package's own init, against the JAX package. On
the CPU the kernel route (``use_ssd_kernel``) runs the port's plain scan,
and the JAX side runs its Pallas kernel in interpret mode."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.serve import serve as jax_serve
from repro.models import Model as JaxModel
from repro.models import mamba2 as jm2
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax, to_jax
from repro_torch.launch.serve import serve
from repro_torch.models import Model
from repro_torch.models import mamba2 as tm2
from repro_torch.models import model as tmodel

ARCH = "mamba2-2.7b"
SEED = 0
TOL = 1e-4   # fp32: summation order differs between XLA and torch CPU


def configs(use_kernel=False):
    jcfg = jax_smoke_config(ARCH).replace(dtype=jnp.float32, use_ssd_kernel=use_kernel)
    tcfg = get_smoke_config(ARCH).replace(dtype=torch.float32, use_ssd_kernel=use_kernel)
    return jcfg, tcfg


def jax_params(jcfg):
    return JaxModel(jcfg).init(jax.random.PRNGKey(SEED))[0]


def close(t, j, tol=TOL, msg=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=tol,
                               err_msg=msg)


def block_params(d_model=32, headdim=8, state=8, seed=0):
    """One JAX Mamba2 param dict (with A_log, D and dt_bias moved off their
    constant inits, so that every term counts) and the port's block
    holding the same weights."""
    jp, _ = jm2.mamba2_init(jax.random.PRNGKey(seed), d_model, headdim=headdim,
                            ssm_state=state, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    for k in ("A_log", "D", "dt_bias"):
        jp[k] = jp[k] + jnp.asarray(0.3 * rng.standard_normal(jp[k].shape), jnp.float32)
    tp = tm2.Mamba2(d_model, headdim=headdim, ssm_state=state, dtype=torch.float32)
    tp.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()},
                       strict=True)
    return jp, tp


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(0)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 12, 6), (4, 6), (6,)))
    close(tm2._causal_conv(*map(torch.from_numpy, (x, w, b))),
          jm2._causal_conv(*map(jnp.asarray, (x, w, b))), 1e-6)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssd_chunked_matches_jax(use_kernel):
    b, S, H, P, N, chunk = 2, 32, 4, 8, 16, 8
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32) * 0.5
    dt = np.logaddexp(rng.standard_normal((b, S, H)), 0).astype(np.float32)
    B, C = (rng.standard_normal((b, S, N)).astype(np.float32) for _ in range(2))
    A_log = (0.2 * rng.standard_normal(H)).astype(np.float32)
    D = (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    args = (x, dt, B, C, A_log, D)
    ty, th = tm2.ssd_chunked(*map(torch.from_numpy, args), chunk, use_kernel=use_kernel)
    jy, jh = jm2.ssd_chunked(*map(jnp.asarray, args), chunk, use_kernel=use_kernel)
    close(ty, jy)
    close(th, jh)
    with pytest.raises(ValueError, match="multiple"):
        tm2.ssd_chunked(*map(torch.from_numpy, args), 6, use_kernel=use_kernel)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba2_forward_and_decode_match_jax(use_kernel):
    jp, tp = block_params()
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 16, 32)).astype(np.float32)
    with torch.no_grad():
        to, th = tm2.mamba2_forward(tp, torch.from_numpy(u), chunk=8, use_kernel=use_kernel)
    jo, jh = jm2.mamba2_forward(jp, jnp.asarray(u), chunk=8, use_kernel=use_kernel)
    close(to, jo)
    close(th, jh)

    # three decode steps from the prefill's state and a non-zero conv window
    jc = jm2.MambaCache(
        conv_x=jnp.asarray(rng.standard_normal((2, 3, 64)), jnp.float32),
        conv_bc=jnp.asarray(rng.standard_normal((2, 3, 16)), jnp.float32), h=jh)
    tc = tm2.MambaCache(*(torch.from_numpy(np.array(a)) for a in jc))
    for step in range(3):
        tok = rng.standard_normal((2, 32)).astype(np.float32)
        with torch.no_grad():
            to, tc2 = tm2.mamba2_decode(tp, torch.from_numpy(tok), tc)
        jo, jc = jm2.mamba2_decode(jp, jnp.asarray(tok), jc)
        assert tc2.h is tc.h            # updated in place
        close(to, jo, msg=f"decode step {step}")
        for name, a, b in zip(tc._fields, tc, jc):
            close(a, b, msg=f"{name} after decode step {step}")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_match_jax(use_kernel):
    jcfg, tcfg = configs(use_kernel)
    jp = jax_params(jcfg)
    tp = from_jax(tcfg, jp, device="cpu")
    B, S, steps = 2, 16, 4
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab_size, size=(steps, B)).astype(np.int32)

    jm, tm = JaxModel(jcfg), Model(tcfg)
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, S + steps)
    tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)}, S + steps)
    assert tl.shape == (B, 256)
    close(tl, jl)
    close(ts.caches.h, js.caches.h)
    assert ts.pos == int(js.pos)
    for name in ("conv_x", "conv_bc"):   # the reference's zero conv caches
        assert not getattr(ts.caches, name).any()
        assert getattr(ts.caches, name).shape == getattr(js.caches, name).shape
    for t in range(steps):      # teacher-forced: both fed the same tokens
        jl, js = jm.decode_step(jp, js, jnp.asarray(forced[t]))
        tl, ts = tm.decode_step(tp, ts, torch.from_numpy(forced[t]))
        close(tl, jl, msg=f"decode step {t}")
        close(ts.caches.h, js.caches.h, msg=f"h after decode step {t}")
    close(ts.caches.conv_x, js.caches.conv_x)
    assert ts.pos == int(js.pos) == S + steps


def test_issued_decode_step_matches_jax():
    """The step as issued op by op, which runs off the card, at the first
    step of a shape on it and under a mesh (the card replays it from a CUDA
    graph after that), against the JAX decode step: logits and every cache
    after each of three steps."""
    jcfg, tcfg = configs()
    jp = jax_params(jcfg)
    tp = from_jax(tcfg, jp, device="cpu")
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    jm = JaxModel(jcfg)
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, 19)
    _, ts = Model(tcfg).prefill(tp, {"tokens": torch.from_numpy(prompt)}, 19)
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    for t in range(3):
        jl, js = jm.decode_step(jp, js, jnp.asarray(nxt))
        tl, ts = tmodel._ssm_issued_step(tp, tcfg, ts, torch.from_numpy(nxt))
        close(tl, jl, msg=f"decode step {t}")
        for name in ("conv_x", "conv_bc", "h"):
            close(getattr(ts.caches, name), getattr(js.caches, name), msg=f"{name}, step {t}")
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    assert ts.pos == int(js.pos) == 19


# fp16 end to end: both sides round every activation to fp16 (2^-11), in
# different orders. On the CPU the loss differed by 4.4e-5 of itself and the
# prefill logits by 1.0e-3 of the largest (1.5 fp16 steps there)
FP16_LOSS_RTOL, FP16_LOGITS_RTOL = 5e-4, 5e-3


def test_fp16_loss_and_prefill_through_the_kernel_match_jax():
    """The smoke config in fp16 with ``use_ssd_kernel``: the port's loss and
    prefill logits against the JAX package's, whose Pallas kernel returns y
    in x's dtype. The port's wrapper refused fp16 x on every device before
    (ROADMAP Queue 3 E)."""
    jcfg = jax_smoke_config(ARCH).replace(dtype=jnp.float16, use_ssd_kernel=True)
    tcfg = get_smoke_config(ARCH).replace(dtype=torch.float16, use_ssd_kernel=True)
    jp = jax_params(jcfg)
    tp = from_jax(tcfg, jp, device="cpu")
    assert tp.layers[0].in_x.dtype == torch.float16
    rng = np.random.default_rng(4)
    tokens, targets = (rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
                       for _ in range(2))
    jl = float(JaxModel(jcfg).loss(jp, {"tokens": jnp.asarray(tokens),
                                        "targets": jnp.asarray(targets)}))
    with torch.no_grad():
        tl = Model(tcfg).loss(tp, {"tokens": torch.from_numpy(tokens).long(),
                                   "targets": torch.from_numpy(targets).long()}).item()
        tlog, _ = Model(tcfg).prefill(tp, {"tokens": torch.from_numpy(tokens)}, 16)
    jlog, _ = JaxModel(jcfg).prefill(jp, {"tokens": jnp.asarray(tokens)}, 16)
    assert np.isfinite(tl) and abs(tl - jl) <= FP16_LOSS_RTOL * abs(jl), (tl, jl)
    jlog = np.asarray(jlog, np.float32)
    tlog = tlog.float().numpy()
    assert tlog.shape == jlog.shape and np.isfinite(tlog).all()
    np.testing.assert_allclose(tlog, jlog, atol=FP16_LOGITS_RTOL * np.abs(jlog).max(), rtol=0)


def test_prefill_needs_a_whole_number_of_chunks():
    _, tcfg = configs()
    m = Model(tcfg)
    p = m.init(0, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        m.prefill(p, {"tokens": torch.zeros((1, 12), dtype=torch.long)}, 16)


def test_serve_completions_match_jax(tmp_path):
    jcfg, tcfg = configs(use_kernel=True)
    kw = dict(n_requests=4, prompt_len=16, max_new=4, batch=2, seed=SEED)
    ref = jax_serve(jcfg, **kw)
    path = tmp_path / "trace.jsonl"
    out = serve(tcfg, device="cpu", params=from_jax(tcfg, jax_params(jcfg), device="cpu"),
                trace_path=str(path), **kw)
    assert set(out) == set(ref)
    assert out["requests"] == ref["requests"] == 4
    assert out["new_tokens"] == ref["new_tokens"] == 16
    assert [c["tokens"] for c in out["completions"]] == \
        [c["tokens"] for c in ref["completions"]]
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert sorted(r["args"]["request"] for r in rows) == [0, 1, 2, 3]


def test_serve_default_init_runs_on_cpu():
    _, tcfg = configs()
    out = serve(tcfg, n_requests=3, prompt_len=8, max_new=3, batch=2, device="cpu")
    assert out["requests"] == 3 and out["new_tokens"] == 9
    assert all(0 <= t < tcfg.vocab_size for c in out["completions"] for t in c["tokens"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip(dtype):
    jcfg = jax_smoke_config(ARCH).replace(dtype=getattr(jnp, dtype))
    tcfg = get_smoke_config(ARCH).replace(dtype=getattr(torch, dtype))
    jp = jax_params(jcfg)
    tp = from_jax(tcfg, jp, device="cpu")
    assert not hasattr(tp, "head")                      # tied embeddings
    assert tp.layers[0].in_bc.shape == jp["layers"]["in_bc"].shape[1:]
    assert tp.layers[0].in_x.dtype == getattr(torch, dtype)
    for name in ("A_log", "D", "dt_bias", "norm_w", "ln"):   # stay fp32
        assert getattr(tp.layers[2], name).dtype == torch.float32
    back = to_jax(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        got = flat_b[path]
        assert got.dtype == np.asarray(leaf).dtype and got.shape == leaf.shape
        np.testing.assert_array_equal(got.astype(np.float32),
                                      np.asarray(leaf).astype(np.float32))


def test_port_init_matches_the_reference_layout():
    """The port's own init: the reference's names, shapes, dtypes and
    constant inits."""
    jcfg, tcfg = configs()
    jp = jax_params(jcfg)
    tp = Model(tcfg).init(0, device="cpu")
    ref = {".".join(str(k.key) for k in path): leaf
           for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    got = to_jax(tp)
    got = {".".join(str(k.key) for k in path): leaf
           for path, leaf in jax.tree_util.tree_leaves_with_path(got)}
    assert set(got) == set(ref)
    for name, leaf in ref.items():
        assert got[name].shape == leaf.shape and got[name].dtype == np.asarray(leaf).dtype
    for name in ("A_log", "D", "dt_bias", "conv_x_b", "norm_w"):
        np.testing.assert_array_equal(got[f"layers.{name}"], np.asarray(ref[f"layers.{name}"]))
