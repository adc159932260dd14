"""The hybrid slice: the port's zamba2 (shared attention block over
concat(h, h0) every ``attn_every`` Mamba2 layers) on the zamba2-1.2b smoke
config at fp32 (5 layers, d_model 64, 4 heads of 16, state 16, chunk 8,
attention at layers 0, 2 and 4), with weights carried over from the JAX
package's own init, against the JAX package. On the CPU the port runs the
plain versions of both kernels; the JAX side runs its Pallas kernels in
interpret mode where a flag turns them on."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.serve import serve as jax_serve
from repro.models import Model as JaxModel
from repro.models import attention as jattn
from repro.models import zamba2 as jz
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax, to_jax
from repro_torch.launch.serve import serve
from repro_torch.models import Model
from repro_torch.models import attention as tattn
from repro_torch.models import zamba2 as tz

ARCH = "zamba2-1.2b"
SEED = 0
REL = 1e-5      # fp32 outputs: within this fraction of the largest |output|
TOL = 1e-4      # fp32 logits, as the other serving slices' tests
KERNELS = [(False, False), (True, False), (False, True), (True, True)]


def configs(use_flash=False, use_ssd_kernel=False, **kw):
    flags = dict(use_flash=use_flash, use_ssd_kernel=use_ssd_kernel, **kw)
    return (jax_smoke_config(ARCH).replace(dtype=jnp.float32, **flags),
            get_smoke_config(ARCH).replace(dtype=torch.float32, **flags))


def jax_params(jcfg):
    return JaxModel(jcfg).init(jax.random.PRNGKey(SEED))[0]


def close_rel(t, j, rel=REL, msg=""):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, atol=rel * np.abs(j).max(), rtol=0,
                               err_msg=msg)


def test_layout_of_the_smoke_config():
    _, tcfg = configs()
    assert tz._sites(tcfg) == [0, 2, 4]
    assert tz._segments(tcfg) == [(0, 2), (2, 4), (4, 5)]
    p = Model(tcfg).init(0, device="cpu")
    D = tcfg.d_model
    assert p.shared.q.shape == (2 * D, 4, 16) and p.shared.o.shape == (4, 16, D)
    assert p.shared.ln1.shape == (2 * D,) and p.shared.ln1.dtype == torch.float32
    assert len(p.mamba_layers) == 5 and p.head.shape == (D, 256)


def shared_weights(jcfg, tcfg):
    jp = jax_params(jcfg)["shared"]
    return jp, from_jax(tcfg, jax_params(jcfg), device="cpu").shared


@pytest.mark.parametrize("use_flash", [False, True])
def test_shared_attn_full_and_step_match_jax(use_flash):
    """The shared block over a prompt (its flash route or the dense one),
    then three single-token steps against a KV cache."""
    jcfg, tcfg = configs(use_flash)
    jp, tp = shared_weights(jcfg, tcfg)
    B, S, D = 2, 16, tcfg.d_model
    rng = np.random.default_rng(1)
    h, h0 = (rng.standard_normal((B, S, D)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(S), (B, S))
    with torch.no_grad():
        got = tz._shared_attn_full(tp, torch.from_numpy(h), torch.from_numpy(h0), tcfg,
                                   torch.from_numpy(pos.copy()))
    close_rel(got, jz._shared_attn_full(jp, jnp.asarray(h), jnp.asarray(h0), jcfg,
                                        jnp.asarray(pos)))

    jc = jattn.KVCache.init(B, 8, 4, 16, jnp.float32)
    tc = tattn.KVCache.init(B, 8, 4, 16, torch.float32)
    for step in range(3):
        x, x0 = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(2))
        with torch.no_grad():
            got, tc2 = tz._shared_attn_step(tp, torch.from_numpy(x), torch.from_numpy(x0),
                                            tcfg, tc, step)
        want, jc = jz._shared_attn_step(jp, jnp.asarray(x), jnp.asarray(x0), jcfg, jc,
                                        jnp.asarray(step, jnp.int32))
        assert tc2.k is tc.k                    # updated in place
        close_rel(got, want, msg=f"step {step}")
        close_rel(tc.k, jc.k, msg=f"k after step {step}")
        np.testing.assert_array_equal(tc.slot_pos.numpy(), np.asarray(jc.slot_pos))


@pytest.mark.parametrize("use_flash,use_ssd_kernel", KERNELS)
def test_zamba2_forward_matches_jax(use_flash, use_ssd_kernel):
    jcfg, tcfg = configs(use_flash, use_ssd_kernel)
    jp = jax_params(jcfg)
    tp = from_jax(tcfg, jp, device="cpu")
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32), (2, 32))
    with torch.no_grad():
        got = tz.zamba2_forward(tp, tcfg, torch.from_numpy(h), torch.from_numpy(pos.copy()))
    close_rel(got, jz.zamba2_forward(jp, jcfg, jnp.asarray(h), jnp.asarray(pos)))


def batch_of(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, size=(B, S)).astype(np.int32),
            "targets": rng.integers(0, vocab, size=(B, S)).astype(np.int32)}


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_through_both_kernels_match_jax(remat):
    """``Model.loss`` with both kernel flags on (the port's autograd
    wrappers; the JAX package's custom_vjps over interpret-mode Pallas):
    the loss within 1e-5 and every gradient leaf, ``shared.*`` included,
    within 1e-4 of its largest |g|. The shared block's gradients sum over
    its three sites."""
    from test_torch_train import GRAD_TOL, LOSS_TOL, compare_grads
    jcfg, tcfg = configs(True, True, remat=remat)
    jp = jax_params(jcfg)
    tp = from_jax(tcfg, jp, device="cpu")
    b = batch_of(jcfg.vocab_size, 2, 32, 6)
    jl, jg = jax.value_and_grad(JaxModel(jcfg).loss)(jp, {k: jnp.asarray(v)
                                                          for k, v in b.items()})
    loss = Model(tcfg).loss(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_TOL
    grads = {k: p.grad for k, p in tp.named_parameters()}
    assert all(g is not None for g in grads.values())
    assert float(grads["shared.q"].abs().max()) > GRAD_TOL
    compare_grads(grads, jg, ARCH)


@pytest.mark.parametrize("use_flash,use_ssd_kernel", [(False, False), (True, True)])
def test_prefill_and_decode_match_jax(use_flash, use_ssd_kernel):
    """Prefill logits, then 4 teacher-forced decode steps. The reference's
    quirk is kept: prefill hands back a fresh, empty state at pos 0, so the
    decode does not see the prompt."""
    jcfg, tcfg = configs(use_flash, use_ssd_kernel)
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
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    assert ts.pos == int(js.pos) == 0                       # the quirk
    for name, t, j in zip(("mamba", "attn"), (ts.mamba, ts.attn), (js.mamba, js.attn)):
        for field, a, b in zip(t._fields, t, j):
            assert tuple(a.shape) == b.shape, (name, field)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name}.{field}")
    assert not ts.mamba.h.any() and (ts.attn.slot_pos == -1).all()
    for t in range(steps):
        jl, js = jm.decode_step(jp, js, jnp.asarray(forced[t]))
        tl, ts = tm.decode_step(tp, ts, torch.from_numpy(forced[t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {t}")
        np.testing.assert_allclose(ts.mamba.h.numpy(), np.asarray(js.mamba.h), atol=TOL,
                                   rtol=TOL, err_msg=f"h after decode step {t}")
    np.testing.assert_allclose(ts.attn.k.numpy(), np.asarray(js.attn.k), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(ts.attn.slot_pos.numpy(), np.asarray(js.attn.slot_pos))
    assert ts.pos == int(js.pos) == steps


def test_prefill_needs_a_whole_number_of_chunks():
    _, tcfg = configs()
    m = Model(tcfg)
    p = m.init(0, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        m.prefill(p, {"tokens": torch.zeros((1, 12), dtype=torch.long)}, 16)


@pytest.mark.parametrize("use_flash,use_ssd_kernel", [(False, False), (True, True)])
def test_serve_completions_match_jax(use_flash, use_ssd_kernel, tmp_path):
    jcfg, tcfg = configs(use_flash, use_ssd_kernel)
    kw = dict(n_requests=4, prompt_len=16, max_new=4, batch=2, seed=SEED)
    ref = jax_serve(jcfg, **kw)
    out = serve(tcfg, device="cpu", params=from_jax(tcfg, jax_params(jcfg), device="cpu"),
                trace_path=str(tmp_path / "trace.jsonl"), **kw)
    assert set(out) == set(ref)
    assert out["requests"] == ref["requests"] == 4
    assert out["new_tokens"] == ref["new_tokens"] == 16
    assert [c["tokens"] for c in out["completions"]] == \
        [c["tokens"] for c in ref["completions"]]
    assert len((tmp_path / "trace.jsonl").read_text().splitlines()) == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip(dtype):
    """JAX tree -> port -> JAX tree, leaf for leaf: ``mamba_layers`` split
    on its stacked axis and stacked again, ``shared`` as it is."""
    jcfg = jax_smoke_config(ARCH).replace(dtype=getattr(jnp, dtype))
    tcfg = get_smoke_config(ARCH).replace(dtype=getattr(torch, dtype))
    jp = jax_params(jcfg)
    tp = from_jax(tcfg, jp, device="cpu")
    assert tp.mamba_layers[3].in_x.shape == jp["mamba_layers"]["in_x"].shape[1:]
    assert tp.mamba_layers[1].ln.dtype == torch.float32       # norms stay fp32
    assert tp.shared.q.dtype == getattr(torch, dtype)
    back = to_jax(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        got = flat_b[path]
        assert got.dtype == np.asarray(leaf).dtype and got.shape == leaf.shape
        np.testing.assert_array_equal(got.astype(np.float32),
                                      np.asarray(leaf).astype(np.float32))
    again = from_jax(tcfg, back, device="cpu")
    for (na, a), (nb, b) in zip(tp.state_dict().items(), again.state_dict().items()):
        assert na == nb and torch.equal(a, b)
