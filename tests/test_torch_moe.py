"""The port's MoE (repro_torch.models.moe) against the JAX package's
(repro.models.moe), at fp32 on the CPU: the same numpy-seeded inputs, and
the JAX package's own init brought across by repro_torch.convert. The
routing is a step function of the router's logits, so each test first
checks that both packages chose the same top-k experts, then the outputs
within tolerance."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.moe import moe_apply as jax_moe_apply
from repro.models.moe import moe_init as jax_moe_init
from repro_torch.convert import state_dict_from_jax
from repro_torch.models.moe import MoE, _dispatch_ffn, capacity, moe_apply

# fp32: XLA and torch sum the D- and F-wide products in different orders
OUT_TOL = 1e-5
# fp32 gradients: each leaf within this fraction of its largest |g|
GRAD_TOL = 1e-4

CASES = {
    # name: (D, F, E, top-k, shared F, B, S)
    "qwen2-moe-smoke": (64, 96, 8, 4, 96, 2, 16),       # tests' smoke config shape
    "mixtral-smoke": (64, 128, 4, 2, 0, 2, 16),
    "decode-C1": (64, 32, 60, 4, 0, 4, 1),             # qwen's E and k at decode, B = 4
}


def make(name, skew=0.0, seed=0):
    """(JAX params, port MoE, x as numpy) for CASES[name]; ``skew`` adds to
    router column 0 so that expert 0 is in every token's top-k."""
    D, F, E, k, sh, B, S = CASES[name]
    jp, _ = jax_moe_init(jax.random.PRNGKey(seed), D, F, E, jnp.float32, shared_d_ff=sh)
    if skew:
        jp["router"] = jp["router"].at[:, 0].add(skew)
    m = MoE(D, F, E, torch.float32, sh, device="cpu")
    m.load_state_dict(state_dict_from_jax(jp), strict=True)
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)
    if skew:
        x = np.abs(x)          # every token's logit for expert 0 grows with skew
    return jp, m, x


def assert_same_routing(jp, m, x, k):
    """Both packages' top-k expert sets from their routers on ``x`` are
    equal; returns JAX's top-k ids, (T, k)."""
    xt = x.reshape(-1, x.shape[-1])
    jt = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(xt) @ jp["router"], -1), k)[1])
    with torch.no_grad():
        tt = torch.topk(torch.softmax(torch.from_numpy(xt) @ m.router, -1), k, dim=-1)[1]
    np.testing.assert_array_equal(np.sort(tt.numpy(), -1), np.sort(jt, -1))
    return jt


@pytest.mark.parametrize("name", list(CASES))
def test_moe_apply_matches_jax(name):
    """Output, aux and top-k experts at the qwen2-moe smoke shape (8
    experts, top-4, shared experts), the mixtral smoke shape (4, top-2) and
    qwen's decode size (60 experts, top-4, 4 tokens: C = 1)."""
    D, F, E, k, sh, B, S = CASES[name]
    jp, m, x = make(name)
    assert_same_routing(jp, m, x, k)
    jy, jaux = jax_moe_apply(jp, jnp.asarray(x), n_top=k)
    with torch.no_grad():
        ty, taux = moe_apply(m, torch.from_numpy(x), n_top=k)
    assert ty.shape == (B, S, D)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=OUT_TOL, rtol=OUT_TOL)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6, abs=1e-7)


def test_decode_size_drops_assignments_as_the_reference():
    """A quirk of the reference that the port keeps: at decode with batch 4,
    60 experts and top-4, the capacity is ceil(1.25 * 4 * 4 / 60) = 1 slot
    an expert, so a second token routed to the same expert is dropped (its
    weight lost, not renormalised). Both packages drop the same assignments."""
    D, F, E, k, sh, B, S = CASES["decode-C1"]
    assert capacity(B * S, k, E, 1.25) == 1
    found = 0
    for seed in range(8):
        jp, m, x = make("decode-C1", seed=seed)
        jt = assert_same_routing(jp, m, x, k)
        found += int(np.bincount(jt.reshape(-1), minlength=E).max() > 1)
        jy, _ = jax_moe_apply(jp, jnp.asarray(x), n_top=k)
        with torch.no_grad():
            ty, _ = moe_apply(m, torch.from_numpy(x), n_top=k)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=OUT_TOL, rtol=OUT_TOL)
    assert found, "no seed routed two tokens to one expert"


def test_capacity_overflow_drops_match_jax():
    """A skewed router sends every token to expert 0, past its capacity:
    the tokens after the first C in token order lose that expert's
    contribution, in both packages alike."""
    D, F, E, k, sh, B, S = CASES["mixtral-smoke"]
    jp, m, x = make("mixtral-smoke", skew=0.5)
    jt = assert_same_routing(jp, m, x, k)
    C = capacity(B * S, k, E, 1.25)
    assert (jt == 0).any(-1).all() and B * S > C         # expert 0 overflows
    jy, jaux = jax_moe_apply(jp, jnp.asarray(x), n_top=k)
    with torch.no_grad():
        ty, taux = moe_apply(m, torch.from_numpy(x), n_top=k)
        # the same layer with room for every assignment differs exactly
        # at the tokens past the capacity
        roomy, _ = _dispatch_ffn(m, torch.from_numpy(x).reshape(B * S, D), k, float(E))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=OUT_TOL, rtol=OUT_TOL)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    moved = (roomy.reshape(B, S, D) - ty).abs().amax(-1).reshape(-1) > 1e-6
    assert moved[:C].sum() == 0 and moved[C:].all()


@pytest.mark.parametrize("name", ["qwen2-moe-smoke", "mixtral-smoke"])
def test_moe_grads_match_jax(name):
    """Gradients of sum(y * w) + 3 aux with respect to every MoE leaf
    (router included, through the renormalised top-k weights and the aux)
    and to the input, against jax.grad."""
    D, F, E, k, sh, B, S = CASES[name]
    jp, m, x = make(name)
    assert_same_routing(jp, m, x, k)
    w = np.random.default_rng(9).standard_normal((B, S, D)).astype(np.float32)

    def jloss(p, xx):
        y, aux = jax_moe_apply(p, xx, n_top=k)
        return (y * w).sum() + 3.0 * aux
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe_apply(m, tx, n_top=k)
    ((y * torch.from_numpy(w)).sum() + 3.0 * aux).backward()
    want = state_dict_from_jax(jg)
    got = {n: p.grad for n, p in m.named_parameters()}
    assert got.keys() == want.keys()
    for n, g in list(got.items()) + [("x", tx.grad)]:
        ref = want[n].numpy() if n != "x" else np.asarray(jgx)
        err = np.abs(g.numpy() - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), (n, err, np.abs(ref).max())
    assert np.abs(want["router"].numpy()).max() > 0


def test_combine_is_deterministic_in_bf16():
    """Two runs in bf16 give the same bits: each token's k contributions are
    added in ascending expert order, never by atomics. The order is the
    reference's: that sum taken by hand, over every expert's output for
    every token (capacity factor E/k: C = T, so the products have the
    dispatch's shapes), is the output bit for bit."""
    D, F, E, k, sh, B, S = CASES["qwen2-moe-smoke"]
    T = B * S
    gen = torch.Generator().manual_seed(0)
    m = MoE(D, F, E, torch.bfloat16, 0, "cpu", gen)
    x = torch.randn((T, D), generator=gen).to(torch.bfloat16)
    cf = E / k
    assert capacity(T, k, E, cf) == T
    with torch.no_grad():
        a, _ = _dispatch_ffn(m, x, k, cf)
        b, _ = _dispatch_ffn(m, x, k, cf)
        assert torch.equal(a, b)
        xe = x.expand(E, T, D).contiguous()
        ye = torch.bmm(torch.nn.functional.silu(torch.bmm(xe, m.gate)) * torch.bmm(xe, m.up),
                       m.down)                                        # (E, T, D)
        topv, topi = torch.topk(torch.softmax(x.float() @ m.router, -1), k, -1)
        topv = (topv / topv.sum(-1, keepdim=True)).to(torch.bfloat16)
        for t in range(T):
            order = topi[t].argsort()
            acc = ye[topi[t, order[0]], t] * topv[t, order[0]]
            for j in order[1:]:
                acc = acc + ye[topi[t, j], t] * topv[t, j]
            assert torch.equal(a[t], acc), t


def test_capacity_is_the_reference_arithmetic():
    """C = max(1, ceil(1.25 * T * k / E)) in Python floats: qwen2-moe-a2.7b's
    prefill wave (4 x 1024 tokens) 342, one 1024-token sequence 86, decode
    at batch 4 one slot."""
    assert capacity(4096, 4, 60, 1.25) == 342
    assert capacity(1024, 4, 60, 1.25) == 86
    assert capacity(4, 4, 60, 1.25) == 1
    assert capacity(4096, 2, 8, 1.25) == 1280
    for T, k, E in ((7, 3, 5), (33, 2, 4), (1, 1, 64)):
        assert capacity(T, k, E, 1.25) == max(1, int(math.ceil(1.25 * T * k / E)))
