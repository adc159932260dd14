"""The port's layers and attention against the JAX package's, at fp32 on
the CPU, on the same numpy inputs (tolerance 1e-5: only the order of the
sums differs)."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

TOL = 1e-5
B, S, D, H, KV, HD, F = 2, 16, 32, 4, 2, 8, 48


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=tol)


def attn_params(seed=0):
    return {"q": rnd(D, H, HD, seed=seed, scale=D ** -0.5),
            "k": rnd(D, KV, HD, seed=seed + 1, scale=D ** -0.5),
            "v": rnd(D, KV, HD, seed=seed + 2, scale=D ** -0.5),
            "o": rnd(H, HD, D, seed=seed + 3, scale=(H * HD) ** -0.5)}


def as_ns(p):
    return SimpleNamespace(**{k: torch.from_numpy(v) for k, v in p.items()})


def as_jnp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def test_rmsnorm():
    x, w = rnd(B, S, D), rnd(D, seed=1)
    close(tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
          jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))


def test_rmsnorm_keeps_dtype_and_fp32_weight():
    x = torch.from_numpy(rnd(B, S, D)).to(torch.bfloat16)
    w = tlayers.rmsnorm_init(D)
    assert w.dtype == torch.float32
    assert tlayers.rmsnorm(x, w).dtype == torch.bfloat16


@pytest.mark.parametrize("hd,theta", [(8, 1e4), (64, 1e4), (16, 5e5)])
def test_rope_freqs(hd, theta):
    np.testing.assert_array_equal(tlayers.rope_freqs(hd, theta).numpy(),
                                  np.asarray(jlayers.rope_freqs(hd, theta)))


@pytest.mark.parametrize("offset", [0, 1000])
def test_apply_rope(offset):
    x = rnd(B, S, H, HD)
    pos = np.broadcast_to(np.arange(S) + offset, (B, S)).astype(np.int32)
    close(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))


def test_mlp_apply():
    p = {"gate": rnd(D, F, seed=1, scale=D ** -0.5), "up": rnd(D, F, seed=2, scale=D ** -0.5),
         "down": rnd(F, D, seed=3, scale=F ** -0.5)}
    x = rnd(B, S, D)
    close(tlayers.mlp_apply(as_ns(p), torch.from_numpy(x)),
          jlayers.mlp_apply(as_jnp(p), jnp.asarray(x)))


def test_embed_lookup_and_pad_vocab():
    table = rnd(256, D)
    toks = np.random.default_rng(3).integers(0, 256, size=(B, S)).astype(np.int32)
    np.testing.assert_array_equal(
        tlayers.embed_lookup(torch.from_numpy(table), torch.from_numpy(toks)).numpy(),
        np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(toks), axis=0)))
    for v in (1, 128, 129, 32000, 50280, 151936):
        assert tlayers.pad_vocab(v) == jlayers.pad_vocab(v)


MASKS = [(True, 0), (False, 0), (True, 5), (False, 5)]


@pytest.mark.parametrize("causal,window", MASKS)
def test_mask(causal, window):
    qp = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    kp = qp[:, ::-1].copy()
    for q_pos, k_pos in ((qp, qp), (qp[:, 4:8], qp), (qp, kp)):
        np.testing.assert_array_equal(
            tattn._mask(torch.from_numpy(np.ascontiguousarray(q_pos)),
                        torch.from_numpy(np.ascontiguousarray(k_pos)), causal, window).numpy(),
            np.asarray(jattn._mask(jnp.asarray(q_pos), jnp.asarray(k_pos), causal, window)))


@pytest.mark.parametrize("route", ["dense", "chunked", "flash"])
@pytest.mark.parametrize("causal,window", MASKS)
def test_multihead_attn_routes(route, causal, window):
    p = attn_params()
    x = rnd(B, S, D, seed=7)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    kw = dict(causal=causal, window=window, rope_theta=1e4,
              use_flash=route == "flash", flash_block=8,
              chunk_q_threshold=8 if route == "chunked" else 8192, chunk_q=4)
    out, (k, v) = tattn.multihead_attn(as_ns(p), torch.from_numpy(x),
                                       torch.from_numpy(pos), return_kv=True, **kw)
    close(out, jattn.multihead_attn(as_jnp(p), jnp.asarray(x), jnp.asarray(pos), **kw))
    jk = jlayers.apply_rope(jnp.einsum("bsd,dhk->bshk", x, p["k"]), jnp.asarray(pos), 1e4)
    close(k, jk)
    close(v, jnp.einsum("bsd,dhk->bshk", x, p["v"]))


def run_decode(window, capacity, steps):
    """Feed `steps` tokens one at a time through both decode_attn's from
    an empty cache; compare every output and the final caches."""
    p = attn_params(seed=10)
    tc = tattn.KVCache.init(B, capacity, KV, HD, torch.float32)
    jc = jattn.KVCache.init(B, capacity, KV, HD, jnp.float32)
    for pos in range(steps):
        x = rnd(B, D, seed=100 + pos)
        to, tc = tattn.decode_attn(as_ns(p), torch.from_numpy(x), tc, pos,
                                   window=window, rope_theta=1e4)
        jo, jc = jattn.decode_attn(as_jnp(p), jnp.asarray(x), jc,
                                   jnp.asarray(pos, jnp.int32), window=window,
                                   rope_theta=1e4)
        close(to, jo)
    close(tc.k, jc.k)
    close(tc.v, jc.v)
    np.testing.assert_array_equal(tc.slot_pos.numpy(), np.asarray(jc.slot_pos))
    return tc


def test_decode_attn_rolling_window():
    W = 4
    tc = run_decode(window=W, capacity=tattn.cache_capacity(32, W), steps=11)
    assert sorted(tc.slot_pos.tolist()) == [7, 8, 9, 10]


def test_decode_attn_one_step_past_capacity():
    """No window, slot >= C: the K/V write clamps to slot C-1, the
    slot_pos write is dropped (as jax's dynamic_update_slice / scatter)."""
    C = 4
    tc = run_decode(window=0, capacity=C, steps=C + 1)
    assert tc.slot_pos.tolist() == [0, 1, 2, 3]


def test_cache_capacity():
    for s, w in ((100, 0), (100, 16), (8, 16)):
        assert tattn.cache_capacity(s, w) == jattn.cache_capacity(s, w)
