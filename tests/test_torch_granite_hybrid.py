"""The port's granite-4.0-h-small (family ``moe_hybrid``) against the plain
float32 reference of the benchmark (``bench/models/granitemoehybrid.py``,
which imports nothing of the port), on seeded random weights at a tiny size
on the CPU: the prefill's last logits, prefill then decode against the
reference's one pass over prompt and served tokens, loss and gradients. The
dropless MoE dispatch against a per-token loop, with experts that get no
rows and every token routed to one expert, nothing dropped. The Mamba2
switches, with the JAX-parity tests of mamba2 and zamba2 holding their
defaults. The decode step with its position as a device tensor (what a
CUDA graph replays) against the step with an int. Marked ``cuda``: decode
steps on the card without a host sync, and the replayed step against the
step as issued, bit for bit, over two prompts:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_granite_hybrid.py``.

Tolerances: both sides compute in float32 with the same mathematics in
another order (the port's chunked scan, sort-based dispatch and cached
decode against the reference's closed-form chunks, per-expert loop and one
pass), so they agree to float32 rounding accumulated over ten layers: the
logits (magnitude ~0.1) to 1e-6, relative 1e-4; gradients likewise, with
the absolute term set by the smallest leaves (~1e-3)."""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bench.models import granitemoehybrid as ref_mod
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.models.mamba2 import MambaCache, mamba2_decode, mamba2_forward, mamba2_init
from repro_torch.models.model import model_class
from repro_torch.models import granite_hybrid
from repro_torch.models.moe import MoE, _dispatch_ffn, dropless_ffn

ROOT = Path(__file__).resolve().parents[1]
ATOL, RTOL = 1e-6, 1e-4


def tiny_config() -> dict:
    """The benchmark's config file cut to a CPU size: the first ten layers
    of the published pattern (attention at layer 5), every multiplier as
    published, the attention scale 1/head_dim as published."""
    c = copy.deepcopy(json.loads((ROOT / "bench/configs/granite-4.0-h-small.json").read_text()))
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, mamba_n_heads=8,
             mamba_d_head=16, mamba_d_state=16, mamba_chunk_size=8, num_local_experts=8,
             num_experts_per_tok=3, intermediate_size=32, shared_intermediate_size=48,
             vocab_size=256, num_hidden_layers=10, attention_multiplier=1 / 16,
             dtype="float32")
    return c


def port(c, seed=11):
    cfg = ref_mod.port_config(c, ModelConfig)
    params = model_class(cfg)(cfg, "cpu", None)
    params.load_state_dict(ref_mod.make_weights(c, seed, "cpu"))
    return Model(cfg), params


def tokens(c, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, c["vocab_size"], shape))


def reference(c, prompts, served, seed=11):
    W = ref_mod.make_weights(c, seed, "cpu")
    return ref_mod.served_logits(lambda k: W[k].float(), prompts, served, c)


def test_prefill_last_logits_match_the_reference():
    c = tiny_config()
    model, params = port(c)
    prompts, served = tokens(c, (2, 24), 1), tokens(c, (2, 2), 2)
    logits, state = model.prefill(params, {"tokens": prompts}, 26)
    torch.testing.assert_close(logits, reference(c, prompts, served)[:, 0], atol=ATOL, rtol=RTOL)
    assert state.pos == 24


def test_prefill_then_decode_matches_the_full_forward():
    """Eight decode steps through the caches (conv windows carried from the
    prompt, SSM states, KV caches) against one pass over the sequence."""
    c = tiny_config()
    model, params = port(c)
    prompts, served = tokens(c, (3, 16), 3), tokens(c, (3, 9), 4)
    logits, state = model.prefill(params, {"tokens": prompts}, 25)
    got = [logits]
    for j in range(8):
        logits, state = model.decode_step(params, state, served[:, j])
        got.append(logits)
    torch.testing.assert_close(torch.stack(got, 1), reference(c, prompts, served),
                               atol=ATOL, rtol=RTOL)


def test_loss_and_gradients_match_the_reference():
    c = tiny_config()
    model, params = port(c)
    toks = tokens(c, (2, 16), 5)
    targets = torch.roll(toks, -1, 1)
    loss = model.loss(params, {"tokens": toks, "targets": targets})
    loss.backward()
    W = {k: w.clone().requires_grad_() for k, w in ref_mod.make_weights(c, 11, "cpu").items()}
    # logits at every position: a one-token prompt, the rest as served tokens
    served = torch.cat([toks[:, 1:], toks[:, :1]], dim=1)
    logits = ref_mod.served_logits(lambda k: W[k], toks[:, :1], served, c)
    ref_loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
    ref_loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()), rel=1e-5)
    for k, p in params.named_parameters():
        torch.testing.assert_close(p.grad, W[k].grad, atol=1e-5, rtol=1e-3, msg=k)


# ------------------------------------------------------------ dropless MoE

def moe(seed=0, D=32, Fd=16, E=8):
    return MoE(D, Fd, E, torch.float32, 24, "cpu", torch.Generator().manual_seed(seed))


def per_token_loop(p, xt, k):
    """Each token's top-k experts one by one, weighted by the softmax over
    their logits: the published layer, with nothing shared among tokens."""
    top, idx = torch.topk(xt @ p.router, k, dim=-1)
    w = torch.softmax(top, dim=-1)
    y = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(k):
            e = idx[t, j]
            y[t] += w[t, j] * ((F.silu(xt[t] @ p.gate[e]) * (xt[t] @ p.up[e])) @ p.down[e])
    return y


@pytest.mark.parametrize("T,k", [(1, 1), (5, 3), (40, 2)])
def test_dropless_matches_a_per_token_loop(T, k):
    p = moe(T)
    xt = torch.randn((T, 32), generator=torch.Generator().manual_seed(T))
    torch.testing.assert_close(dropless_ffn(p, xt, k), per_token_loop(p, xt, k),
                               atol=1e-6, rtol=1e-5)


def test_every_token_to_one_expert_is_dropped_by_capacity_not_here():
    """Every token's top expert is expert 2: the capacity path drops all but
    ceil(1.25 T / E) of them, the dropless path computes every one, and
    experts 0, 1 and 3.. get no rows."""
    p = moe(1)
    with torch.no_grad():
        p.router.zero_()
        p.router[:, 2] = 1.0
    xt = torch.rand((24, 32), generator=torch.Generator().manual_seed(2)) + 0.1
    want = per_token_loop(p, xt, 1)
    torch.testing.assert_close(dropless_ffn(p, xt, 1), want, atol=1e-6, rtol=1e-5)
    capped, _ = _dispatch_ffn(p, xt, 1, 1.25)
    assert (capped.abs().sum(-1) == 0).sum() == 24 - 4      # ceil(1.25 * 24 / 8) = 4 kept


def test_grouped_mm_loop_matches_torch_grouped_mm():
    """``torch._grouped_mm``, which the dropless dispatch calls, against a
    loop over the groups on the same group ends, empty groups among them."""
    g = torch.Generator().manual_seed(4)
    x, w = torch.randn((13, 8), generator=g), torch.randn((5, 8, 4), generator=g)
    ends = torch.tensor([3, 3, 9, 9, 13], dtype=torch.int32)
    bounds = [0, *ends.tolist()]
    loop = torch.cat([x[a:b] @ w[e] for e, (a, b) in enumerate(zip(bounds, bounds[1:]))])
    torch.testing.assert_close(torch._grouped_mm(x, w, offs=ends), loop)


def test_dropless_gradients_match_the_loop():
    p = moe(3)
    xt = torch.randn((9, 32), generator=torch.Generator().manual_seed(5), requires_grad=True)
    dropless_ffn(p, xt, 3).square().sum().backward()
    got = [xt.grad] + [t.grad for t in (p.router, p.gate, p.up, p.down)]
    for t in (xt, p.router, p.gate, p.up, p.down):
        t.grad = None
    per_token_loop(p, xt, 3).square().sum().backward()
    want = [xt.grad] + [t.grad for t in (p.router, p.gate, p.up, p.down)]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


# ------------------------------------------------------------ Mamba2 switches

MAMBA_KEYS = {"hidden_size": 32, "mamba_expand": 2, "mamba_n_heads": 4, "mamba_d_head": 16,
              "mamba_n_groups": 1, "mamba_d_state": 8, "mamba_d_conv": 4,
              "mamba_chunk_size": 8, "rms_norm_eps": 1e-5}


def mamba_layer(seed):
    p = mamba2_init(torch.Generator().manual_seed(seed), 32, headdim=16, ssm_state=8,
                    dtype=torch.float32)
    with torch.no_grad():
        p.norm_w.uniform_(0.5, 1.5)
        p.A_log.uniform_(0.0, 2.0)
    return p


def test_gate_first_is_the_published_gated_norm():
    """``gate_first`` against the reference's mixer, rmsnorm(y * silu(z)), in
    prefill and in a decode step; the default differs from it."""
    p = mamba_layer(0)
    u = torch.randn((2, 8, 32), generator=torch.Generator().manual_seed(1))
    want = ref_mod._mamba(lambda n: getattr(p, n.split(".")[1]), u, MAMBA_KEYS, None)
    out, _ = mamba2_forward(p, u, chunk=8, gate_first=True)
    torch.testing.assert_close(out, want, atol=ATOL, rtol=RTOL)
    assert not torch.allclose(mamba2_forward(p, u, chunk=8)[0], want, atol=1e-3)
    cache = MambaCache.init(2, 32, headdim=16, ssm_state=8, dtype=torch.float32)
    step, _ = mamba2_decode(p, u[:, 0], cache, gate_first=True)
    torch.testing.assert_close(step, want[:, 0], atol=ATOL, rtol=RTOL)


def test_conv_windows_carry_the_prompt():
    """With ``windows`` the prefill hands decode the prompt's last 3 conv
    inputs: the next token's output is the one-pass forward's; the empty
    windows of the default give another."""
    p = mamba_layer(2)
    u = torch.randn((2, 24, 32), generator=torch.Generator().manual_seed(3))
    whole, _ = mamba2_forward(p, u, chunk=8)
    _, cache = mamba2_forward(p, u[:, :16], chunk=8, windows=True)
    assert cache.conv_x.shape == (2, 3, 64) and cache.conv_bc.shape == (2, 3, 16)
    step, _ = mamba2_decode(p, u[:, 16], cache)
    torch.testing.assert_close(step, whole[:, 16], atol=ATOL, rtol=RTOL)
    _, h_last = mamba2_forward(p, u[:, :16], chunk=8)
    empty = MambaCache.init(2, 32, headdim=16, ssm_state=8, dtype=torch.float32)
    fresh, _ = mamba2_decode(p, u[:, 16], empty._replace(h=h_last))
    assert not torch.allclose(fresh, whole[:, 16], atol=1e-3)


# ------------------------------------------------------------ config and the card

def test_smoke_config_runs_through_model():
    cfg = get_smoke_config("granite-4.0-h-small").replace(dtype=torch.float32)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16))
    logits, state = model.prefill(params, {"tokens": toks}, 20)
    logits, state = model.decode_step(params, state, logits.argmax(-1))
    assert logits.shape == (2, 256) and state.pos == 17
    assert state.mamba.h.shape[0] == 9 and state.attn.k.shape[0] == 1
    empty = model.init_decode_state(2, 20, device="cpu")
    assert empty.pos == 20 and empty.mamba.conv_x.shape == state.mamba.conv_x.shape


def test_decode_with_the_position_on_the_device_matches():
    """The step a CUDA graph replays reads ``pos`` from a device tensor: the
    same logits and caches, bit for bit, as the step given an int."""
    cfg = get_smoke_config("granite-4.0-h-small").replace(dtype=torch.float32)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(6))
    logits, state = model.prefill(params, {"tokens": toks}, 20)
    twin = state._replace(mamba=MambaCache(*(t.clone() for t in state.mamba)),
                          attn=type(state.attn)(*(t.clone() for t in state.attn)))
    nxt = logits.argmax(-1)
    for _ in range(3):
        a, state = granite_hybrid._step(params, cfg, state, nxt)
        b, twin = granite_hybrid._step(params, cfg, twin._replace(
            pos=torch.tensor([twin.pos], dtype=torch.int64)), nxt)
        twin = twin._replace(pos=int(twin.pos))
        assert torch.equal(a, b) and state.pos == twin.pos
        for x, y in zip((*state.mamba, *state.attn), (*twin.mamba, *twin.attn)):
            assert torch.equal(x, y)
        nxt = a.argmax(-1)


def _card_model():
    cfg = get_smoke_config("granite-4.0-h-small").replace(use_flash=True, use_ssd_kernel=True)
    model = Model(cfg)
    return cfg, model, model.init(0, device="cuda")


@pytest.mark.cuda
def test_decode_step_does_not_sync_the_host():
    """Neither the step as issued (a shape's first) nor a replayed one waits
    for the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg, model, params = _card_model()
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda")
    logits, state = model.prefill(params, {"tokens": toks}, 20)
    nxt = logits.argmax(-1)
    logits, state = model.decode_step(params, state, nxt)      # as issued
    logits, state = model.decode_step(params, state, nxt)      # captured, then replayed
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        issued, _ = granite_hybrid._step(params, cfg, state, nxt)
        logits, state = model.decode_step(params, state, nxt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert logits.shape == issued.shape == (2, 256) and state.pos == 19


@pytest.mark.cuda
def test_replayed_decode_matches_the_issued_step():
    """Two prompts of one shape, one after the other, through
    ``Model.decode_step`` (the first step issued, the rest replayed, the
    second prompt's state copied into the graph's buffers) against the step
    as issued on copies of the same states: the same logits and caches, bit
    for bit. A state the second prompt's steps overwrote is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg, model, params = _card_model()
    g = torch.Generator(device="cuda").manual_seed(8)
    stale = None
    for wave in range(2):
        toks = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda", generator=g)
        logits, state = model.prefill(params, {"tokens": toks}, 24)
        twin = state._replace(mamba=MambaCache(*(t.clone() for t in state.mamba)),
                              attn=type(state.attn)(*(t.clone() for t in state.attn)))
        nxt = logits.argmax(-1)
        for _ in range(6):
            a, state = model.decode_step(params, state, nxt)
            b, twin = granite_hybrid._step(params, cfg, twin, nxt)
            assert torch.equal(a, b)
            for x, y in zip((*state.mamba, *state.attn), (*twin.mamba, *twin.attn)):
                assert torch.equal(x, y)
            nxt = a.argmax(-1)
        if wave == 0:
            stale = state
    with pytest.raises(RuntimeError, match="overwritten"):
        model.decode_step(params, stale, nxt)
