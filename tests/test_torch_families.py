"""The port across every family of the JAX package's model zoo.

First the port's twin of tests/test_models_smoke.py: each of the ten
``ARCHS`` in its smoke config (bf16, as there) takes one forward and one
AdamW step, and the token-fed ones prefill and decode, all finite. Then the
encoder (hubert) and VLM (llava) modes against the JAX package at fp32 on
the CPU, from the JAX package's own init brought across by
repro_torch.convert and numpy-seeded inputs: ``Model.encode``, and the VLM's
prefill over its vision prefix followed by decode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import Model as JaxModel
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.convert import from_jax
from repro_torch.launch.train import train_step
from repro_torch.models import Model
from repro_torch.models.layers import pad_vocab
from repro_torch.optim import AdamWConfig, adamw_init

B, S = 2, 32
# fp32 logits: XLA and torch sum the layers' products in different orders
TOL = 1e-4


def make_batch(cfg, seed=1):
    """tests/test_models_smoke.py's batch for ``cfg``'s input mode, drawn
    with numpy: tokens, frame embeddings, or vision embeddings + tokens."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    if cfg.input_mode == "tokens":
        return {"tokens": tokens, "targets": targets}
    if cfg.input_mode == "embeds":
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                "targets": targets}
    return {"vision_embeds": rng.standard_normal((B, cfg.vision_seq, cfg.d_model)).astype(
        np.float32), "tokens": tokens, "targets": targets}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step(arch):
    """tests/test_models_smoke.py::test_forward_and_train_step on the port:
    the loss, its gradients and one AdamW step, every number finite."""
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    state = adamw_init(params.state_dict())
    state, loss, gnorm = train_step(model, params, state, make_batch(cfg), AdamWConfig())
    assert torch.isfinite(loss), f"{arch}: non-finite loss"
    assert torch.isfinite(gnorm), f"{arch}: non-finite grads"
    assert int(state.count) == 1
    assert all(torch.isfinite(p.float()).all() for p in params.parameters())


@pytest.mark.parametrize("arch", [a for a in ARCHS if get_smoke_config(a).supports_decode
                                  and get_smoke_config(a).input_mode == "tokens"])
def test_prefill_decode_consistency(arch):
    """tests/test_models_smoke.py::test_prefill_decode_consistency on the
    port: greedy decode after prefill gives finite logits of the padded
    vocabulary's width, and the position advances."""
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(make_batch(cfg)["tokens"])
    logits, state = model.prefill(params, {"tokens": toks}, 64)
    assert logits.shape == (B, pad_vocab(cfg.vocab_size))
    assert torch.isfinite(logits).all()
    nxt = logits[:, :cfg.vocab_size].argmax(-1)
    pos = state.pos
    for _ in range(3):
        logits, state = model.decode_step(params, state, nxt)
        assert torch.isfinite(logits).all()
        nxt = logits[:, :cfg.vocab_size].argmax(-1)
    assert state.pos == pos + 3


def configs(arch, use_flash):
    jcfg = jax_smoke_config(arch).replace(dtype=jnp.float32, use_flash=use_flash)
    tcfg = get_smoke_config(arch).replace(dtype=torch.float32, use_flash=use_flash)
    return jcfg, tcfg, JaxModel(jcfg).init(jax.random.PRNGKey(0))[0]


@pytest.mark.parametrize("use_flash", [False, True])
def test_encode_matches_jax(use_flash):
    """hubert's ``Model.encode``: logits over every frame, bidirectional
    attention (through the flash wrapper, or the dense path)."""
    jcfg, tcfg, jp = configs("hubert-xlarge", use_flash)
    tp = from_jax(tcfg, jp, device="cpu")
    assert not hasattr(tp, "embed")
    b = make_batch(tcfg)
    jl = JaxModel(jcfg).encode(jp, {"embeds": jnp.asarray(b["embeds"])})
    tl = Model(tcfg).encode(tp, {"embeds": torch.from_numpy(b["embeds"])})
    assert tl.shape == (B, S, pad_vocab(tcfg.vocab_size)) and not tl.requires_grad
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("use_flash", [False, True])
def test_vlm_prefill_and_decode_match_jax(use_flash):
    """llava: the prefill over the vision prefix and the text (its last
    logits and the KV cache), then three teacher-forced decode steps."""
    jcfg, tcfg, jp = configs("llava-next-mistral-7b", use_flash)
    tp = from_jax(tcfg, jp, device="cpu")
    b = make_batch(tcfg)
    total = tcfg.vision_seq + S
    forced = np.random.default_rng(2).integers(0, tcfg.vocab_size, size=(3, B)).astype(np.int32)
    jm, tm = JaxModel(jcfg), Model(tcfg)
    keys = ("vision_embeds", "tokens")
    jl, js = jm.prefill(jp, {k: jnp.asarray(b[k]) for k in keys}, total + 3)
    tl, ts = tm.prefill(tp, {k: torch.from_numpy(b[k]) for k in keys}, total + 3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ts.caches.k.numpy(), np.asarray(js.caches.k), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(ts.caches.slot_pos.numpy(), np.asarray(js.caches.slot_pos))
    assert ts.pos == int(js.pos) == total
    for t in range(3):
        jl, js = jm.decode_step(jp, js, jnp.asarray(forced[t]))
        tl, ts = tm.decode_step(tp, ts, torch.from_numpy(forced[t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {t}")
