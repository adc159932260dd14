"""The plain references against the port at tiny sizes in float32 on the
CPU: the llama loss, gradients and AdamW steps, and Mamba2's logits over a
prompt and the tokens decoded after it."""
import numpy as np
import pytest
import torch

from bench.drivers import train as train_driver
from bench.lib import adamw as ref_adamw
from bench.lib import harness
from bench.lib.corpus import SyntheticCorpus
from bench.tests.tiny import tiny_cell


def port(c):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import Model
    from repro_torch.models.model import model_class
    mod = harness.model_module(c)
    cfg = mod.port_config(c, ModelConfig)
    params = model_class(cfg)(cfg, "cpu", None)
    params.load_state_dict(mod.make_weights(c, 11, "cpu"))
    return mod, Model(cfg), params


def test_llama_loss_grads_and_adamw_match_the_port():
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    c, tr = tiny_cell("smollm-360m.train", dtype="float32")
    mod, model, params = port(c)
    b = {k: torch.from_numpy(v) for k, v in
         SyntheticCorpus(c["vocab_size"], tr["seq"], tr["batch"], 11).batch(0).items()}
    loss = model.loss(params, b)
    loss.backward()
    W = {k: w.clone().requires_grad_() for k, w in mod.make_weights(c, 11, "cpu").items()}
    ref_loss, grads = mod.loss_and_grads(W, b, c)
    assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-5)
    for k, p in params.named_parameters():
        torch.testing.assert_close(grads[k], p.grad, rtol=1e-4, atol=1e-6)
    named = dict(params.named_parameters())
    o = tr["optimizer"]
    state = adamw_init(params.state_dict())
    adamw_update({k: p.grad for k, p in named.items()}, named, state, AdamWConfig(**o))
    stored = {k: w.detach().clone() for k, w in W.items()}
    # the same gradients on both sides: this holds the update's arithmetic
    ref_adamw.step(stored, {k: p.grad for k, p in named.items()}, {"m": {}, "v": {}}, o, 1)
    for k, p in named.items():
        torch.testing.assert_close(stored[k], p.detach(), rtol=1e-5, atol=1e-7)


def test_mamba2_served_logits_match_the_port():
    c, tr = tiny_cell("mamba2-2.7b.serve_long", dtype="float32")
    mod, model, params = port(c)
    rng = np.random.default_rng(3)
    S, n = 24, 5
    prompts = torch.from_numpy(rng.integers(0, c["vocab_size"], (2, S)))
    served = torch.from_numpy(rng.integers(0, c["vocab_size"], (2, n)))
    logits, state = model.prefill(params, {"tokens": prompts}, S + n)
    got = [logits]
    for j in range(n - 1):
        logits, state = model.decode_step(params, state, served[:, j])
        got.append(logits)
    V = mod.logits_width(c)
    got = torch.stack(got, 1)[..., :V]
    W = mod.make_weights(c, 11, "cpu")
    ref = mod.served_logits(lambda k: W[k].float(), prompts, served, c)
    torch.testing.assert_close(ref, got, rtol=1e-4, atol=1e-4)


def test_mamba2_reference_chunks_agree_with_the_recurrence():
    from bench.models.mamba2 import ssd
    g = torch.Generator().manual_seed(0)
    b, S, H, P, N = 2, 13, 3, 4, 5
    x, Bm, Cm = (torch.randn(s, generator=g) for s in ((b, S, H, P), (b, S, N), (b, S, N)))
    dt = torch.rand((b, S, H), generator=g)
    A = -torch.rand(H, generator=g) * 4
    h0 = torch.randn((b, H, N, P), generator=g)
    y, h = ssd(x, dt, A, Bm, Cm, h0, chunk=4)
    hs, ys = h0.clone(), []
    for t in range(S):
        hs = hs * torch.exp(dt[:, t] * A)[..., None, None] + \
            torch.einsum("bn,bhp->bhnp", Bm[:, t], x[:, t] * dt[:, t, :, None])
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], hs))
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, hs, rtol=1e-5, atol=1e-5)


def test_train_reference_reads_itself_as_sound():
    c, tr = tiny_cell("smollm-360m.train")
    ref = train_driver.reference(c, tr, 5, "cpu")
    out = train_driver.compare(ref["losses"], ref["g1"], ref["change"], ref)
    assert out == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
