"""The serving slice as a whole: the port's prefill / decode / serve on the
tinyllama-1.1b smoke config at fp32, with weights carried over from the JAX
package's own init, against the JAX package."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.serve import serve as jax_serve
from repro.models import Model as JaxModel
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax, to_jax
from repro_torch.launch.serve import serve
from repro_torch.models import Model

ARCH = "tinyllama-1.1b"
SEED = 0
TOL = 1e-4   # fp32 logits: summation order differs between XLA and torch CPU

CASES = [  # (use_flash, sliding_window)
    (False, 0), (True, 0), (False, 8), (True, 8),
]


def configs(use_flash=False, window=0, arch=ARCH):
    jcfg = jax_smoke_config(arch).replace(dtype=jnp.float32, use_flash=use_flash,
                                          sliding_window=window)
    tcfg = get_smoke_config(arch).replace(dtype=torch.float32, use_flash=use_flash,
                                          sliding_window=window)
    return jcfg, tcfg


def jax_params(jcfg):
    return JaxModel(jcfg).init(jax.random.PRNGKey(SEED))[0]


@pytest.mark.parametrize("arch,use_flash,window",
                         [(ARCH, f, w) for f, w in CASES]
                         + [("smollm-360m", False, 0), ("granite-20b", False, 0)]
                         + [("smollm-360m", True, 0), ("granite-20b", True, 0)]
                         + [("qwen2-moe-a2.7b", f, 0) for f in (False, True)]
                         + [("mixtral-8x22b", f, 16) for f in (False, True)])
def test_prefill_and_decode_match_jax(arch, use_flash, window):
    """tinyllama in every route; smollm (tied embeddings, hd 20, an odd
    number of heads) and granite (MQA) in both routes, the flash one against
    the JAX kernel in interpret mode; the MoE families (qwen2-moe: top-4 of 8 and
    shared experts; mixtral: top-2 of 4 under its window of 16) in both
    routes, decode dispatching the B new tokens together."""
    jcfg, tcfg = configs(use_flash, window, arch)
    jp = jax_params(jcfg)
    tp = from_jax(tcfg, jp, device="cpu")
    B, S, steps = 2, 16, 4
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab_size, size=(steps, B)).astype(np.int32)

    jm, tm = JaxModel(jcfg), Model(tcfg)
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, S + steps)
    tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)}, S + steps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(ts.caches.slot_pos.numpy(),
                                  np.asarray(js.caches.slot_pos))
    np.testing.assert_allclose(ts.caches.k.numpy(), np.asarray(js.caches.k),
                               atol=TOL, rtol=TOL)
    assert ts.pos == int(js.pos)
    for t in range(steps):      # teacher-forced: both fed the same tokens
        jl, js = jm.decode_step(jp, js, jnp.asarray(forced[t]))
        tl, ts = tm.decode_step(tp, ts, torch.from_numpy(forced[t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {t}")
    np.testing.assert_array_equal(ts.caches.slot_pos.numpy(),
                                  np.asarray(js.caches.slot_pos))


@pytest.mark.parametrize("use_flash", [False, True])
def test_serve_completions_match_jax(use_flash, tmp_path):
    jcfg, tcfg = configs(use_flash)
    kw = dict(n_requests=4, prompt_len=8, max_new=4, batch=2, seed=SEED)
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
    assert all(r["cat"] == "request" and r["args"]["n_tokens"] == 4 for r in rows)
    assert out["p50_s"] > 0 and out["p99_s"] >= out["p50_s"]


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x22b"])
def test_moe_serve_completions_match_jax(arch):
    """Greedy prefill + decode through ``serve``: the MoE families' tokens
    equal the JAX package's, token for token."""
    window = get_smoke_config(arch).sliding_window
    jcfg, tcfg = configs(False, window, arch)
    kw = dict(n_requests=4, prompt_len=8, max_new=4, batch=2, seed=SEED)
    ref = jax_serve(jcfg, **kw)
    out = serve(tcfg, device="cpu", params=from_jax(tcfg, jax_params(jcfg), device="cpu"), **kw)
    assert out["new_tokens"] == ref["new_tokens"] == 16
    assert [c["tokens"] for c in out["completions"]] == \
        [c["tokens"] for c in ref["completions"]]


def test_serve_default_init_runs_on_cpu():
    _, tcfg = configs()
    out = serve(tcfg, n_requests=3, prompt_len=8, max_new=3, batch=2,
                device="cpu")
    assert out["requests"] == 3 and out["new_tokens"] == 9
    assert all(len(c["tokens"]) == 3 for c in out["completions"])
    assert all(0 <= t < tcfg.vocab_size for c in out["completions"]
               for t in c["tokens"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip(dtype):
    jcfg = jax_smoke_config(ARCH).replace(dtype=getattr(jnp, dtype))
    tcfg = get_smoke_config(ARCH).replace(dtype=getattr(torch, dtype))
    jp = jax_params(jcfg)
    tp = from_jax(tcfg, jp, device="cpu")
    assert tp.layers[0].attn.q.shape == jp["layers"]["attn"]["q"].shape[1:]
    assert tp.layers[1].ln1.dtype == torch.float32      # norms stay fp32
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
    for (na, a), (nb, b) in zip(tp.state_dict().items(),
                                again.state_dict().items()):
        assert na == nb and torch.equal(a, b)


def test_tied_embeddings_and_unported_families_raise():
    """Tied embeddings leave no ``head``. The three families that raised
    before the MoE, encoder and VLM modes were ported now build, each with
    its own parts: MoE blocks in place of the MLP, no ``embed`` for the
    encoder fed frame embeddings, an ``embed`` for the VLM's text."""
    from repro_torch.configs import get_smoke_config as cfg_of
    cfg = cfg_of("smollm-360m").replace(dtype=torch.float32)
    m = Model(cfg)
    p = m.init(0, device="cpu")
    assert not hasattr(p, "head")
    logits, _ = m.prefill(p, {"tokens": torch.zeros((1, 4), dtype=torch.long)}, 6)
    assert logits.shape == (1, 256) and torch.isfinite(logits).all()
    built = {arch: Model(cfg_of(arch)).init(0, device="cpu")
             for arch in ("mixtral-8x22b", "hubert-xlarge", "llava-next-mistral-7b")}
    mix = built["mixtral-8x22b"].layers[0]
    assert not hasattr(mix, "mlp") and mix.moe.gate.shape == (4, 64, 128)
    assert mix.moe.router.dtype == torch.float32 and not hasattr(mix.moe, "shared")
    assert not hasattr(built["hubert-xlarge"], "embed")
    assert built["llava-next-mistral-7b"].embed.shape == (256, 64)
