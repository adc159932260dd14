"""The decode step replayed from a CUDA graph (``repro_torch.models.replay``),
which the ``ssm`` family (mamba2) and the ``moe_hybrid`` family
(granite-4.0-h-small) share. On the CPU every step runs as issued: the same
logits and caches, bit for bit, as the family's issued step, with no graph
registered and every count 0; a DTensor state (a faked world-1 mesh, in a
subprocess) is never captured. Marked ``cuda``: mamba2's replayed step
against the step as issued, bit for bit, over two prompts, without a host
sync, and prompts of two lengths at one batch captured once:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_replay.py``.
Granite's replayed step has its own ``cuda`` tests in
``tests/test_torch_granite_hybrid.py``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import Model, granite_hybrid, replay
from repro_torch.models import model as model_mod
from repro_torch.models.mamba2 import MambaCache

ROOT = Path(__file__).resolve().parents[1]

#: each family's step as issued, and its state's cache tensors
ISSUED = {"ssm": model_mod._ssm_issued_step, "moe_hybrid": granite_hybrid._step}


def caches(state) -> list:
    if hasattr(state, "caches"):
        return [*state.caches]
    return [*state.mamba, *state.attn]


def twin(state):
    """The state over copies of its caches."""
    if hasattr(state, "caches"):
        return state._replace(caches=MambaCache(*(t.clone() for t in state.caches)))
    return state._replace(mamba=MambaCache(*(t.clone() for t in state.mamba)),
                          attn=type(state.attn)(*(t.clone() for t in state.attn)))


def zero_counts():
    replay.counts.update(dict.fromkeys(replay.counts, 0))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "granite-4.0-h-small"])
def test_off_the_card_the_step_runs_as_issued(arch):
    """``Model.decode_step`` on the CPU is the family's issued step: the same
    logits and caches, bit for bit; nothing is registered or counted."""
    cfg = get_smoke_config(arch).replace(dtype=torch.float32)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(4))
    logits, state = model.prefill(params, {"tokens": toks}, 24)
    other = twin(state)
    zero_counts()
    nxt = logits.argmax(-1)
    for _ in range(4):
        a, state = model.decode_step(params, state, nxt)
        b, other = ISSUED[cfg.family](params, cfg, other, nxt)
        assert torch.equal(a, b) and state.pos == other.pos
        for x, y in zip(caches(state), caches(other)):
            assert torch.equal(x, y)
        nxt = a.argmax(-1)
    assert params not in replay._REPLAYS
    assert replay.counts == {"captures": 0, "replays": 0, "copies": 0}


# both families' decode states laid out on a faked (1, 1) mesh; the tokens a
# stand-in that claims to be on the card, so that only the DTensor rule can
# keep a step issued
DTENSOR_STATE = r"""
import json, types
import torch
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import mesh_context
from repro_torch.launch.dryrun import fake_mesh
from repro_torch.models import Model, replay

card = types.SimpleNamespace(is_cuda=True, shape=(2,), device=torch.device("cuda", 0))
layout = {"mamba2-2.7b": lambda s: [*s.caches],
          "granite-4.0-h-small": lambda s: [*s.mamba, *s.attn]}
out = {}
with mesh_context(fake_mesh((1, 1), ("data", "model"))):
    for arch, caches in layout.items():
        state = Model(get_smoke_config(arch)).init_decode_state(2, 24, device="cpu")
        t = caches(state)
        params = torch.nn.Linear(1, 1)
        steps = [replay.decode_step(lambda p, c, s, x: "issued", caches, None, params, None, state,
                                    card) for _ in range(3)]
        out[arch] = {"dtensor": all(isinstance(x, DTensor) for x in t),
                     "replayable": replay.replayable(card, t),
                     "replayable_local": replay.replayable(card, [x.to_local() for x in t]),
                     "steps": steps, "registered": params in replay._REPLAYS,
                     "counts": replay.counts}
print(json.dumps(out))
"""


def test_a_dtensor_state_is_never_captured():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    run = subprocess.run([sys.executable, "-c", DTENSOR_STATE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    for arch, got in out.items():
        assert got == {"dtensor": True, "replayable": False, "replayable_local": True,
                       "steps": ["issued"] * 3, "registered": False,
                       "counts": {"captures": 0, "replays": 0, "copies": 0}}, arch


def _card_model():
    cfg = get_smoke_config("mamba2-2.7b").replace(use_ssd_kernel=True)
    model = Model(cfg)
    return cfg, model, model.init(0, device="cuda")


@pytest.mark.cuda
def test_replayed_ssm_step_does_not_sync_the_host():
    """Neither the step as issued nor a replayed one waits for the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg, model, params = _card_model()
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda")
    logits, state = model.prefill(params, {"tokens": toks}, 20)
    nxt = logits.argmax(-1)
    logits, state = model.decode_step(params, state, nxt)      # as issued
    logits, state = model.decode_step(params, state, nxt)      # captured, then replayed
    other = twin(state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        issued, _ = model_mod._ssm_issued_step(params, cfg, other, nxt)
        logits, state = model.decode_step(params, state, nxt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert logits.shape == issued.shape == (2, 256) and state.pos == 19


@pytest.mark.cuda
def test_replayed_ssm_step_matches_the_issued_step():
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
        other = twin(state)
        nxt = logits.argmax(-1)
        for _ in range(6):
            a, state = model.decode_step(params, state, nxt)
            b, other = model_mod._ssm_issued_step(params, cfg, other, nxt)
            assert torch.equal(a, b) and state.pos == other.pos
            for x, y in zip(caches(state), caches(other)):
                assert torch.equal(x, y)
            nxt = a.argmax(-1)
        if wave == 0:
            stale = state
    with pytest.raises(RuntimeError, match="overwritten"):
        model.decode_step(params, stale, nxt)


@pytest.mark.cuda
def test_prompts_of_two_lengths_capture_once():
    """Prompts of two lengths at one batch, as serve_long sends them, leave
    caches of one shape: one capture, then only replays, each new prompt's
    state copied in once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg, model, params = _card_model()
    zero_counts()
    for length in (16, 32, 16):
        toks = torch.randint(0, cfg.vocab_size, (2, length), device="cuda")
        logits, state = model.prefill(params, {"tokens": toks}, length + 4)
        nxt = logits.argmax(-1)
        for _ in range(4):
            logits, state = model.decode_step(params, state, nxt)
            nxt = logits.argmax(-1)
    torch.cuda.synchronize()
    assert replay.counts == {"captures": 1, "replays": 11, "copies": 2}
    assert len(replay._REPLAYS[params]) == 1
