"""Whole tiny runs on the CPU, the harness's look for a card left out, with
the timed path broken underneath (a step that returns its state
unchanged, half of the batch left out with the mean taken over the rest,
a served token altered where it is produced): they come out not correct
by the cells' own limits, and a number that fails reads ten times or more
what the sound tiny run reads (the limits are set at the cells' sizes;
at this size a sound run's own readings are larger). The exchange between
chips is no fault these one-chip cells can have."""
import pytest
import torch

from bench.lib import harness
from bench.tests.tiny import cpu_run

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def correct(run):
    limits = {k: v for k, v in run.c["limits"].items() if k in run.readings}
    ok, checks = harness.judge(run.readings, limits)
    return ok and run.attempted > 0 and run.failed == 0, checks


SOUND = {}


def sound(cell):
    if cell not in SOUND:
        run = cpu_run(cell)
        assert run.attempted > 0 and run.failed == 0
        SOUND[cell] = run.readings
    return SOUND[cell]


def assert_caught(cell, run):
    ok, checks = correct(run)
    assert not ok, checks
    base = sound(cell)
    failing = [k for k, c in checks.items() if c["value"] is None or c["value"] > c["limit"]]
    assert any(run.readings[k] >= 10 * base[k] for k in failing), (checks, base)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_tiny_runs_pass_the_exact_checks(cell):
    """What a limit of 0 compares (the checkpoint's bytes) holds at any size;
    the serving gap at this size is 0 (tiny logits leave greedy picks alone)."""
    base = sound(cell)
    _, c, _ = harness.cell_files(cell)
    for k, limit in c["limits"].items():
        if k in base and (limit == 0 or k == "token_gap"):
            assert base[k] <= limit, (k, base[k])


def _unchanged(orig):
    def step(model, params, opt_state, batch, opt):
        dev = next(params.parameters()).device
        loss = model.loss(params, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        return opt_state, loss.detach(), torch.zeros(())
    return step


def _half_batch(orig):
    def step(model, params, opt_state, batch, opt):
        return orig(model, params, opt_state,
                    {k: v[:v.shape[0] // 2] for k, v in batch.items()}, opt)
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", [c for c in CELLS if ".train" in c])
def test_train_faults_are_not_correct(monkeypatch, cell, fault):
    from repro_torch.launch import train as train_mod
    sound(cell)
    monkeypatch.setattr(train_mod, "train_step", fault(train_mod.train_step))
    assert_caught(cell, cpu_run(cell))


@pytest.mark.parametrize("cell", [c for c in CELLS if ".serve" in c])
def test_altered_token_is_not_correct(monkeypatch, cell):
    from repro_torch.models import Model
    sound(cell)
    orig = Model.decode_step

    def decode_step(self, params, state, tokens):
        logits, state = orig(self, params, state, tokens)
        logits = logits.clone()               # every request's next token altered
        rows = torch.arange(logits.shape[0])
        alt = (logits.argmax(-1) + 1) % logits.shape[-1]
        logits[rows, alt] = logits.max(-1).values + 1.0
        return logits, state
    monkeypatch.setattr(Model, "decode_step", decode_step)
    run = cpu_run(cell)
    ok, checks = correct(run)
    assert not ok, checks
