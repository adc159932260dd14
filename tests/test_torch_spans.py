"""The port's spans (repro_torch.spans): the helper's two sinks (the ambient
runtime's recorder on a real clock, the torch profiler's host ranges), the
clock anchor that lays one on the other, and the span sites in the
checkpoint manager, AdamW and the decode step."""
import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core import (Cluster, IORuntime, RealBackend, SimBackend, StorageDevice,
                              WorkerNode)
from repro_torch.models import Model
from repro_torch.obs import EVENT_SCHEMA
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.spans import span


def cluster():
    dev = StorageDevice(name="fs", bandwidth=2000, per_stream_cap=500)
    return Cluster(workers=[WorkerNode(name="w0", cpus=2, io_executors=4, storage=dev)])


def spans_of(rt, name=None):
    return [e for e in rt.trace().events if e["type"] == "span"
            and (name is None or e["name"] == name)]


def host_ranges(prof, name):
    """[(start_ns, duration_ns)] of the profiler's host events named ``name``."""
    return [(e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
            if e.name() == name and e.device_type() == torch.autograd.DeviceType.CPU]


def test_neither_sink_records_nothing():
    with span("ckpt.save", step=3) as sp:
        sp["saved"] = True
    assert sp == {"step": 3, "saved": True}
    with IORuntime(cluster(), backend=RealBackend()) as rt:
        with span("optim.adamw"):
            pass
    assert rt.trace() is None


def test_a_raising_body_still_closes_its_span():
    with IORuntime(cluster(), backend=RealBackend(), trace=True) as rt:
        with pytest.raises(ValueError), span("ckpt.save"):
            raise ValueError("in the body")
        with span("ckpt.wait"):
            pass
    (save,), (wait,) = spans_of(rt, "ckpt.save"), spans_of(rt, "ckpt.wait")
    assert wait["args"]["parent"] is None and save["args"]["parent"] is None


def test_recorder_events_follow_the_schema_and_nest():
    with IORuntime(cluster(), backend=RealBackend(), trace=True) as rt:
        with span("ckpt.save", step=1):
            with span("ckpt.to_host") as sp:
                sp["bytes"] = 12
        with span("optim.adamw"):
            pass
    for e in rt.trace().events:
        for field, types in EVENT_SCHEMA[e["type"]].items():
            assert isinstance(e[field], types), (e, field)
    clock, *rest = spans_of(rt)
    assert clock["name"] == "clock" and clock["cat"] == "clock" and clock["dur"] == 0
    assert set(clock["args"]) == {"time_ns", "monotonic_ns"}
    by = {e["name"]: e for e in rest}
    assert set(by) == {"ckpt.save", "ckpt.to_host", "optim.adamw"}
    save, copy, opt = by["ckpt.save"], by["ckpt.to_host"], by["optim.adamw"]
    assert (save["cat"], copy["cat"], opt["cat"]) == ("ckpt", "ckpt", "optim")
    assert save["args"]["parent"] is None and opt["args"]["parent"] is None
    assert copy["args"]["parent"] == save["args"]["id"] != opt["args"]["id"]
    assert copy["args"]["bytes"] == 12 and save["args"]["step"] == 1
    assert save["t"] <= copy["t"] and copy["t"] + copy["dur"] <= save["t"] + save["dur"]
    json.dumps(rt.trace().events)     # exportable as they are


def test_one_anchor_a_recorder():
    with IORuntime(cluster(), backend=RealBackend(), trace=True) as rt:
        for _ in range(3):
            with span("model.decode"):
                pass
    assert [e["name"] for e in spans_of(rt)] == ["clock"] + ["model.decode"] * 3


def test_a_simulated_runtime_gets_no_spans():
    with IORuntime(cluster(), backend=SimBackend(), trace=True) as rt:
        with span("ckpt.save"):
            with span("ckpt.to_host"):
                pass
    assert rt.trace() is not None and spans_of(rt) == []


def test_profiler_range_is_a_host_op_not_an_annotation(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("optim.adamw"):
            torch.ones(4).add_(1)
    assert len(host_ranges(prof, "optim.adamw")) == 1
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    cats = [e.get("cat") for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]
            if e.get("name") == "optim.adamw"]
    assert cats == ["cpu_op"]


def test_clock_anchor_lays_a_recorder_span_on_the_profiler():
    with IORuntime(cluster(), backend=RealBackend(), trace=True) as rt:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                with span("model.decode"):
                    torch.ones(64).mul_(2)
    clock, *rest = spans_of(rt)
    (start_ns, _), *_ = host_ranges(prof, "model.decode")
    mapped = clock["args"]["time_ns"] + (rest[0]["t"] - clock["t"]) * 1e9
    assert abs(mapped - start_ns) < 1e6
    assert len(host_ranges(prof, "model.decode")) == 3


# --------------------------------------------------------------- the sites

def test_traced_save_nests_the_host_copy(tmp_path):
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": torch.ones((4,), dtype=torch.bfloat16),
            "opt": {"count": torch.zeros((), dtype=torch.int32), "m": torch.full((2, 2), 0.5)}}
    mgr = CheckpointManager(tmp_path, n_shards=2)
    with IORuntime(cluster(), backend=RealBackend(), trace=True) as rt:
        assert mgr.save(7, tree)
        mgr.wait()
    save, copy, wait = (spans_of(rt, n) for n in ("ckpt.save", "ckpt.to_host", "ckpt.wait"))
    assert len(save) == len(copy) == len(wait) == 1
    save, copy, wait = save[0], copy[0], wait[0]
    assert copy["args"]["parent"] == save["args"]["id"]
    assert copy["args"]["bytes"] == 12 * 4 + 4 * 2 + 4 + 4 * 4
    assert save["args"]["step"] == 7 and save["args"]["saved"] is True
    assert wait["args"]["step"] == 7 and wait["args"]["parent"] is None
    assert copy["dur"] <= save["dur"] <= wait["t"] - save["t"]


def test_untraced_save_is_unchanged(tmp_path):
    mgr = CheckpointManager(tmp_path, n_shards=2)
    assert mgr.save(2, {"w": torch.ones(3)}, sync=True)
    assert mgr.steps() == [2]


def test_adamw_one_range_a_call():
    params = {"w": torch.randn(4, 3), "b": torch.zeros(3)}
    state = adamw_init(params)
    cfg = AdamWConfig(warmup_steps=1, total_steps=10)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            grads = {k: torch.ones_like(p) for k, p in params.items()}
            params, state, _ = adamw_update(grads, params, state, cfg)
    assert len(host_ranges(prof, "optim.adamw")) == 3
    assert int(state.count) == 3


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "smollm-360m"])
def test_decode_one_range_a_step(arch):
    cfg = get_smoke_config(arch).replace(dtype=torch.float32, use_flash=False,
                                         use_ssd_kernel=False)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 16))
    logits, state = model.prefill(params, {"tokens": prompt}, 24)
    nxt = logits[:, :cfg.vocab_size].argmax(-1)
    steps = 4
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            logits, state = model.decode_step(params, state, nxt)
            nxt = logits[:, :cfg.vocab_size].argmax(-1)
    ranges = host_ranges(prof, "model.decode")
    assert len(ranges) == steps
    assert not host_ranges(prof, "optim.adamw")


def test_moe_spans_once_a_layer_a_call():
    """``moe.route`` and ``moe.experts`` of the dropless dispatch: each once
    per MoE layer per prefill or decode step, in that order, with their
    attrs (Python ints) on the recorder and as host ranges."""
    cfg = get_smoke_config("granite-4.0-h-small").replace(dtype=torch.float32)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 16))
    L, k, E = cfg.n_layers, cfg.n_experts_per_tok, cfg.n_experts
    with IORuntime(cluster(), backend=RealBackend(), trace=True) as rt:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            logits, state = model.prefill(params, {"tokens": prompt}, 20)
            model.decode_step(params, state, logits.argmax(-1))
    moe = [e for e in spans_of(rt) if e["cat"] == "moe"]
    assert [e["name"] for e in moe] == ["moe.route", "moe.experts"] * (2 * L)
    for call, T in ((moe[:2 * L], 32), (moe[2 * L:], 2)):
        route, experts = call[0::2], call[1::2]
        assert all(e["args"]["tokens"] == T and e["args"]["assignments"] == T * k
                   for e in route)
        assert all(e["args"]["tokens"] == T and e["args"]["experts"] == E for e in experts)
    assert len(host_ranges(prof, "moe.route")) == len(host_ranges(prof, "moe.experts")) == 2 * L


@pytest.mark.parametrize("io_aware", [True, False], ids=["async", "sync"])
def test_chip_smoke_reads_the_save_from_the_spans(tmp_path, monkeypatch, io_aware):
    """``chip_smoke.train_run`` itself, on the CPU (its ``torch.cuda`` calls
    no-ops, ``train`` sent to the CPU): one save at step 3 read from the
    ``ckpt.*`` spans, its host copy inside its hold, the final ``wait``
    counted for the async save only, save-to-commit and the overlap from
    the committed manifest; forced tracing off again after the run, and the
    run's runtime taken back out of ``obs.RUNS``."""
    import chip_smoke
    from repro_torch import obs
    from repro_torch.launch import train as train_mod
    monkeypatch.setattr(obs, "FORCE", False)
    monkeypatch.setattr(obs, "RUNS", [])
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    monkeypatch.setattr(chip_smoke, "TRAIN", dict(batch=2, seq=16))
    no_cuda = SimpleNamespace(cuda=SimpleNamespace(
        empty_cache=lambda: None, reset_peak_memory_stats=lambda: None,
        synchronize=lambda: None, max_memory_allocated=lambda: 0))
    on_cpu = SimpleNamespace(train=lambda cfg, device, **kw: train_mod.train(cfg, device="cpu",
                                                                             **kw))
    cfg = get_smoke_config("smollm-360m").replace(dtype=torch.float32, use_flash=False)
    ck = tmp_path / "ck"
    out, launches, num = chip_smoke.train_run(
        no_cuda, on_cpu, cfg, [], "run", steps=4, ckpt_dir=str(ck), ckpt_every=4,
        io_aware=io_aware, resume=False)
    assert out["steps_run"] == num["steps_run"] == 4 and launches == {}
    assert obs.FORCE is False and obs.RUNS == []
    (sv,) = num["saves"]
    assert sv["step"] == 3 and sv["saved"] is True
    assert 0 < sv["host_copy_s"] <= sv["save_call_s"]
    assert (sv["wait_s"] > 0) == io_aware
    manifest = json.loads((ck / "step_00000003" / "MANIFEST.json").read_text())
    assert sv["manifest_save_seconds"] == manifest["save_seconds"]
    if io_aware:
        assert sv["save_to_commit_s"] == pytest.approx(sv["save_call_s"]
                                                       + manifest["save_seconds"])
        assert sv["overlap"] == pytest.approx(
            1 - (sv["save_call_s"] + sv["wait_s"]) / sv["save_to_commit_s"])
    else:
        assert sv["save_to_commit_s"] == sv["save_call_s"] and sv["overlap"] == 0.0
