"""The readers of the port's own spans (``bench/lib/program_spans.py``,
``optim.idle_ms``, ``decode.issue_share``) on hand-built traces with known
gaps and ranges, and what tiny traced CPU runs of the cells hand them."""
from types import SimpleNamespace

import pytest

from bench.lib import harness
from bench.lib.program_spans import idle_gaps, inside, ranges
from bench.lib.trace import DeviceTrace
from bench.tests.tiny import tiny_cell

STEP, DECODE = "bench.train_step:8x2048", "bench.decode:32"


def train_trace(adamw=True):
    """Two steps of 100 us; idle 40-45, 60-70, 150-152 and 190-200, of which
    the ones opening at 60 and 150 open inside AdamW."""
    kernels = [("k", 0, 40), ("k", 45, 60), ("k", 70, 100), ("k", 100, 150),
               ("k", 152, 190), ("k", 20, 30)]
    host = [("aten::mul", 38, 41)]
    if adamw:
        host += [("optim.adamw", 55, 75), ("optim.adamw", 149, 160)]
    return DeviceTrace(kernels, [(STEP, 0, 100), (STEP, 100, 200)], host)


def read(name, trace):
    return harness.metric_reader(name)(SimpleNamespace(trace=trace))


def test_idle_gaps_and_inside():
    t = train_trace()
    assert idle_gaps(t) == [(40, 45), (60, 70), (150, 152), (190, 200)]
    opt = ranges(t, "optim.adamw")
    assert opt == [(55, 75), (149, 160)]
    assert [inside(opt, g0) for g0, _ in idle_gaps(t)] == [False, True, True, False]
    assert not inside(opt, 75) and not inside([], 10)


def test_optim_idle_ms():
    assert read("optim.idle_ms", train_trace()) == pytest.approx((10 + 2) / 1e3 / 2)


@pytest.mark.parametrize("trace", [None, train_trace(adamw=False),
                                   DeviceTrace([], [(STEP, 0, 100)], [("optim.adamw", 0, 9)])],
                         ids=["untraced", "no-adamw-ranges", "no-kernels"])
def test_optim_idle_ms_none_without_its_ranges(trace):
    assert read("optim.idle_ms", trace) is None


def test_decode_issue_share():
    marks = [(DECODE, 0, 100), (DECODE, 100, 200), (DECODE, 200, 300)]
    host = [("model.decode", 5, 95), ("model.decode", 101, 181), ("model.decode", 210, 280),
            ("model.decode", 400, 500), ("aten::argmax", 96, 99)]
    assert read("decode.issue_share", DeviceTrace([], marks, host)) == pytest.approx(80.0)
    assert read("decode.issue_share", DeviceTrace([], marks, host[-1:])) is None
    assert read("decode.issue_share", None) is None


def test_traced_cpu_train_ckpt_run_hands_over_the_spans(monkeypatch):
    """The port's AdamW ranges in the traced region, and its save's host
    copy (in the runtime's recorder, reached through forced tracing) inside
    the benchmark's own span of the save."""
    from repro_torch import obs
    monkeypatch.setattr(obs, "FORCE", True)
    monkeypatch.setattr(obs, "RUNS", [])
    c, tr = tiny_cell("smollm-360m.train_ckpt")
    run = harness.Run("smollm-360m.train_ckpt", c, tr, 2**31 + 7, 1.0, True, "cpu")
    harness.execute(run)
    assert len(ranges(run.trace, "optim.adamw")) == tr["trace_steps"]
    assert read("optim.idle_ms", run.trace) is None        # no device on the CPU
    (_, rt), = obs.RUNS
    spans = [e for e in rt.trace().events if e["type"] == "span"]
    (save,) = [e for e in spans if e["name"] == "ckpt.save"]
    (copy,) = [e for e in spans if e["name"] == "ckpt.to_host"]
    hold = harness.metric_reader("ckpt.hold_s")(run)
    assert copy["args"]["parent"] == save["args"]["id"]
    assert 0 < copy["dur"] <= save["dur"] <= hold


def test_traced_cpu_serve_decode_run_reads_an_issue_share():
    c, tr = tiny_cell("mamba2-2.7b.serve_decode")
    run = harness.Run("mamba2-2.7b.serve_decode", c, tr, 2**31 + 7, 1.0, True, "cpu")
    harness.execute(run)
    n = len(run.trace.marks_named("bench.decode"))
    assert n > 0 and len(ranges(run.trace, "model.decode")) == n
    assert 0 < harness.metric_reader("decode.issue_share")(run) < 100


def test_probe_counts_launch_calls_and_the_tail():
    """``bench/spans_probe.py`` on two decode steps: kernels by device start
    against the host's launch calls, the calls' share of ``model.decode``,
    and the tail after it."""
    from bench import spans_probe
    marks = [(DECODE, 0, 100), (DECODE, 100, 200)]
    # step 1's last kernel starts (by the device's clock) after its mark
    kernels = [("k", 10, 12), ("k", 20, 22), ("Memcpy DtoH", 95, 96), ("k", 101, 103),
               ("k", 130, 140), ("k", 150, 160)]
    host = [("model.decode", 5, 85), ("cudaLaunchKernel", 8, 10), ("cudaLaunchKernel", 18, 20),
            ("cudaLaunchKernel", 30, 34), ("cudaMemcpyAsync", 90, 94),
            ("model.decode", 110, 190), ("cuLaunchKernelEx", 120, 121),
            ("cudaLaunchKernel", 125, 127)]
    d = spans_probe.decode_summary(DeviceTrace(kernels, marks, host))
    assert d["kernels_by_device_start"] == [2, 3] and d["launch_calls"] == [3, 2]
    assert d["kernels_total"] == d["launch_calls_total"] == 5
    assert d["launch_share_of_decode_pct"] == pytest.approx(100 * (2 + 2 + 4 + 1 + 2) / 160)
    assert d["longest_launch_us"] == 4
    assert d["tail_ms_median"] == pytest.approx(12.5 / 1e3)
    assert d["tail_ms_max"] == pytest.approx(15 / 1e3)
    assert spans_probe.decode_summary(train_trace()) is None


def test_probe_reads_a_traced_cpu_train_ckpt_run(monkeypatch):
    from bench import spans_probe
    from repro_torch import obs
    monkeypatch.setattr(obs, "FORCE", True)
    monkeypatch.setattr(obs, "RUNS", [])
    c, tr = tiny_cell("smollm-360m.train_ckpt")
    run = harness.Run("smollm-360m.train_ckpt", c, tr, 2**31 + 9, 1.0, True, "cpu")
    harness.execute(run)
    s = spans_probe.summary(run, [e for _, rt in obs.RUNS for e in rt.trace().events])
    by = s["recorder"]["by_name"]
    assert by["ckpt.save"]["count"] == by["ckpt.to_host"]["count"] == 1
    assert by["optim.adamw"]["count"] >= tr["trace_steps"]
    assert [e["name"] for e in s["recorder"]["ckpt"]][:2] == ["ckpt.save", "ckpt.to_host"]
    assert s["recorder"]["ckpt"][1]["bytes"] > 0
    assert s["device_events_named_as_spans"] == 0 and s["adamw_host_ms"] > 0
    assert s["decode"] is None
