"""``optim.launch_calls`` on hand-built traces: the host's launch calls that
start inside the port's ``optim.adamw`` ranges, over the traced steps."""
import ast
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench.lib import harness
from bench.lib.trace import DeviceTrace

STEP = "bench.train_step:8x2048"
READ = harness.metric_reader("optim.launch_calls")


def trace(adamw=True):
    """Two steps; in AdamW's ranges (10-30 and 110-120) four launch calls of
    three kinds and one at the second range's end, outside them three."""
    kernels = [("k", 0, 100), ("k", 100, 200)]
    host = [("cudaLaunchKernel", 5, 6), ("cudaLaunchKernel", 12, 13),
            ("cudaLaunchKernelExC", 20, 21), ("cuLaunchKernel", 29, 31),
            ("aten::mul", 15, 16), ("cudaLaunchKernel", 40, 41),
            ("cudaLaunchKernel", 111, 112), ("cudaLaunchKernel", 120, 121),
            ("cudaMemcpyAsync", 115, 116), ("cudaLaunchKernel", 150, 151)]
    if adamw:
        host += [("optim.adamw", 10, 30), ("optim.adamw", 110, 120)]
    return DeviceTrace(kernels, [(STEP, 0, 100), (STEP, 100, 200)], host)


def test_counts_the_launch_calls_inside_adamw_per_step():
    assert READ(SimpleNamespace(trace=trace())) == pytest.approx(4 / 2)


@pytest.mark.parametrize("t", [None, trace(adamw=False),
                               DeviceTrace([], [(STEP, 0, 100)], [("optim.adamw", 0, 9)])],
                         ids=["untraced", "no-adamw-ranges", "no-kernels"])
def test_none_without_its_ranges(t):
    assert READ(SimpleNamespace(trace=t)) is None


def test_the_launch_calls_are_the_probes():
    """The reader names the same launch calls as ``bench/spans_probe.py``
    (read from its source: importing it sets the process's environment)."""
    tree = ast.parse((Path(harness.BENCH) / "spans_probe.py").read_text())
    probe = next(ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
                 and any(getattr(t, "id", None) == "LAUNCH_CALLS" for t in n.targets))
    src = ast.parse((Path(harness.BENCH) / "metrics" / "optim.launch_calls.py").read_text())
    mine = next(ast.literal_eval(n.value) for n in src.body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "LAUNCH_CALLS" for t in n.targets))
    assert mine == probe
