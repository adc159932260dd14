"""The reader of K1's backward share of its roofline on hand-built traces:
its bound against a hand count, None where no backward kernel ran, and the
share of the kernels' device time in the traced steps."""
from types import SimpleNamespace

import pytest

from bench.lib import harness
from bench.lib.trace import DeviceTrace

STEP = "bench.train_step:8x2048"
C = {"hidden_size": 960, "num_attention_heads": 15, "num_key_value_heads": 5,
     "num_hidden_layers": 32, "dtype": "bfloat16"}
TR = {"batch": 8, "seq": 2048}
READ = harness.metric_reader("flash_attention_bwd_roofline")
BWD_BOUND = READ.__globals__["bwd_bound"]


def run_of(kernels, steps=2):
    """Two traced steps of 1000 us each."""
    marks = [(STEP, 1000.0 * i, 1000.0 * (i + 1)) for i in range(steps)]
    return SimpleNamespace(trace=DeviceTrace(kernels, marks, []), c=C, tr=TR)


def test_bound_at_the_train_shape():
    # five products of 2 * 64 FLOPs over 2048 * 2049 / 2 pairs, 8 x 15 heads, at
    # 989 TFLOP/s: 0.163 ms, above the 0.12 ms of q, k, v, o, dO, dq, dk, dv
    t = BWD_BOUND(8, 2048, 15, 5, 64, "bfloat16")
    assert t == pytest.approx(10 * 64 * 2098176 * 120 / 989e12, rel=1e-12)
    assert t * 1e3 == pytest.approx(0.1629, abs=1e-4)
    assert 8 * 2048 * (4 * 15 + 4 * 5) * 64 * 2 / 3.35e12 < t


def test_none_without_a_backward_kernel():
    kernels = [("flash_fwd_sm90_kernel", 10, 20), ("softmax_warp_backward", 30, 40)]
    assert READ(run_of(kernels)) is None
    assert READ(SimpleNamespace(trace=None, c=C, tr=TR)) is None


def test_share_of_the_kernels_time_in_the_traced_steps():
    # 2 steps x 32 layers of calls, each call's two kernels 10 + 15 us of
    # device time; a backward kernel outside the steps is not counted
    kernels = []
    for i in range(64):
        s = 30.0 * i + 1
        kernels += [("flash_bwd_dq_sm90_kernel", s, s + 10), ("flash_bwd_dkdv_sm90_kernel",
                                                              s + 10, s + 25)]
    kernels.append(("flash_bwd_dq_sm90_kernel", 2500.0, 2600.0))
    t = BWD_BOUND(8, 2048, 15, 5, 64, "bfloat16")
    assert READ(run_of(kernels)) == pytest.approx(100.0 * t * 64 / (64 * 25e-6), rel=1e-9)
