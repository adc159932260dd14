"""Kernel launches the host issues in the MoE layers of a traced decode
step: the host's launch calls (``cudaLaunchKernel`` and its kin, each
putting one kernel on the device's queue) that start inside a ``moe.route``
or ``moe.experts`` range of the port (``repro_torch.spans``) and inside a
``bench.decode`` mark, over the number of traced decode steps. A decode
step replayed from a CUDA graph runs no Python and issues none: 0."""
from bench.lib.program_spans import inside, ranges

#: the host's calls that put one kernel on the device's queue, as
#: ``bench/spans_probe.py`` names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    steps = t.marks_named("bench.decode")
    moe = sorted(ranges(t, "moe.route") + ranges(t, "moe.experts"))
    if not steps or not moe:
        return None
    marks = [(s, e) for _, s, e in steps]
    calls = sum(1 for name, s, _ in t.host_ops
                if name in LAUNCH_CALLS and inside(moe, s) and inside(marks, s))
    return calls / len(steps)
