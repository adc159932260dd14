"""Kernel launches the host issues in AdamW a traced train step: the host's
launch calls (``cudaLaunchKernel`` and its kin, each putting one kernel on
the device's queue) that start inside an ``optim.adamw`` range of the port
(``repro_torch.spans``), over the number of traced steps."""
from bench.lib.program_spans import inside, ranges

#: the host's calls that put one kernel on the device's queue, as
#: ``bench/spans_probe.py`` names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    steps, opt = t.marks_named("bench.train_step"), ranges(t, "optim.adamw")
    if not steps or not opt:
        return None
    calls = sum(1 for name, s, _ in t.host_ops if name in LAUNCH_CALLS and inside(opt, s))
    return calls / len(steps)
