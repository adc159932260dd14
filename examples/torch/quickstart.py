"""Quickstart: the paper's programming model in 30 lines, on the port's
runtime (``repro_torch.core``, a copy of ``repro.core``).

An I/O-intensive app (compute -> checkpoint per block) run three ways:
baseline (checkpoints are compute tasks), I/O tasks without constraints
(congestion!), and auto-tuned storage-bandwidth constraints — reproducing
the paper's core result on the calibrated MareNostrum-4 storage model. The
runtime and its simulator run on the host; ``--device`` is checked as every
entry point of the port checks it (CUDA unless ``--device cpu``).

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.core import (Cluster, IORuntime, SimBackend, constraint,
                              expected_task_time, io, task)
from repro_torch.device import resolve_device


def run(mode):
    cluster = Cluster.make(n_workers=12, io_executors=225)
    dev = cluster.workers[0].storage

    @task(returns=1)
    def compute_block(i):
        ...

    if mode == "baseline":
        @task()
        def checkpoint(block, i): ...
    elif mode == "non-constrained":
        @io
        @task()
        def checkpoint(block, i): ...
    else:
        @constraint(storageBW="auto")   # the paper's contribution
        @io
        @task()
        def checkpoint(block, i): ...

    with IORuntime(cluster, backend=SimBackend()) as rt:
        for i in range(2304):
            b = compute_block(i, duration=200.0)
            if mode == "baseline":
                checkpoint(b, i, duration=expected_task_time(dev, 48, 290))
            else:
                checkpoint(b, i, io_mb=290.0)
        rt.barrier(final=True)
        diags = rt.lint()           # static I/O-plan analysis (docs/lint.md)
        assert not diags, [str(d) for d in diags]
        return rt.stats()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    resolve_device(ap.parse_args().device)
    base = run("baseline")
    for mode in ("baseline", "non-constrained", "auto"):
        st = run(mode)
        # makespan is 0.0 under capture mode (python -m repro_torch.lint):
        # guard the result post-processing so the plan records end to end
        rel = st["makespan"] / base["makespan"] if base["makespan"] else 0.0
        line = f"{mode:16} total={st['makespan']:8.1f}s rel={rel:.2f}"
        if mode == "auto":
            t = st["tuners"].get("checkpoint")
            if t:
                line += (f"  learning epochs={[c for c, _ in t['history']]} "
                         f"-> constraint {t['modal_choice']}")
        print(line)
