"""Measure real storage tiers, fit the congestion model, re-simulate, on
the port's runtime (``repro_torch.core``, ``repro_torch.obs``).

The simulator's ``StorageDevice`` parameters (bandwidth, per-stream cap,
congestion ramp) are normally taken from a spec sheet. This example
*measures* them instead: it writes concurrency waves of real files
(+fsync) into two temp-directory "tiers" under ``RealBackend``, fits
each tier's parameters from the collected telemetry samples
(``repro_torch.obs.telemetry.fit_tiers``), prints fitted-vs-configured, then
feeds the fitted config into a ``SimBackend`` run of the same DAG — the
calibrated simulator now predicts what this machine's storage actually
delivers (see docs/observability.md). The I/O runs on the host;
``--device`` is checked as every entry point of the port checks it (CUDA
unless ``--device cpu``).

  PYTHONPATH=src python examples/torch/measure_real_tiers.py [--device cpu]
"""
import argparse
import os
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.core import (Cluster, IORuntime, RealBackend, SimBackend,
                              StorageDevice, WorkerNode, io, task)
from repro_torch.device import resolve_device
from repro_torch.obs.telemetry import apply_tier_config, fit_tiers

WAVES = (1, 2, 4)       # concurrent writers per tier, per wave
MB_PER_WRITE = 4.0


@io
@task(returns=1)
def put(dirpath, name, mb):
    """Write ~mb MB (+fsync) when a real directory is given; under the
    simulator the body never runs and ``io_mb=`` models the transfer."""
    if not dirpath:
        return name
    path = os.path.join(dirpath, name)
    with open(path, "wb") as f:
        f.write(b"\0" * int(mb * (1 << 20)))
        f.flush()
        os.fsync(f.fileno())
    return name


def make_cluster():
    ssd = StorageDevice(name="ssd0", tier="ssd")                 # 450 / 8
    fs = StorageDevice(name="fs0", bandwidth=300.0,
                       per_stream_cap=4.0, tier="fs")
    return Cluster(workers=[WorkerNode(name="w0", cpus=2,
                                       io_executors=16,
                                       tiers=[ssd, fs])])


def run_waves(rt, tier_dirs):
    n = 0
    for k in WAVES:
        wave = []
        for tier in ("ssd", "fs"):
            for _ in range(k):
                wave.append(put(tier_dirs.get(tier, ""),
                                f"{tier}-{n}.bin", MB_PER_WRITE,
                                io_mb=MB_PER_WRITE, storage_tier=tier))
                n += 1
        rt.wait_on(*wave)
    rt.barrier(final=True)


def main():
    base = tempfile.mkdtemp(prefix="measure_tiers_")
    try:
        cluster = make_cluster()
        tier_dirs = {t: os.path.join(base, t)
                     for t in cluster.tier_names()}
        for d in tier_dirs.values():
            os.makedirs(d, exist_ok=True)
        rt = IORuntime(cluster, backend=RealBackend(tier_dirs=tier_dirs))
        with rt:
            run_waves(rt, tier_dirs)

        # guarded: under `python -m repro_torch.lint` the runtime swaps in the
        # capture backend (no telemetry hub, no real I/O) — skip the fit
        hub = getattr(rt.backend, "telemetry", None)
        fitted = fit_tiers(hub) if hub is not None else {}
        if not fitted:
            print("no measured telemetry (capture/lint mode?) — "
                  "skipping the fit")
            return
        configured = {d.tier: d for d in cluster.devices}
        for tier, cfg in sorted(fitted.items()):
            dev = configured.get(tier)
            print(f"{tier:<4} configured {dev.bandwidth:7.0f} MB/s "
                  f"(per-stream {dev.per_stream_cap:5.1f}) -> measured "
                  f"{cfg['bandwidth']:7.0f} MB/s "
                  f"(per-stream {cfg['per_stream_cap']:6.1f}, "
                  f"ramp alpha {cfg['congestion_alpha']:.3f}, "
                  f"n={cfg['n_samples']})")

        sim_cluster = make_cluster()
        n_updated = apply_tier_config(sim_cluster, fitted)
        rt2 = IORuntime(sim_cluster, backend=SimBackend())
        with rt2:
            run_waves(rt2, {})
        print(f"calibrated sim ({n_updated} devices updated): "
              f"predicted makespan {rt2.stats()['makespan']:.3f}s vs "
              f"measured {rt.stats()['makespan']:.3f}s")
    finally:
        shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    resolve_device(ap.parse_args().device)
    main()
