"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``):

- ``--list`` prints what the reference's prints, line for line;
- on ``tests/test_roofline.py``'s probe config and cells (unrolled, one
  device), the port's ``flops`` is within that file's bounds of XLA's
  ``cost_analysis`` flops of the reference's step (25% train, 30% prefill);
- the tinyllama, mamba2, zamba2 and qwen2-moe smoke configs' train, prefill
  and decode cells at batch 8 x 64 tokens on a faked (4, 2) mesh run, and
  the parameters' and optimizer state's bytes on rank 0 equal the sum of the
  reference's shard bytes (its ``build_cell`` on 8 faked XLA devices,
  ``Auto`` axes) exactly;
- the work is split, not repeated: the per-device flops of tinyllama's
  sharded cells times the device count stay within 30% of the unsharded
  step's (smoke train and prefill on (4, 2) and (2, 4), full-width
  ``train_4k`` on 16x16; only the K/V projections repeat where the KV
  heads cannot split);
- the meter: the traffic model on hand-computed collectives, the flops of
  local shards (and that ``FlopCounterMode`` entered outside DTensor counts
  the global shapes), and the peak of live bytes;
- full-width tinyllama-1.1b ``train_4k``, ``prefill_32k`` and
  ``decode_32k`` on the faked 16x16 mesh give ``status: ok`` (the sharded
  backward where the ``model`` axis exceeds the KV heads, and the sharded
  prefill and decode with a DTensor decode state, at production size).

The faked process group is process-wide, so every port run is a process of
its own; all of them run at once, beside the JAX ones.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from repro.compat import cost_analysis_dict
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import Model as JaxModel
from repro.optim import AdamWConfig, adamw_init, adamw_update

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 600
# tests/test_roofline.py's probe config and cells
PROBE = dict(name="probe", family="dense", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
             d_ff=256, vocab_size=512, remat=True, unroll_layers=True)
PROBE_CELLS = {"train": (4, 128, 0.25), "prefill": (4, 128, 0.30)}
SMOKE_ARCHS = ["tinyllama-1.1b", "mamba2-2.7b", "zamba2-1.2b", "qwen2-moe-a2.7b"]
SMOKE_KINDS = ["train", "prefill", "decode"]
SMOKE_BATCH, SMOKE_SEQ = 8, 64
# the sharded work against the unsharded: sum over devices / one device
SPLIT_RTOL = 0.30


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


# the probe cells and tinyllama's unsharded cells on a (1, 1) mesh, tinyllama's
# smoke cells on (2, 4), and the smoke cells on (4, 2)
PORT_CELLS = r"""
import json, sys
import torch
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch.dryrun import fake_mesh, trace_cell
probe, probe_cells, archs, kinds, B, S = json.loads(sys.argv[2])
tiny = get_smoke_config("tinyllama-1.1b")
out = {}
mesh = fake_mesh((1, 1), ("data", "model"))
for kind, (b, s, _) in probe_cells.items():
    out[f"probe/{kind}"] = trace_cell(ModelConfig(**probe), ShapeCell(kind, s, b, kind), mesh)
for kind in ("train", "prefill"):
    out[f"1x1/{kind}"] = trace_cell(tiny, ShapeCell(kind, S, B, kind), mesh)
out["1x1/train_4k"] = trace_cell(get_config("tinyllama-1.1b"), SHAPES["train_4k"], mesh)
mesh = fake_mesh((2, 4), ("data", "model"))
for kind in ("train", "prefill"):
    out[f"2x4/{kind}"] = trace_cell(tiny, ShapeCell(kind, S, B, kind), mesh)
mesh = fake_mesh((4, 2), ("data", "model"))
for arch in archs:
    for kind in kinds:
        out[f"{arch}/{kind}"] = trace_cell(get_smoke_config(arch), ShapeCell(kind, S, B, kind),
                                           mesh)
json.dump(out, open(sys.argv[1], "w"))
"""

# the reference's parameters' and optimizer state's shard bytes of the smoke
# train cells, on 8 faked devices
JAX_SHARD_BYTES = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.configs.base import ShapeCell
from repro.distributed import mesh_context
from repro.distributed.sharding import STRATEGIES
from repro.launch.specs import build_cell
archs, B, S = json.loads(sys.argv[2])
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def shard_bytes(tree):
    return sum(int(np.prod(x.sharding.shard_shape(x.shape))) * x.dtype.itemsize
               for x in jax.tree.leaves(tree))


out = {}
for arch in archs:
    with mesh_context(mesh, rules=STRATEGIES["tp_fsdp"]):
        _, (params, opt, _), _ = build_cell(get_smoke_config(arch),
                                            ShapeCell("train", S, B, "train"), mesh)
    out[arch] = {"params": shard_bytes(params), "opt_state": shard_bytes(opt)}
json.dump(out, open(sys.argv[1], "w"))
"""

# hand-computed collectives, flops and live bytes on a faked (4, 2) mesh
METER = r"""
import json, sys
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch.dryrun import StepMeter, fake_mesh
mesh = fake_mesh((4, 2), ("data", "model"))
meta = torch.device("meta")
out = {}
with StepMeter() as m:
    funcol.all_gather_tensor(torch.empty((16, 32), dtype=torch.bfloat16, device=meta), 0,
                             mesh.get_group("data"))
    funcol.reduce_scatter_tensor(torch.empty((64, 32), device=meta), "sum", 0,
                                 mesh.get_group("data"))
    funcol.all_reduce(torch.empty(10, device=meta), "sum", mesh.get_group("model"))
    dist.all_reduce(torch.empty(5, device=meta), group=mesh.get_group("model"))
    dist.broadcast(torch.empty(3, device=meta), src=0)
out["collectives"] = {"bytes": m.bytes_by_op, "count": m.count_by_op}
x = torch.empty((8, 16), device=meta)
w = torch.empty((16, 4), device=meta)
with StepMeter() as m:
    torch.mm(x, w)
out["plain_flops"] = m.flops
xd = distribute_tensor(x, mesh, [Shard(0), Replicate()], src_data_rank=None)
wd = distribute_tensor(w, mesh, [Replicate(), Replicate()], src_data_rank=None)
with StepMeter() as m:
    xd @ wd
out["dtensor_flops"] = m.flops
with FlopCounterMode(display=False) as fc:
    xd @ wd
out["flop_counter_outside_dtensor"] = fc.get_total_flops()
with StepMeter() as m:
    base = m.live
    a = torch.empty(1000, device=meta)
    del a
    b = torch.empty(500, device=meta)
    out["live"] = [base, m.live, m.peak]
json.dump(out, open(sys.argv[1], "w"))
"""

# the CLI on full-width tinyllama-1.1b, its records kept under a temporary
# directory
FULL_WIDTH = r"""
import sys
from pathlib import Path
import repro_torch.launch.dryrun as d
d.ARTIFACTS = Path(sys.argv[1])
sys.exit(d.main(["--arch", "tinyllama-1.1b", "--mesh", "single", "--force"]))
"""


def _start(args, log):
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=_env(), stdout=log,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    jobs = {
        "list_port": ["-m", "repro_torch.launch.dryrun", "--list"],
        "list_jax": ["-m", "repro.launch.dryrun", "--list"],
        "cells": ["-c", PORT_CELLS, str(out / "cells.json"),
                  json.dumps([PROBE, PROBE_CELLS, SMOKE_ARCHS, SMOKE_KINDS, SMOKE_BATCH,
                              SMOKE_SEQ])],
        "jax_bytes": ["-c", JAX_SHARD_BYTES, str(out / "jax_bytes.json"),
                      json.dumps([SMOKE_ARCHS, SMOKE_BATCH, SMOKE_SEQ])],
        "meter": ["-c", METER, str(out / "meter.json")],
        "full_width": ["-c", FULL_WIDTH, str(out / "records")],
    }
    logs = {name: open(out / f"{name}.log", "w") for name in jobs}
    procs = {name: _start(args, logs[name]) for name, args in jobs.items()}
    deadline = time.monotonic() + TIMEOUT
    try:
        for p in procs.values():
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs.values():
            log.close()
    res = {name: (p.returncode, (out / f"{name}.log").read_text()) for name, p in procs.items()}
    res["full_width_dir"] = out / "records"
    for name in ("cells", "jax_bytes", "meter"):
        rc, text = res[name]
        assert rc == 0, f"{name}:\n{text[-4000:]}"
        res[name] = json.loads((out / f"{name}.json").read_text())
    return res


def test_list_prints_what_the_reference_prints(runs):
    (rc_p, port), (rc_j, ref) = runs["list_port"], runs["list_jax"]
    assert rc_p == 0 and rc_j == 0, port[-2000:] + ref[-2000:]
    lines = port.splitlines()
    assert len(lines) == 40
    assert lines == ref.splitlines()


def _xla_flops(kind, batch, seq):
    """XLA's ``cost_analysis`` flops of the reference's step on the probe
    config, as tests/test_roofline.py computes them."""
    model = JaxModel(JaxModelConfig(**PROBE))
    params = jax.eval_shape(lambda r: model.init(r)[0], jax.random.PRNGKey(0))
    tok = jax.ShapeDtypeStruct((batch, seq), jnp.int32)
    if kind == "prefill":
        c = jax.jit(lambda p, b: model.prefill(p, b, seq)).lower(params, {"tokens": tok})
    else:
        acfg = AdamWConfig()

        def step(p, o, b):
            loss, g = jax.value_and_grad(model.loss)(p, b)
            return adamw_update(g, p, o, acfg) + (loss,)
        c = jax.jit(step).lower(params, jax.eval_shape(adamw_init, params),
                                {"tokens": tok, "targets": tok})
    return cost_analysis_dict(c.compile())["flops"]


@pytest.mark.parametrize("kind", list(PROBE_CELLS))
def test_flops_within_the_roofline_bounds_of_xla(runs, kind):
    batch, seq, bound = PROBE_CELLS[kind]
    rec = runs["cells"][f"probe/{kind}"]
    xla = _xla_flops(kind, batch, seq)
    print(f"probe {kind}: port {rec['flops']:.4g}, XLA {xla:.4g}, ratio {rec['flops'] / xla:.4f}")
    assert rec["n_devices"] == 1
    assert 1 - bound < rec["flops"] / xla < 1 + bound


@pytest.mark.parametrize("kind", SMOKE_KINDS)
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_smoke_cell_runs_on_a_faked_mesh(runs, arch, kind):
    rec = runs["cells"][f"{arch}/{kind}"]
    assert rec["n_devices"] == 8
    assert rec["flops"] > 0 and rec["trace_s"] >= 0
    assert rec["collectives"]["total_bytes"] == sum(rec["collectives"]["bytes_by_op"].values())
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == sum(mem["argument_size_by_input"].values())
    assert mem["temp_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    if kind == "train":
        # the parameters and moments are updated in place
        assert mem["alias_size_in_bytes"] >= mem["argument_size_by_input"]["params"]
        want = runs["jax_bytes"][arch]
        got = mem["argument_size_by_input"]
        assert (got["params"], got["opt_state"]) == (want["params"], want["opt_state"])


@pytest.mark.parametrize("cell", ["4x2/train", "4x2/prefill", "2x4/train", "2x4/prefill",
                                  "16x16/train_4k"])
def test_sharded_work_is_split_not_repeated(runs, cell):
    """Each rank multiplies its own tokens by its own part of the weights:
    no product's contraction split over the batch's axes (each rank would
    multiply every token), no attention on every head of its batch."""
    shape, kind = cell.split("/")
    cells = runs["cells"]
    if shape == "16x16":
        rec = json.loads((runs["full_width_dir"] / "tinyllama-1.1b__train_4k__single.json")
                         .read_text())
    else:
        rec = cells[f"{shape}/{kind}" if shape == "2x4" else f"tinyllama-1.1b/{kind}"]
    total = rec["flops"] * rec["n_devices"]
    one = cells[f"1x1/{kind}"]["flops"]
    print(f"{cell}: {rec['n_devices']} x {rec['flops']:.4g} = {total / one:.4f} x the unsharded")
    assert one <= total <= (1 + SPLIT_RTOL) * one


def test_traffic_model_on_hand_computed_collectives(runs):
    """bytes = result size x factor: all-gather 1 (its result holds the
    group), reduce-scatter the group size, all-reduce 2, broadcast 1."""
    c = runs["meter"]["collectives"]
    assert c["bytes"] == {"all-gather": 64 * 32 * 2,          # (16, 32) bf16 over 4
                          "reduce-scatter": 16 * 32 * 4 * 4,  # (64, 32) fp32 over 4
                          "all-reduce": 10 * 4 * 2 + 5 * 4 * 2,
                          "broadcast": 3 * 4}
    assert c["count"] == {"all-gather": 1, "reduce-scatter": 1, "all-reduce": 2,
                          "broadcast": 1}


def test_meter_counts_local_shards_and_live_bytes(runs):
    m = runs["meter"]
    assert m["plain_flops"] == 2 * 8 * 16 * 4
    # x split 4 ways over "data": rank 0 multiplies 2 of the 8 rows, while a
    # mode entered outside DTensor sees the global shapes
    assert m["flop_counter_outside_dtensor"] == 2 * 8 * 16 * 4
    assert m["dtensor_flops"] == 2 * 2 * 16 * 4
    base, live, peak = m["live"]
    assert live - base == 500 * 4 and peak - base == 1000 * 4


def test_full_width_tinyllama_cells_on_the_16x16_mesh(runs):
    rc, text = runs["full_width"]
    rows = {line.split()[1]: line.split()[3] for line in text.splitlines()
            if line.startswith("tinyllama-1.1b")}
    assert rc == 0, text[-4000:]
    assert rows == {"train_4k": "ok", "prefill_32k": "ok", "decode_32k": "ok",
                    "long_500k": "skipped"}, text[-4000:]
