"""The port's dry-run specs (``repro_torch.launch.specs``) and decode-state
trees against the JAX package's:

- ``Model.init_decode_state``'s shapes and dtypes and ``decode_state_axes``
  against the reference's (``jax.eval_shape``) for every architecture's
  smoke config and full config, at every decode cell of ``SHAPES``;
- the local shard shape of every parameter, AdamW moment, batch input and
  decode-state tensor that the port's ``build_cell`` lays out, against
  ``NamedSharding.shard_shape`` of the reference's ``build_cell``, for four
  full configs on the 16x16 and 2x16x16 meshes under every strategy. The
  reference runs in a process with 512 faked XLA host devices (meshes with
  ``Auto`` axes, nothing compiled), the port in a process that is rank 0
  of a faked group of 256, then 512 ranks (every tensor on ``meta``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import Model as JaxModel
from repro_torch.configs import ARCHS, SHAPES, cell_supported, get_config, get_smoke_config
from repro_torch.distributed import STRATEGIES
from repro_torch.models import Model

ROOT = Path(__file__).resolve().parents[1]
SPEC_ARCHS = ["tinyllama-1.1b", "mamba2-2.7b", "zamba2-1.2b", "qwen2-moe-a2.7b"]
MESHES = ["single", "multi"]
DECODE_CELLS = [name for name, cell in SHAPES.items() if cell.kind == "decode"]
TIMEOUT = 600


def fields(tree, prefix=""):
    """``{path: leaf}`` of a tree of NamedTuples (JAX's or the port's), by
    field name; a plain tuple (a leaf's logical axes) is a leaf."""
    if hasattr(tree, "_fields"):
        out = {}
        for name in tree._fields:
            out.update(fields(getattr(tree, name), f"{prefix}{name}/"))
        return out
    return {prefix.rstrip("/"): tree}


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_matches_the_reference(arch, size):
    if size == "smoke":
        cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    else:
        cfg, jcfg = get_config(arch), jax_config(arch)
    model, ref = Model(cfg), JaxModel(jcfg)
    assert fields(model.decode_state_axes()) == fields(ref.decode_state_axes())
    for name in DECODE_CELLS:
        cell = SHAPES[name]
        got = fields(model.init_decode_state(cell.global_batch, cell.seq_len, device="meta"))
        want = fields(jax.eval_shape(
            lambda: ref.init_decode_state(cell.global_batch, cell.seq_len)))
        assert sorted(got) == sorted(want)
        for path, leaf in want.items():
            if path == "pos":
                assert got[path] == cell.seq_len and leaf.shape == () \
                    and leaf.dtype == np.int32
                continue
            assert tuple(got[path].shape) == leaf.shape, (name, path)
            assert str(got[path].dtype).removeprefix("torch.") == leaf.dtype.name, (name, path)
            assert got[path].device.type == "meta"


# the cells of one (arch, mesh, strategy) whose leaves are compared: the
# train cell's parameters, moments and batch, and every decode cell's state
def _cells(arch):
    return [name for name, cell in SHAPES.items() if cell_supported(get_config(arch), cell)[0]]


JAX_SHAPES = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
import numpy as np
from jax.sharding import AxisType
from repro.configs import SHAPES, get_config
from repro.distributed import mesh_context
from repro.distributed.sharding import OPT_RULES, STRATEGIES
from repro.launch.specs import build_cell
jobs = json.loads(sys.argv[2])
devs = np.array(jax.devices())
meshes = {"single": jax.sharding.Mesh(devs[:256].reshape(16, 16), ("data", "model"),
                                      axis_types=(AxisType.Auto,) * 2),
          "multi": jax.sharding.Mesh(devs.reshape(2, 16, 16), ("pod", "data", "model"),
                                     axis_types=(AxisType.Auto,) * 3)}


def shard_shapes(tree):
    return {jax.tree_util.keystr(p): list(x.sharding.shard_shape(x.shape))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


out = {}
for arch, mesh_kind, strategy, shape in jobs:
    cfg, cell, mesh = get_config(arch), SHAPES[shape], meshes[mesh_kind]
    with mesh_context(mesh, rules=STRATEGIES[strategy]):
        _, args, _ = build_cell(cfg, cell, mesh, opt_rules=OPT_RULES.get(strategy))
    rec = {}
    if cell.kind == "train":
        rec = {"params": shard_shapes(args[0]), "m": shard_shapes(args[1].m),
               "v": shard_shapes(args[1].v), "batch": shard_shapes(args[2])}
    elif cell.kind == "prefill":
        rec = {"batch": shard_shapes(args[1])}
    else:
        # pos is a 0-d replicated array here, a Python int in the port
        state = {k: v for k, v in shard_shapes(args[1]).items() if k != ".pos"}
        rec = {"state": state, "batch": {"['tokens']": shard_shapes(args[2])[""]}}
    out["|".join((arch, mesh_kind, strategy, shape))] = rec
json.dump(out, open(sys.argv[1], "w"))
"""

PORT_SHAPES = r"""
import json, sys
from repro_torch.configs import SHAPES, get_config
from repro_torch.convert import jax_path
from repro_torch.distributed import mesh_context
from repro_torch.distributed.sharding import OPT_RULES, STRATEGIES
from repro_torch.launch.dryrun import make_production_mesh
from repro_torch.launch.specs import build_cell
jobs = json.loads(sys.argv[2])


def local(t):
    return list(t.to_local().shape)


def named(tree):
    # the port's names, as the reference's key strings; a layer's tensor
    # under its stacked leaf's key, with its layer index
    out = {}
    for name, t in tree.items():
        path, i = jax_path(name)
        out.setdefault("".join(f"['{k}']" for k in path), {})[i] = local(t)
    return out


def state(tree, prefix=""):
    out = {}
    for f in tree._fields:
        v = getattr(tree, f)
        key = f"{prefix}.{f}"
        if hasattr(v, "_fields"):
            out.update(state(v, key))
        elif hasattr(v, "to_local"):
            out[key] = local(v)
    return out


out = {}
for mesh_kind in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    for arch, mk, strategy, shape in jobs:
        if mk != mesh_kind:
            continue
        cfg, cell = get_config(arch), SHAPES[shape]
        with mesh_context(mesh, rules=STRATEGIES[strategy]):
            _, args, _ = build_cell(cfg, cell, mesh, opt_rules=OPT_RULES.get(strategy))
        batch = {f"['{k}']": local(v) for k, v in (args[1] if cell.kind == "prefill"
                                                    else args[-1] if cell.kind == "train"
                                                    else {"tokens": args[2]}).items()}
        if cell.kind == "train":
            rec = {"params": named(dict(args[0].named_parameters())), "m": named(args[1].m),
                   "v": named(args[1].v), "batch": batch}
        elif cell.kind == "prefill":
            rec = {"batch": batch}
        else:
            rec = {"state": state(args[1]), "batch": batch}
        out["|".join((arch, mesh_kind, strategy, shape))] = rec
json.dump(out, open(sys.argv[1], "w"))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


@pytest.fixture(scope="module")
def shard_shapes(tmp_path_factory):
    """Both packages' local shard shapes for every job, computed in two
    processes side by side."""
    out = tmp_path_factory.mktemp("specs")
    jobs = json.dumps([(a, m, s, c) for a in SPEC_ARCHS for m in MESHES for s in STRATEGIES
                       for c in _cells(a)])
    procs = {name: subprocess.Popen([sys.executable, "-c", script, str(out / f"{name}.json"),
                                     jobs], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, script in (("jax", JAX_SHAPES), ("port", PORT_SHAPES))}
    logs = {}
    try:
        for name, p in procs.items():
            logs[name] = p.communicate(timeout=TIMEOUT)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs.items():
        assert p.returncode == 0, f"{name}:\n{logs[name][-4000:]}"
    return {name: json.loads((out / f"{name}.json").read_text()) for name in procs}


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_local_shard_shapes_match_the_reference(shard_shapes, arch, mesh_kind, strategy):
    """A stacked leaf of the reference (layers first, never split) holds
    one shard shape for all its layers; each of the port's per-layer
    tensors has that shape without the layer axis."""
    n = 0
    for shape in _cells(arch):
        key = "|".join((arch, mesh_kind, strategy, shape))
        got, want = shard_shapes["port"][key], shard_shapes["jax"][key]
        assert sorted(got) == sorted(want), key
        for part in ("params", "m", "v"):
            if part not in want:
                continue
            assert sorted(got[part]) == sorted(want[part]), (key, part)
            for path, ref in want[part].items():
                per_layer = got[part][path]
                if list(per_layer) == ["null"]:        # not stacked
                    assert per_layer["null"] == ref, (key, part, path)
                else:
                    assert sorted(map(int, per_layer)) == list(range(ref[0])), (key, path)
                    assert all(s == ref[1:] for s in per_layer.values()), (key, part, path)
                n += 1
        assert got["batch"] == want["batch"], key
        n += len(want["batch"])
        if "state" in want:
            assert got["state"] == want["state"], key
            n += len(want["state"])
    assert n > 10
