"""The port's logical-axis sharding (repro_torch.distributed.sharding)
against the JAX package's: tests/test_sharding.py's cases and property on
the port, a parity table of ``spec_for`` against the reference on
``AbstractMesh``es (no devices needed), the DTensor placements of each spec,
the logical-axes tree of every architecture, and the mesh and cluster
builders (repro_torch.launch.mesh, .cluster)."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from hypothesis_support import given, settings, st
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.distributed import (LOGICAL_RULES, OPT_RULES, STRATEGIES, batch_axes,
                                     current_mesh, current_rules, logical_to_sharding,
                                     mesh_context, shard_activation)
from repro_torch.distributed.sharding import (divisible_prefix, placements_for, shard_params,
                                              spec_for)
from repro_torch.models import Model

ROOT = Path(__file__).resolve().parents[1]
MESH = {"data": 16, "model": 16}
PARITY_MESHES = [{"data": 4, "model": 2}, {"data": 2, "model": 4}, {"data": 8, "model": 1},
                 {"pod": 2, "data": 2, "model": 2}]
# (shape, logical axes): the weights of the smoke and full configs, the
# activations, and dimensions that do not divide
PARITY_CASES = [
    ((32000, 2048), ("vocab", "embed")),
    ((2048, 32000), ("embed", "vocab")),
    ((256, 64), ("vocab", "embed")),
    ((64, 4, 16), ("embed", "heads", "head_dim")),
    ((64, 2, 16), ("embed", "kv_heads", "head_dim")),
    ((4, 16, 64), ("heads", "head_dim", "embed")),
    ((60, 3, 20), ("embed", "heads", "head_dim")),
    ((2048, 5632), ("embed", "mlp")),
    ((5632, 2048), ("mlp", "embed")),
    ((22, 2048, 5632), ("layers", "embed", "mlp")),
    ((60, 2048, 1408), ("experts", "embed", "mlp")),
    ((8, 96, 64), ("experts", "mlp", "embed")),
    ((2048, 60), ("embed", "experts")),
    ((4, 128), ("conv", "mlp")),
    ((64, 32), ("embed", None)),
    ((80,), ("heads",)),
    ((64,), ("norm",)),
    ((8, 32, 64), ("batch", None, None)),
    ((4, 1024, 2048), ("batch", "seq", None)),
    ((6, 32), ("batch", None)),
    ((7, 5), ("embed", "mlp")),
    ((16, 16), ("embed", "embed")),
    ((), ()),
]


def check_valid(spec, shape, mesh):
    """A valid spec: no mesh axis twice, every sharded dim divisible."""
    used = []
    for dim, part in zip(shape, tuple(spec) + (None,) * len(shape)):
        if part is None:
            continue
        parts = part if isinstance(part, tuple) else (part,)
        size = 1
        for a in parts:
            assert a not in used
            used.append(a)
            size *= mesh[a]
        assert dim % size == 0


# ------------------------------------------- tests/test_sharding.py's cases
def test_divisible_dims_shard():
    n = MESH["data"]
    spec = spec_for((4 * n, 128), ("embed", "mlp"), MESH, LOGICAL_RULES)
    assert spec[0] == "data"


def test_indivisible_dims_replicate():
    n = MESH["data"]
    spec = spec_for((4 * n + 1, 7), ("embed", "mlp"), MESH, LOGICAL_RULES)
    assert spec == () or all(s is None for s in spec)


def test_axis_never_reused():
    spec = spec_for((16, 16), ("embed", "embed"), MESH, LOGICAL_RULES)
    used = [s for s in spec if s is not None]
    assert len(used) == len(set(used)) <= 1


def test_spec_valid_deterministic():
    cases = [
        (("embed", "mlp"), (64, 32)),
        (("embed", "mlp"), (7, 5)),
        (("embed", "embed"), (16, 16)),
        ((None, "vocab"), (3, 48)),
        ((), ()),
    ]
    for names, shape in cases:
        check_valid(spec_for(shape, names, MESH, LOGICAL_RULES), shape, MESH)


@settings(max_examples=50, deadline=None)
@given(st.lists(st.tuples(
    st.sampled_from([None, "embed", "mlp", "heads", "vocab", "batch", "layers"]),
    st.integers(1, 64)), min_size=0, max_size=4))
def test_spec_always_valid(dims):
    names = tuple(n for n, _ in dims)
    shape = tuple(s for _, s in dims)
    check_valid(spec_for(shape, names, MESH, LOGICAL_RULES), shape, MESH)


# ------------------------------------------------------ parity with the JAX
def test_rules_are_the_references_value_for_value():
    from repro.distributed import sharding as ref
    assert LOGICAL_RULES == ref.LOGICAL_RULES
    assert STRATEGIES == ref.STRATEGIES
    assert OPT_RULES == ref.OPT_RULES


def _abstract_mesh(mesh):
    import jax
    try:
        return jax.sharding.AbstractMesh(tuple(mesh.values()), tuple(mesh))
    except TypeError:               # jax <= 0.4.x takes ((name, size), ...)
        return jax.sharding.AbstractMesh(tuple(mesh.items()))


def _expected_placements(spec, mesh):
    """One placement per mesh axis: Shard(d) where the axis splits tensor
    dimension d, else Replicate."""
    out = []
    for axis in mesh:
        dims = [d for d, part in enumerate(spec)
                if part is not None and axis in ((part,) if isinstance(part, str) else part)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("mesh", PARITY_MESHES, ids=lambda m: "x".join(map(str, m.values())))
def test_spec_for_matches_the_reference(strategy, mesh):
    from repro.distributed.sharding import divisible_prefix as ref_divisible_prefix
    from repro.distributed.sharding import spec_for as ref_spec_for
    amesh = _abstract_mesh(mesh)
    rules = {**LOGICAL_RULES, **STRATEGIES[strategy]}
    for shape, names in PARITY_CASES:
        want = tuple(ref_spec_for(shape, names, amesh, rules))
        got = spec_for(shape, names, mesh, rules)
        assert got == want, (shape, names)
        assert placements_for(got, mesh) == _expected_placements(got, mesh)
        for dim, axes in zip(shape, names):
            ax = rules.get(axes) if axes else None
            assert divisible_prefix(dim, ax, mesh) == ref_divisible_prefix(dim, ax, amesh)


def test_placements_of_a_two_axis_spec():
    mesh = {"data": 4, "model": 2}
    # tinyllama's embed under tp_fsdp: vocab over model, embed over data
    assert spec_for((32000, 2048), ("vocab", "embed"), mesh, LOGICAL_RULES) == ("model", "data")
    assert placements_for(("model", "data"), mesh) == (Shard(1), Shard(0))
    # a dimension over two mesh axes is Shard on each, in mesh order
    assert placements_for((("data", "model"),), mesh) == (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="mesh order"):
        placements_for((("model", "data"),), mesh)


def test_logical_to_sharding_and_batch_axes_follow_the_rules():
    mesh = {"pod": 2, "data": 4, "model": 2}
    sh = logical_to_sharding((8, 16), ("batch", None), mesh, LOGICAL_RULES)
    assert sh.mesh is mesh and sh.placements == (Shard(0), Shard(0), Replicate())
    with mesh_context(mesh, STRATEGIES["fsdp"]):
        assert current_mesh() is mesh
        assert current_rules()["batch"] == ("pod", "data", "model")
        assert batch_axes() == ("pod", "data", "model")
        assert batch_axes(dim=8) == ("pod", "data")
        assert batch_axes(dim=6) == ("pod",)
    assert current_mesh() is None and current_rules() == LOGICAL_RULES


def test_shard_activation_is_a_no_op_without_a_mesh():
    x = torch.ones(4, 3)
    assert shard_activation(x) is x


# ----------------------------------------------------------- the axes tree
@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_tree_matches_the_reference(arch):
    """``Model.logical_axes`` against ``repro.models.Model(cfg).init()[1]``,
    leaf for leaf, each port name mapped through ``convert.jax_path``."""
    import jax
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import Model as JModel

    from repro_torch.convert import jax_path
    ref = JModel(jax_smoke(arch)).init(jax.random.PRNGKey(0))[1]
    params = Model(get_smoke_config(arch)).init(0, device="cpu")
    axes = Model.logical_axes(params)
    assert set(axes) == {n for n, _ in params.named_parameters()}
    seen = set()
    for name, got in axes.items():
        path, _ = jax_path(name)
        node = ref
        for k in path:
            node = node[k]
        assert tuple(got) == tuple(node), name
        seen.add(path)
    ref_leaves = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, tuple))[0]
    assert seen == {tuple(k.key for k in p) for p, _ in ref_leaves}


def test_shard_params_places_each_layer_tensor_by_its_stacked_axes():
    params = Model(get_smoke_config("tinyllama-1.1b")).init(0, device="cpu")
    axes = Model.logical_axes(params)
    assert axes["layers.0.attn.q"] == ("layers", "embed", "heads", "head_dim")
    sh = shard_params(params, axes, {"data": 4, "model": 2}, LOGICAL_RULES)
    assert sh["layers.0.attn.q"].placements == (Shard(0), Shard(1))      # (64, 4, 16)
    assert sh["layers.1.mlp.down"].placements == (Shard(1), Shard(0))    # (192, 64)
    assert sh["embed"].placements == (Shard(1), Shard(0))                # (256, 64)
    assert sh["final_norm"].placements == (Replicate(), Replicate())


# ------------------------------------------------- mesh and cluster builders
CLUSTER = r"""
import json, sys
from repro_torch.launch.cluster import global_runtime_cluster, initialize_cluster
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
info = initialize_cluster(device="cpu")
again = initialize_cluster(device="cpu")
mesh = make_local_mesh("cpu")
try:
    make_production_mesh(device="cpu")
    err = None
except ValueError as e:
    err = str(e)
cl = global_runtime_cluster(ckpt_bw_mbs=2000.0)
w = cl.workers[0]
print("CLUSTER", json.dumps({"info": info, "again": again, "mesh": list(mesh.mesh.shape),
                             "names": list(mesh.mesh_dim_names), "err": err,
                             "host": w.name, "bw": w.storage.bandwidth}))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_cluster(n):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), NUM_PROCESSES=str(n),
               COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}")
    procs = [subprocess.Popen([sys.executable, "-c", CLUSTER], cwd=ROOT, text=True,
                              env=dict(env, PROCESS_ID=str(i)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    return [json.loads(o.split("CLUSTER", 1)[1].strip().splitlines()[0]) for o in outs]


@pytest.mark.parametrize("n", [1, 2])
def test_cluster_and_local_mesh_from_the_environment(n):
    """One process: no group is needed from the caller, ``make_local_mesh``
    starts a world-1 one. Two: ``initialize_cluster`` joins them through
    COORDINATOR_ADDR; each host's share of the checkpoint bandwidth halves."""
    for i, r in enumerate(_run_cluster(n)):
        assert r["info"] == r["again"] == {"process_index": i, "process_count": n,
                                           "local_devices": 1, "global_devices": n}
        assert r["mesh"] == [n, 1] and r["names"] == ["data", "model"]
        assert "256 ranks" in r["err"] and f"has {n}" in r["err"]
        assert r["host"] == f"host{i}" and r["bw"] == 2000.0 / n
