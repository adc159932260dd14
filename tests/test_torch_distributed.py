"""The port's distributed layer against the JAX package's, on 8 ranks of
the CPU: 8 gloo processes for the port, 8 faked XLA host devices for JAX.

- the sharded fp32 smoke train step (``model.loss`` and ``adamw_update``
  under ``mesh_context``, the parameters placed by ``shard_params``) on a
  (4, 2) mesh: tinyllama under every strategy, mamba2, zamba2 and
  qwen2-moe under ``tp_fsdp``; and tinyllama under ``tp_fsdp`` on (1, 8),
  where the ``model`` axis exceeds its 2 KV heads and its 4 query heads, and
  on (2, 4), where it exceeds the KV heads only (each rank's query head reads
  its KV head of the whole K and V); against the JAX sharded step, whose mesh
  has ``Auto`` axes (under jax 0.9.0's default ``Explicit`` axes the JAX
  step does not run), and against the port's unsharded step: the loss,
  the updated parameters, the gradient norm, and each leaf's gradient and
  update (new minus old) against its own size. The step runs without
  warm-up, so that AdamW moves each parameter by about the learning rate
  (at the default warm-up the first step moves it by 1/100 of that, below
  the parameter bound);
- the sharded MoE dispatch on (4, 2), (2, 4), (8, 1) and (1, 8), against the
  JAX ``shard_map`` branch and against one unpartitioned dispatch per data
  shard, with the aux of data shard 0;
- AdamW with the moments laid out by ``OPT_RULES["dp_fsdp"]`` (split over
  both axes, unlike the parameters): the same update as with moments laid
  out like the parameters;
- sharded ``prefill`` and 4 ``decode_step``s of the tinyllama, mamba2 and
  zamba2 smoke configs under ``tp_fsdp`` and ``tp_serve`` on (4, 2) (and
  tinyllama's on (2, 4)), with a DTensor decode state, against the
  unsharded calls' logits;
- the elastic restore of ``tests/test_distributed_exec.py``'s program:
  smollm saved sharded under (4, 2), restored onto (2, 4);
- checkpoints crossing between the packages both ways.

One spawn of 8 port ranks runs every check, beside one JAX process that
runs the sharded programs; each has its own timeout.
"""
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch.distributed import STRATEGIES

ROOT = Path(__file__).resolve().parents[1]
# (arch, strategy, mesh)
STEPS = [("tinyllama-1.1b", s, (4, 2)) for s in STRATEGIES] + [
    (arch, "tp_fsdp", (4, 2)) for arch in ("mamba2-2.7b", "zamba2-1.2b", "qwen2-moe-a2.7b")] + [
    ("tinyllama-1.1b", "tp_fsdp", (1, 8)), ("tinyllama-1.1b", "tp_fsdp", (2, 4))]
MOE_MESHES = [(4, 2), (2, 4), (8, 1), (1, 8)]
# sharded prefill + decode steps: (arch, strategy, mesh)
SERVES = [(arch, s, (4, 2)) for arch in ("tinyllama-1.1b", "mamba2-2.7b", "zamba2-1.2b")
          for s in ("tp_fsdp", "tp_serve")] + [("tinyllama-1.1b", "tp_fsdp", (2, 4))]
DECODE_STEPS = 4
# the sharded logits against the unsharded ones, of the largest |logit|
SERVE_TOL = 1e-5
# the reference's own bounds (tests/test_distributed_exec.py)
LOSS_TOL, PARAM_TOL = 1e-4, 1e-3
# the global gradient norm of the step, relative
GNORM_TOL = 1e-4
# each leaf's gradient and update, |a - b| / |b| (2-norms over the leaf)
GRAD_RTOL, UPDATE_RTOL = 1e-4, 1e-3
# the step's AdamW: the default one without warm-up
ADAMW = {"warmup_steps": 0}
# the MoE layer's outputs and aux (fp32, one layer)
MOE_TOL = 1e-5
TIMEOUT = 600
# the JAX sharded programs run in three processes, each compiling a part:
# tag -> (steps, MoE meshes)
JAX_PARTS = {"tinyllama": ([s for s in STEPS if s[0] == "tinyllama-1.1b"], []),
             "zamba2": ([s for s in STEPS if s[0] == "zamba2-1.2b"], []),
             "rest": ([s for s in STEPS if s[0] in ("mamba2-2.7b", "qwen2-moe-a2.7b")],
                      MOE_MESHES)}


def step_name(arch, strategy, mesh):
    """A step's key in the results: ``arch/strategy``, and the mesh where it
    is not (4, 2)."""
    mesh = tuple(mesh)
    return f"{arch}/{strategy}" + ("" if mesh == (4, 2) else f"/{mesh[0]}x{mesh[1]}")


# the JAX programs and the port's ranks name the steps alike
_STEP_NAME = "\n\n" + inspect.getsource(step_name)

_PRELUDE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.models import Model

out = sys.argv[1]
STEPS = json.loads(sys.argv[2])
MOE_MESHES = json.loads(sys.argv[3])


def mesh(shape):
    return jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def flat(arrays, prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arrays[prefix + "/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)


def init(arch):
    cfg = get_smoke_config(arch).replace(dtype=jnp.float32)
    model = Model(cfg)
    params, axes = model.init(jax.random.PRNGKey(0))
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0, cfg.vocab_size),
             "targets": jax.random.randint(jax.random.PRNGKey(2), (8, 32), 0, cfg.vocab_size)}
    return model, params, axes, batch


def moe_inputs():
    from repro.models.moe import moe_init
    p, _ = moe_init(jax.random.PRNGKey(3), 32, 48, 8, jnp.float32)
    return p, jax.random.normal(jax.random.PRNGKey(4), (8, 16, 32))
""" + _STEP_NAME

# the weights, batches and a checkpoint, for the port
JAX_INIT = _PRELUDE + r"""
from repro.checkpoint import CheckpointManager
arrays = {}
for arch in dict.fromkeys([a for a, _, _ in STEPS] + ["smollm-360m"]):
    _, params, _, batch = init(arch)
    flat(arrays, f"{arch}/init", params)
    for k, v in batch.items():
        arrays[f"{arch}/batch/{k}"] = np.asarray(v)
    if arch == "smollm-360m":
        CheckpointManager(os.path.join(out, "jax_ck"), n_shards=4).save(5, params, sync=True)
p, x = moe_inputs()
flat(arrays, "moe/params", p)
arrays["moe/x"] = np.asarray(x)
np.savez(os.path.join(out, "init.npz"), **arrays)
print("INIT_OK", flush=True)
"""

# the reference's sharded programs, as tests/test_distributed_exec.py builds
# them, on meshes with Auto axes
JAX_SHARDED = _PRELUDE + r"""
from repro.distributed import mesh_context
from repro.distributed.sharding import STRATEGIES
from repro.launch.specs import tree_shardings
from repro.models.moe import moe_apply
from repro.optim import AdamWConfig, adamw_init, adamw_update
arrays, meta = {}, {}
acfg = AdamWConfig(**json.loads(sys.argv[4]))
for arch in dict.fromkeys(a for a, _, _ in STEPS):
    model, params, axes, batch = init(arch)
    opt = adamw_init(params)

    def step(p, o, b):
        loss, g = jax.value_and_grad(model.loss)(p, b)
        new, _, gn = adamw_update(g, p, o, acfg)
        return loss, new, gn, g

    for a, strategy, shape in STEPS:
        if a != arch:
            continue
        m = mesh(shape)
        with mesh_context(m, rules=STRATEGIES[strategy]):
            sh = tree_shardings(jax.eval_shape(lambda: params), axes, m)
            ps = jax.tree.map(jax.device_put, params, sh)
            loss, new, gn, g = jax.jit(step)(ps, opt, batch)
        name = step_name(arch, strategy, shape)
        meta[name] = {"loss": float(loss), "gnorm": float(gn)}
        flat(arrays, f"{name}/params", new)
        flat(arrays, f"{name}/grads", g)
p, x = moe_inputs()
for shape in MOE_MESHES:
    with mesh_context(mesh(shape)):
        y, aux = jax.jit(lambda p, x: moe_apply(p, x, n_top=2))(p, x)
    arrays[f"moe/{shape[0]}x{shape[1]}/y"] = np.asarray(y)
    meta[f"moe/{shape[0]}x{shape[1]}"] = {"aux": float(aux)}
np.savez(os.path.join(out, f"jax_{sys.argv[5]}.npz"), **arrays)
json.dump(meta, open(os.path.join(out, f"jax_{sys.argv[5]}.json"), "w"))
print("SHARDED_OK", flush=True)
"""

# the port's sharded checkpoint, restored by the JAX package in one process
JAX_RESTORE = _PRELUDE + r"""
from repro.checkpoint import CheckpointManager
_, params, _, _ = init("smollm-360m")
tree, step = CheckpointManager(os.path.join(out, "port_ck")).restore(params)
d = max(float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)))
print("RESTORE", json.dumps({"step": step, "max_diff": d,
                             "n_leaves": len(jax.tree.leaves(tree))}), flush=True)
"""

PORT_RANK = r"""
import json, logging, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
STEPS = json.loads(sys.argv[5])
MOE_MESHES = json.loads(sys.argv[6])
ADAMW = json.loads(sys.argv[7])
SERVES = json.loads(sys.argv[8])
DECODE_STEPS = int(sys.argv[9])
torch.set_num_threads(1)
exec(sys.argv[10])     # step_name
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax, named_to_jax
from repro_torch.distributed import OPT_RULES, STRATEGIES, mesh_context, place, shard_params
from repro_torch.distributed.sharding import full, place_tensor
from repro_torch.models import Model
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import AdamWState

init = np.load(os.path.join(out, "init.npz"))
results, arrays = {}, {}
meshes = {}


def mesh(shape):
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    return meshes[shape]


def tree(prefix):
    t = {}
    for key in init.files:
        if key.startswith(prefix + "/"):
            *path, last = key[len(prefix) + 1:].split("/")
            node = t
            for k in path:
                node = node.setdefault(k, {})
            node[last] = init[key]
    return t


def flat(prefix, t, keys=()):
    for k, v in t.items():
        if isinstance(v, dict):
            flat(prefix, v, keys + (k,))
        else:
            arrays["/".join((prefix,) + keys + (k,))] = np.asarray(v, np.float32)


def setup(arch):
    cfg = get_smoke_config(arch).replace(dtype=torch.float32, use_flash=True,
                                         use_ssd_kernel=True)
    batch = {k: torch.from_numpy(init[f"{arch}/batch/{k}"]).long()
             for k in ("tokens", "targets")}
    return Model(cfg), from_jax(cfg, tree(f"{arch}/init"), device="cpu"), batch


# one step; returns the loss, the gradient norm and the gradients
def step(model, params, batch):
    loss = model.loss(params, batch)
    loss.backward()
    named = dict(params.named_parameters())
    grads = {k: p.grad for k, p in named.items()}
    _, _, gn = adamw_update(grads, named, adamw_init(named), AdamWConfig(**ADAMW))
    return float(full(loss.detach())), float(gn), grads


# the updated parameters and the gradients, whole, in the JAX tree's names
def keep(prefix, params, grads):
    for part, tree in (("params", params.state_dict()), ("grads", grads)):
        whole = {k: full(v.detach()) for k, v in tree.items()}
        if rank == 0:
            flat(f"{prefix}/{part}", named_to_jax(whole))


t0 = time.time()
for arch, strategy, shape in STEPS:
    if f"{arch}/unsharded" not in results:
        model, params, batch = setup(arch)
        loss, gn, grads = step(model, params, batch)
        results[f"{arch}/unsharded"] = {"loss": loss, "gnorm": gn}
        keep(f"{arch}/unsharded", params, grads)
    model, params, batch = setup(arch)
    name = step_name(arch, strategy, shape)
    with mesh_context(mesh(shape), STRATEGIES[strategy]):
        place(params, shard_params(params, model.logical_axes(params)))
        loss, gn, grads = step(model, params, batch)
    results[name] = {"loss": loss, "gnorm": gn}
    keep(name, params, grads)
    if name == "tinyllama-1.1b/dp_fsdp":
        dp_fsdp = {k: full(v.detach()).clone() for k, v in params.state_dict().items()}
results["seconds/steps"] = time.time() - t0

# the dp_fsdp step again, its moments laid out by the strategy's OPT_RULES
model, params, batch = setup("tinyllama-1.1b")
with mesh_context(mesh((4, 2)), STRATEGIES["dp_fsdp"]):
    axes = model.logical_axes(params)
    place(params, shard_params(params, axes))
    model.loss(params, batch).backward()
    named = dict(params.named_parameters())
    mv = shard_params(params, axes, rules=OPT_RULES["dp_fsdp"])
    m = {k: place_tensor(torch.zeros(p.shape), mv[k]) for k, p in named.items()}
    state = AdamWState(m, {k: z.clone() for k, z in m.items()},
                       torch.zeros((), dtype=torch.int32))
    adamw_update({k: p.grad for k, p in named.items()}, named, state, AdamWConfig(**ADAMW))
results["opt_rules"] = {
    "moments_moved": sum(tuple(m[k].placements) != tuple(named[k].placements) for k in named),
    "max_diff": max(float((full(v.detach()) - dp_fsdp[k]).abs().max())
                    for k, v in params.state_dict().items())}


# prefill, then DECODE_STEPS decode steps fed the batch's targets; the
# logits of each call, whole
def serve(model, params, batch):
    S = batch["tokens"].shape[1]
    logits, state = model.prefill(params, {"tokens": batch["tokens"]}, S + DECODE_STEPS)
    out = [full(logits)]
    for j in range(DECODE_STEPS):
        logits, state = model.decode_step(params, state, batch["targets"][:, j])
        out.append(full(logits))
    return torch.stack(out)


t0 = time.time()
for arch, strategy, shape in SERVES:
    model, params, batch = setup(arch)
    want = serve(model, params, batch)
    with mesh_context(mesh(shape), STRATEGIES[strategy]):
        place(params, shard_params(params, model.logical_axes(params)))
        got = serve(model, params, batch)
    results["serve/" + step_name(arch, strategy, shape)] = {
        "max_diff": float((got - want).abs().max()), "max_logit": float(want.abs().max()),
        "shape": list(got.shape)}
results["seconds/serve"] = time.time() - t0

# the MoE layer: sharded, and one unpartitioned dispatch per data shard
t0 = time.time()
moe = MoE(32, 48, 8, torch.float32, device="cpu")
moe.load_state_dict({k: torch.from_numpy(v) for k, v in tree("moe/params").items()})
x = torch.from_numpy(init["moe/x"])
with torch.no_grad():
    for shape in MOE_MESHES:
        name = f"moe/{shape[0]}x{shape[1]}"
        with mesh_context(mesh(shape)):
            y, aux = moe_apply(moe, x, n_top=2)
        y, aux = full(y), float(full(aux))
        per_shard = [moe_apply(moe, xs, n_top=2) for xs in x.chunk(shape[0])]
        y_ref = torch.cat([ys for ys, _ in per_shard])
        results[name] = {"aux": aux, "aux_shard0": float(per_shard[0][1]),
                         "aux_mean": float(sum(a for _, a in per_shard) / shape[0]),
                         "d_per_shard": float((y - y_ref).abs().max())}
        if rank == 0:
            arrays[f"{name}/y"] = y.numpy()
results["seconds/moe"] = time.time() - t0

# elastic restore: smollm saved under (4, 2), restored onto (2, 4)
t0 = time.time()
model, params, batch = setup("smollm-360m")
ref_loss = float(model.loss(params, batch))
axes = model.logical_axes(params)
with mesh_context(mesh((4, 2)), STRATEGIES["tp_fsdp"]):
    place(params, shard_params(params, axes))
    saved = dict(params.state_dict())
    mgr = CheckpointManager(os.path.join(out, "port_ck"), n_shards=4)
    mgr.save(3, saved, sync=True)
with mesh_context(mesh((2, 4)), STRATEGIES["tp_fsdp"]):
    sh_b = shard_params(params, axes)
    restored, got_step = mgr.restore(saved, shardings=sh_b)
    moved = all(tuple(restored[k].placements) == sh_b[k].placements
                and restored[k].device_mesh == mesh((2, 4)) for k in restored)
    diff = max(float((full(restored[k]) - full(saved[k])).abs().max()) for k in saved)
    params.load_state_dict(restored, assign=True)
    loss = float(full(model.loss(params, batch).detach()))
results["elastic"] = {"step": got_step, "max_diff": diff, "loss": loss, "ref_loss": ref_loss,
                      "on_new_mesh": moved, "n_leaves": len(restored)}

# a JAX checkpoint, restored sharded onto (2, 4)
fresh = Model(model.cfg).init(0, device="cpu")
with mesh_context(mesh((2, 4)), STRATEGIES["tp_fsdp"]):
    from_ck, got_step = CheckpointManager(os.path.join(out, "jax_ck")).restore(
        dict(fresh.state_dict()), shardings=shard_params(fresh, axes))
want = from_jax(model.cfg, tree("smollm-360m/init"), device="cpu").state_dict()
results["from_jax"] = {"step": got_step, "n_leaves": len(from_ck),
                       "max_diff": max(float((full(from_ck[k]) - want[k]).abs().max())
                                       for k in want)}
results["seconds/checkpoints"] = time.time() - t0
if rank == 0:
    np.savez(os.path.join(out, "port.npz"), **arrays)
    json.dump(results, open(os.path.join(out, "port.json"), "w"))
dist.barrier()
dist.destroy_process_group()
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("JAX_PLATFORMS", "cpu")
    env.update(extra)
    return env


def _start(args, log):
    return subprocess.Popen([sys.executable, "-c", *args], cwd=ROOT, env=_env(),
                            stdout=log, stderr=subprocess.STDOUT, text=True)


def _wait(procs, logs, deadline):
    """Wait for every process until ``deadline``; kill them all if one fails
    or time runs out. Returns each one's output."""
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
            if p.returncode:
                break
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = [Path(log.name).read_text() for log in logs]
    bad = [i for i, p in enumerate(procs) if p.returncode]
    assert not bad, f"process {bad[0]} failed or timed out:\n" + texts[bad[0]][-4000:]
    return texts


def run_programs(out: Path):
    """The JAX init program, then the JAX sharded programs beside the 8 port
    ranks, then the JAX restore of the port's checkpoint."""
    steps, meshes, adamw = json.dumps(STEPS), json.dumps(MOE_MESHES), json.dumps(ADAMW)
    deadline = time.monotonic() + TIMEOUT
    with open(out / "init.log", "w") as log:
        _wait([_start([JAX_INIT, str(out), steps, meshes], log)], [log], deadline)
    logs = [open(out / f"{name}.log", "w")
            for name in list(JAX_PARTS) + [f"rank{r}" for r in range(8)]]
    try:
        procs = [_start([JAX_SHARDED, str(out), json.dumps(st), json.dumps(ms), adamw, tag],
                        log)
                 for (tag, (st, ms)), log in zip(JAX_PARTS.items(), logs)]
        procs += [_start([PORT_RANK, str(r), "8", str(out / "store"), str(out), steps, meshes,
                          adamw, json.dumps(SERVES), str(DECODE_STEPS), _STEP_NAME],
                         logs[r + len(JAX_PARTS)]) for r in range(8)]
        _wait(procs, logs, deadline)
    finally:
        for log in logs:
            log.close()
    with open(out / "restore.log", "w") as log:
        text = _wait([_start([JAX_RESTORE, str(out), steps, meshes], log)], [log], deadline)[0]
    restore = json.loads(text.split("RESTORE", 1)[1].strip().splitlines()[0])
    return {"init": dict(np.load(out / "init.npz")),
            "port": json.loads((out / "port.json").read_text()),
            "port_arrays": dict(np.load(out / "port.npz")),
            "jax": {k: v for tag in JAX_PARTS
                    for k, v in json.loads((out / f"jax_{tag}.json").read_text()).items()},
            "jax_arrays": {k: v for tag in JAX_PARTS
                           for k, v in np.load(out / f"jax_{tag}.npz").items()},
            "restore": restore}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_programs(tmp_path_factory.mktemp("dist"))


def leaves(arrays, prefix):
    """``{path: array}`` of the leaves under ``prefix/``."""
    return {k[len(prefix) + 1:]: v for k, v in arrays.items() if k.startswith(prefix + "/")}


def rel_err(a, b):
    """|a - b| / |b| in the 2-norm; |a| where b is 0."""
    nb = float(np.linalg.norm(b))
    d = float(np.linalg.norm(a - b))
    return d / nb if nb else d


def compare_steps(runs, arch, got, want, arrays_want):
    """The step ``got`` of the port against ``want`` (``arrays_want`` holds
    its trees): loss, largest parameter difference, relative gradient
    norm, and the worst leaf's relative gradient and update errors."""
    init = leaves(runs["init"], f"{arch}/init")
    p_got = leaves(runs["port_arrays"], f"{got}/params")
    p_want = leaves(arrays_want, f"{want}/params")
    g_got = leaves(runs["port_arrays"], f"{got}/grads")
    g_want = leaves(arrays_want, f"{want}/grads")
    assert sorted(p_got) == sorted(p_want) == sorted(init) == sorted(g_got) == sorted(g_want)
    d_param = max(float(np.max(np.abs(p_got[k] - p_want[k]))) for k in init)
    d_grad = {k: rel_err(g_got[k], g_want[k]) for k in init}
    d_update = {k: rel_err(p_got[k] - init[k], p_want[k] - init[k]) for k in init}
    worst_g, worst_u = max(d_grad, key=d_grad.get), max(d_update, key=d_update.get)
    return d_param, (worst_g, d_grad[worst_g]), (worst_u, d_update[worst_u])


def check_step(runs, arch, name, got, want, ref, arrays_want):
    d_param, (gk, d_grad), (uk, d_update) = compare_steps(runs, arch, got, want,
                                                          arrays_want)
    port = runs["port"][got]
    d_loss = abs(port["loss"] - ref["loss"])
    d_gnorm = abs(port["gnorm"] - ref["gnorm"]) / ref["gnorm"]
    print(f"{arch} {got} vs {name}: loss {d_loss:.3g}, params {d_param:.3g}, gnorm "
          f"{d_gnorm:.3g}, gradient {d_grad:.3g} ({gk}), update {d_update:.3g} ({uk})")
    assert d_loss < LOSS_TOL
    assert d_param < PARAM_TOL
    assert d_gnorm < GNORM_TOL
    assert d_grad < GRAD_RTOL, f"gradient of {gk}"
    assert d_update < UPDATE_RTOL, f"update of {uk}"


def _step_params(steps):
    """Each step as a test case, named ``arch-strategy`` (and the mesh where
    it is not (4, 2))."""
    return [pytest.param(*st, id=step_name(*st).replace("/", "-")) for st in steps]


@pytest.mark.parametrize("arch,strategy,shape", _step_params(STEPS))
def test_sharded_step_matches_the_jax_sharded_step(runs, arch, strategy, shape):
    name = step_name(arch, strategy, shape)
    check_step(runs, arch, "JAX", name, name, runs["jax"][name], runs["jax_arrays"])


@pytest.mark.parametrize("arch,strategy,shape",
                         _step_params(s for s in STEPS if not s[0].startswith("qwen2")))
def test_sharded_step_matches_the_unsharded_port_step(runs, arch, strategy, shape):
    """Every family but MoE: with a capacity from each data shard's tokens
    the sharded MoE routes differently (test_sharded_moe_*)."""
    check_step(runs, arch, "unsharded", step_name(arch, strategy, shape), f"{arch}/unsharded",
               runs["port"][f"{arch}/unsharded"], runs["port_arrays"])


@pytest.mark.parametrize("arch,strategy,shape", _step_params(SERVES))
def test_sharded_prefill_and_decode_match_the_unsharded_calls(runs, arch, strategy, shape):
    """The caches written on each rank's shards (the prefill's K/V and SSM
    states, the decode steps' K/V, conv windows and states), then read by
    the next step: the logits of the prefill and of every decode step."""
    name = step_name(arch, strategy, shape)
    r = runs["port"][f"serve/{name}"]
    print(f"{name}: logits {r['max_diff']:.3g} of {r['max_logit']:.3g}")
    assert r["shape"] == [1 + DECODE_STEPS, 8, 256]
    assert r["max_diff"] <= SERVE_TOL * r["max_logit"]


@pytest.mark.parametrize("shape", MOE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_moe_matches_the_jax_shard_map_branch(runs, shape):
    """A capacity per data shard, and the aux of data shard 0 (not the mean
    over shards), as the reference's shard_map branch gives."""
    name = f"moe/{shape[0]}x{shape[1]}"
    port, jax_ = runs["port"][name], runs["jax"][name]
    d_y = float(np.max(np.abs(runs["port_arrays"][f"{name}/y"]
                              - runs["jax_arrays"][f"{name}/y"])))
    print(f"{name}: y {d_y:.3g} vs JAX, {port['d_per_shard']:.3g} vs per-shard dispatches; "
          f"aux {port['aux']} (JAX {jax_['aux']}, shard mean {port['aux_mean']})")
    assert d_y < MOE_TOL
    assert port["d_per_shard"] < MOE_TOL
    assert abs(port["aux"] - jax_["aux"]) < MOE_TOL
    assert port["aux"] == pytest.approx(port["aux_shard0"], abs=MOE_TOL)


def test_adamw_with_moments_laid_out_by_opt_rules(runs):
    """The update runs on the moments' layout and goes back onto each
    parameter's: the parameters as with moments laid out like them (the
    gradients' sums run in other orders: the reference's parameter bound)."""
    r = runs["port"]["opt_rules"]
    print(f"opt rules: {r['moments_moved']} moments laid out otherwise, params {r['max_diff']:.3g}")
    assert r["moments_moved"] > 0
    assert r["max_diff"] < PARAM_TOL


def test_elastic_restore_onto_different_mesh(runs):
    e = runs["port"]["elastic"]
    print(f"elastic: loss {e['loss']} (unsharded {e['ref_loss']})")
    assert e["step"] == 3 and e["n_leaves"] == 20 and e["on_new_mesh"]
    assert e["max_diff"] == 0.0
    assert np.isfinite(e["loss"]) and abs(e["loss"] - e["ref_loss"]) < LOSS_TOL


def test_jax_checkpoint_restores_sharded_into_the_port(runs):
    r = runs["port"]["from_jax"]
    assert r["step"] == 5 and r["n_leaves"] == 20
    assert r["max_diff"] == 0.0


def test_sharded_port_checkpoint_restores_into_jax(runs):
    r = runs["restore"]
    assert r["step"] == 3 and r["n_leaves"] == 11
    assert r["max_diff"] == 0.0
