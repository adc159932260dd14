"""Probe: can two ranks share the one card through gloo's CUDA collectives?

  python3 scripts/probe_two_ranks_one_card.py

NCCL refuses two ranks on one device, so the sharded path runs at world
size 1 there. This starts two processes on cuda:0 with a gloo process group
(a FileStore under build/) and a (2, 1) ("data", "model") DeviceMesh on
"cuda", and tries in turn:
  1. gloo collectives on CUDA tensors: all_reduce, all_gather_into_tensor
     and reduce_scatter_tensor;
  2. the functional all-gather that DTensor calls, a DTensor made from
     each rank's shard (no collective), then the DTensor redistributions of
     a tp_fsdp step: Shard -> Replicate (all-gather), Partial -> Shard
     (reduce-scatter), Partial -> Replicate (all-reduce), each against its
     plain PyTorch result;
  3. if both ran: one bf16 train step of full-width, full-depth
     tinyllama-1.1b (batch 4 x 1024 tokens) under tp_fsdp on that mesh
     (``shard_params``, ``mesh_context``, ``Model.loss``, ``adamw_update``),
     with its loss against the unsharded model's on the same weights and
     batch.
Each rank prints a line as it starts each check, so a check that kills
the process is the last one started. Prints one JSON line: each check's
result or its error, and each rank's exit code. Exits 0 when both ranks ran
to their end, whatever they found; 1 otherwise.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2


def _err(e: BaseException) -> str:
    return f"{type(e).__name__}: {str(e).strip().splitlines()[0] if str(e).strip() else ''}"


def rank_main(rank: int, store: str) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD)
    out = {"rank": rank, "backend": dist.get_backend(), "device": torch.cuda.get_device_name(0)}
    x = torch.arange(8, dtype=torch.float32, device="cuda") + rank
    checks = {}

    def check(name, fn):
        print(f"START {name}", flush=True)      # a crash leaves this as the last line
        try:
            checks[name] = fn()
        except Exception as e:          # the probe reports what fails
            checks[name] = {"error": _err(e)}
        print(f"CHECK {name} " + json.dumps(checks[name]), flush=True)

    def all_reduce():
        t = x.clone()
        dist.all_reduce(t)
        return {"ok": bool(torch.equal(t.cpu(), torch.arange(8.0) * 2 + 1))}

    def all_gather():
        t = torch.empty(WORLD * 8, device="cuda")
        dist.all_gather_into_tensor(t, x)
        want = torch.cat([torch.arange(8.0) + r for r in range(WORLD)])
        return {"ok": bool(torch.equal(t.cpu(), want))}

    def reduce_scatter():
        t = torch.empty(8 // WORLD, device="cuda")
        dist.reduce_scatter_tensor(t, x)
        want = (torch.arange(8.0) * 2 + 1).chunk(WORLD)[rank]
        return {"ok": bool(torch.equal(t.cpu(), want))}

    check("gloo_all_reduce", all_reduce)
    check("gloo_all_gather", all_gather)
    check("gloo_reduce_scatter", reduce_scatter)

    def funcol_all_gather():
        from torch.distributed import _functional_collectives as funcol
        t = funcol.all_gather_tensor(x, 0, dist.group.WORLD)
        want = torch.cat([torch.arange(8.0) + r for r in range(WORLD)])
        return {"ok": bool(torch.equal(t.cpu(), want))}

    check("funcol_all_gather", funcol_all_gather)
    mesh = init_device_mesh("cuda", (WORLD, 1), mesh_dim_names=("data", "model"))
    g = torch.Generator(device="cuda").manual_seed(0)
    full = torch.randn((16, 32), generator=g, device="cuda")

    def local_shard():
        d = distribute_tensor(full, mesh, [Shard(0), Replicate()], src_data_rank=None)
        return {"ok": bool(torch.equal(d.to_local(), full.chunk(WORLD)[rank]))}

    def shard_to_replicate():
        d = distribute_tensor(full, mesh, [Shard(0), Replicate()], src_data_rank=None)
        return {"ok": bool(torch.equal(d.full_tensor(), full))}

    check("dtensor_local_shard", local_shard)

    def partial_to_shard():
        d = distribute_tensor(full, mesh, [Replicate(), Replicate()], src_data_rank=None)
        p = type(d).from_local(d.to_local() * (rank + 1), mesh, [Partial(), Replicate()])
        got = p.redistribute(mesh, [Shard(0), Replicate()]).to_local()
        want = (full * sum(range(1, WORLD + 1))).chunk(WORLD)[rank]
        return {"ok": bool(torch.allclose(got, want))}

    def partial_to_replicate():
        d = distribute_tensor(full, mesh, [Replicate(), Replicate()], src_data_rank=None)
        p = type(d).from_local(d.to_local() * (rank + 1), mesh, [Partial(), Replicate()])
        got = p.redistribute(mesh, [Replicate(), Replicate()]).to_local()
        return {"ok": bool(torch.allclose(got, full * sum(range(1, WORLD + 1))))}

    check("dtensor_all_gather", shard_to_replicate)
    check("dtensor_reduce_scatter", partial_to_shard)
    check("dtensor_all_reduce", partial_to_replicate)
    out["checks"] = checks
    if all(c.get("ok") for c in checks.values()):
        check("tinyllama_step", lambda: _tinyllama_step(torch, np, mesh, rank))
    dist.barrier()
    dist.destroy_process_group()
    return out


def _tinyllama_step(torch, np, mesh, rank):
    from repro_torch.configs import get_config
    from repro_torch.distributed import STRATEGIES, mesh_context, place, shard_params
    from repro_torch.distributed.sharding import full
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    cfg = get_config("tinyllama-1.1b").replace(use_flash=True)
    model = Model(cfg)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(4, 1024))).cuda()
             for k in ("tokens", "targets")}
    params = model.init(0, device="cuda")
    with torch.no_grad():
        ref = float(model.loss(params, batch))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with mesh_context(mesh, STRATEGIES["tp_fsdp"]):
        place(params, shard_params(params, model.logical_axes(params)))
        loss = model.loss(params, batch)
        loss.backward()
        named = dict(params.named_parameters())
        _, _, gnorm = adamw_update({k: p.grad for k, p in named.items()}, named,
                                   adamw_init(named), AdamWConfig())
        loss = float(full(loss.detach()))
    torch.cuda.synchronize()
    return {"ok": bool(np.isfinite(loss)), "loss": loss, "unsharded_loss": ref,
            "gnorm": float(gnorm), "step_s": time.monotonic() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def run_ranks(cmds, timeout):
    """Run the rank commands together, each writing to its own file (a pipe
    read one rank at a time could fill and stall the others); kill them
    all at ``timeout`` or when one fails. Returns their outputs and
    processes."""
    with tempfile.TemporaryDirectory() as d:
        logs = [open(Path(d) / f"rank{i}.log", "w+") for i in range(len(cmds))]
        procs = [subprocess.Popen(c, text=True, stdout=f, stderr=subprocess.STDOUT)
                 for c, f in zip(cmds, logs)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
                if any(p.poll() for p in procs):          # one failed: stop the rest
                    break
                time.sleep(1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    return outs, procs


def main() -> int:
    if len(sys.argv) == 3:                       # one rank: rank, store
        try:
            res = rank_main(int(sys.argv[1]), sys.argv[2])
        except Exception as e:
            res = {"rank": int(sys.argv[1]), "error": _err(e),
                   "trace": traceback.format_exc()[-3000:]}
        print("PROBE " + json.dumps(res), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("probe_two_ranks_one_card: CUDA is not available", file=sys.stderr)
        return 1
    (ROOT / "build").mkdir(exist_ok=True)
    store = tempfile.mktemp(prefix="probe_store_", dir=ROOT / "build")
    try:
        outs, procs = run_ranks([[sys.executable, __file__, str(r), store]
                                 for r in range(WORLD)], timeout=900)
    finally:
        Path(store).unlink(missing_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    ranks = []
    for p, o in zip(procs, outs):
        line = [ln for ln in o.splitlines() if ln.startswith("PROBE ")]
        ranks.append(json.loads(line[-1][6:]) if line else
                     {"error": f"no result, exit code {p.returncode}", "output": o[-3000:]})
    print(json.dumps({"card": smi.stdout.strip(), "torch": torch.__version__,
                      "ranks": ranks}))
    return 0 if all("PROBE " in o for o in outs) else 1


if __name__ == "__main__":
    sys.exit(main())
