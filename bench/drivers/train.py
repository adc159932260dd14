"""Training cells: the port's ``train_step`` in a loop copied from
``repro_torch.launch.train.train``, inside ``IORuntime(build_cluster(),
backend=RealBackend())``, batches read through the port's
``PrefetchLoader`` from the benchmark's own seeded corpus; with ``save_at``
one asynchronous ``CheckpointManager.save`` of (weights, AdamW state) under
``$TMPDIR`` at that step of the window, and ``wait`` before it closes.

Set-up builds the model from the benchmark's weights and runs its first
``check_steps`` steps through the window's own call and feed; those steps
warm every shape up and are what the check holds against the reference:
each step's loss, each leaf's first gradient as AdamW got it (from its
first moment after one step) and each leaf's change after the last of
them. The window then goes on with the same objects.
"""
from __future__ import annotations

import math
import shutil
import tempfile
from pathlib import Path

from ..lib import adamw as ref_adamw
from ..lib.ckpt import mismatches, read_checkpoint
from ..lib.corpus import SyntheticCorpus
from ..lib.harness import log, model_module, now
from ..lib.trace import profiled, warm_profiler


def ckpt_dir() -> Path:
    """A fixed directory under ``$TMPDIR`` for the run's one checkpoint."""
    return Path(tempfile.gettempdir()) / "bench-train-ckpt"


def run(run):
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import IORuntime, RealBackend
    from repro_torch.data import PrefetchLoader
    from repro_torch.launch import train as train_mod
    from repro_torch.models import Model
    from repro_torch.models.model import model_class
    from repro_torch.optim import AdamWConfig, adamw_init

    c, tr, dev = run.c, run.tr, torch.device(run.device)
    mod = model_module(c)
    cfg = mod.port_config(c, ModelConfig)
    B, S, n_check = tr["batch"], tr["seq"], tr["check_steps"]
    opt = AdamWConfig(**tr["optimizer"])

    W = mod.make_weights(c, run.seed, dev)
    model = Model(cfg)
    params = model_class(cfg)(cfg, dev, None)
    params.load_state_dict(W)
    opt_state = adamw_init(params.state_dict())
    log(run, f"weights made and loaded: {cfg.name}, batch {B} x {S}")
    corpus = SyntheticCorpus(c["vocab_size"], S, B, run.seed)
    save_at = tr.get("save_at")
    mgr = None
    if save_at:
        shutil.rmtree(ckpt_dir(), ignore_errors=True)
        mgr = CheckpointManager(ckpt_dir(), n_shards=tr["n_shards"])
    if run.traced and dev.type == "cuda":
        warm_profiler(torch)

    spans, losses = run.spans, []
    saved = None
    with IORuntime(train_mod.build_cluster(), backend=RealBackend(), trace=run.traced) as rt:
        loader = PrefetchLoader(corpus, depth=2)

        def one_step(step):
            nonlocal opt_state
            b = loader.get(step)
            opt_state, loss, _ = train_mod.train_step(model, params, opt_state, b, opt)
            return float(loss)

        # set-up: the checked steps
        for step in range(n_check):
            losses.append(one_step(step))
            if step == 0:
                g1 = _norms({k: m / (1 - opt.b1) for k, m in opt_state.m.items()})
        change = _norms({k: p.float() - W[k].float() for k, p in params.state_dict().items()})
        del W
        _sync(torch, dev)
        log(run, f"checked steps done, losses {losses}")

        # the window
        run.window_start = t0 = now()
        step, k = n_check, 0
        while True:
            with spans.span("train.step", step=step) as sp:
                sp["loss"] = one_step(step)
            if not math.isfinite(sp["loss"]):
                run.failed += 1
            k += 1
            if save_at and k == save_at:
                sd = params.state_dict()
                saved = {**{("[0]", n): t.clone() for n, t in sd.items()},
                         **{("[1].m", n): t.clone() for n, t in opt_state.m.items()},
                         **{("[1].v", n): t.clone() for n, t in opt_state.v.items()},
                         ("[1].count", ""): opt_state.count.clone()}
                saved_step = step
                with spans.span("ckpt.save"):
                    mgr.save(step, (sd, opt_state), sync=False)
            step += 1
            if now() - t0 >= run.seconds and (not save_at or k >= save_at):
                break
        if mgr is not None:
            with spans.span("ckpt.wait"):
                mgr.wait()
        t1 = now()
        run.attempted = k
        log(run, f"window closed: {k} steps in {t1 - t0:.3f} s")
        stats = rt.stats()
        if mgr is not None:
            manifest, by_key = read_checkpoint(ckpt_dir() / f"step_{saved_step:08d}")
            run.counters["ckpt.save_seconds"] = manifest["save_seconds"]
            ws = stats.get("wait_states")
            if ws is not None:
                run.counters["io.bandwidth_wait_s"] = sum(
                    s.get("bandwidth", 0.0) for sig, s in ws["by_signature"].items()
                    if "_write_shard_task" in sig)
        if dev.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

        window = t1 - t0
        run.e2e["train_tok_s"] = k * B * S / window
        run.e2e["setup_s"] = run.window_start - run.process_start
        if mgr is not None:
            _mark_inflight(spans, manifest["save_seconds"])
        st = sorted(sp["t1"] - sp["t0"] for sp in spans.of("train.step"))
        log(run, f"steps: median {st[len(st) // 2]:.4f} s, min {st[0]:.4f}, max {st[-1]:.4f}; "
            + ", ".join(f"{n} {sp['t1'] - sp['t0']:.4f} s" for n in ("ckpt.save", "ckpt.wait")
                        for sp in spans.of(n))
            + (f", save_seconds {manifest['save_seconds']:.4f}" if mgr is not None else ""))

        # the traced region: more steps of the same loop, after the window
        if run.traced:
            traces = []
            with profiled(torch, traces):
                for _ in range(tr["trace_steps"]):
                    with torch.profiler.record_function(f"bench.train_step:{B}x{S}"):
                        one_step(step)
                    step += 1
            run.trace = traces[0]
            log(run, "traced region read")
    del params, opt_state, model, loader
    _free(torch, dev)

    # the check, once the window has closed and the program's state is freed
    if mgr is not None:
        bad = mismatches(saved, by_key) + ([] if manifest["step"] == saved_step else ["step"])
        run.readings["ckpt_leaves_differing"] = float(len(bad))
        del saved, by_key
        shutil.rmtree(ckpt_dir(), ignore_errors=True)
    ref = reference(c, tr, run.seed, dev)
    run.readings.update(compare(losses, g1, change, ref))
    log(run, f"checked: reference losses {ref['losses']}")


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(torch, dev):
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _norms(tree: dict) -> dict:
    """{name: float 2-norm} of a dict of tensors, read back in one transfer."""
    import torch
    names = list(tree)
    vals = torch.stack([torch.linalg.vector_norm(tree[n].float()) for n in names])
    return dict(zip(names, vals.tolist()))


def _mark_inflight(spans, save_seconds):
    """Flag the steps that ran while the save was in flight: from the start of
    ``save`` to the manifest's commit, ``save_seconds`` after the host copy
    (bounded by the end of ``wait``)."""
    save, wait = spans.of("ckpt.save")[0], spans.of("ckpt.wait")[0]
    s0, s1 = save["t0"], min(save["t1"] + save_seconds, wait["t1"])
    for sp in spans.of("train.step"):
        sp["inflight"] = sp["t1"] > s0 and sp["t0"] < s1


def batches(c, tr, seed, steps, device):
    import torch
    corpus = SyntheticCorpus(c["vocab_size"], tr["seq"], tr["batch"], seed)
    out = []
    for s in range(steps):
        b = corpus.batch(s)
        out.append({k: torch.from_numpy(v).to(device) for k, v in b.items()})
    return out


def reference(c, tr, seed, device, quant=None, rows=None):
    """The plain reference's first ``check_steps`` steps from the same
    weights and batches: losses, the first step's clipped gradient norms,
    the change after the last step, and the reference's own first
    gradient norms (which leaves move by round-off alone)."""
    import torch
    mod = model_module(c)
    W = mod.make_weights(c, seed, device)
    stored = {k: w.clone() for k, w in W.items()}
    del W
    o, state = tr["optimizer"], {"m": {}, "v": {}}
    losses, g1 = [], None
    for i, b in enumerate(batches(c, tr, seed, tr["check_steps"], device)):
        W32 = {k: w.float().requires_grad_() for k, w in stored.items()}
        loss, grads = mod.loss_and_grads(W32, b, c, quant=quant, rows=rows)
        del W32
        losses.append(loss)
        clipped = ref_adamw.step(stored, grads, state, o, i + 1)
        if i == 0:
            g1 = _norms(clipped)
        del grads, clipped
    W0 = mod.make_weights(c, seed, device)
    change = _norms({k: stored[k].float() - W0[k].float() for k in stored})
    del W0, stored, state
    _free(torch, torch.device(device))
    return {"losses": losses, "g1": g1, "change": change}


def compare(losses, g1, change, ref) -> dict:
    """The numbers the check compares: the largest relative gap of a step's
    loss; by the worst leaf, the gap between the program's and the
    reference's first-gradient norms and change norms, each against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger. Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and are left out of the change."""
    from ..lib.stats import median
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))}
    gmed = median(list(ref["g1"].values()))
    out["grad_gap"] = max(abs(g1[k] - r) / max(r, gmed) for k, r in ref["g1"].items())
    moving = [k for k in ref["change"] if ref["g1"][k] >= 1e-3 * gmed]
    cmed = median([ref["change"][k] for k in moving])
    out["change_gap"] = max(abs(change[k] - ref["change"][k]) / max(ref["change"][k], cmed)
                            for k in moving)
    return out

