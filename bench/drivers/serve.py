"""Serving cells: waves of requests through the port's ``Model.prefill`` and
``Model.decode_step``, greedy, in a closed loop copied from
``repro_torch.launch.serve.serve``: a wave of ``batch`` requests of one
prompt length is admitted when the one before it has finished, prefilled,
and decoded one token a step, each step's tokens read back to the host.

The traffic file gives the batch, the new tokens a request, and the
prompt lengths: ``fixed``, or ``log_uniform`` over [lo, hi] rounded to a
multiple, drawn stratified: every cycle of ``strata`` waves takes the
``strata`` evenly spaced points (in log) of the distribution once each,
in an order drawn from ``order_seed``, so that every seed serves the same
lengths in the same order. Prompt tokens are uniform over the
vocabulary, drawn from the seed.

Set-up makes the weights on the device from the seed and warms up every
prompt length of the traffic at its batch, and a few decode steps. The
window closes at ``--seconds``: a wave in flight then stops after the
step that crossed it, and the tokens made inside count. Where no wave
finished inside the window, the one in flight is finished after it, not
timed, so that there is always something to check. Afterwards a sample of
the finished requests, drawn from the seed with the longest
among them, goes through the plain reference, which reads the served
tokens only to judge them.
"""
from __future__ import annotations

import math

import numpy as np

from ..lib.harness import log, model_module, now
from ..lib.stats import percentile
from ..lib.trace import profiled, warm_profiler

#: wave numbers of the prompts that set-up and the traced region use, apart
#: from the window's
WARM, TRACED = 10**9, 2 * 10**9


def lengths(tr: dict) -> list[int]:
    """The distinct prompt lengths of the traffic, in increasing order."""
    p = tr["prompt_len"]
    if "fixed" in p:
        return [p["fixed"]]
    lo, hi = p["log_uniform"]
    k, mult = p["strata"], p["multiple"]
    pts = [lo * (hi / lo) ** (i / (k - 1)) for i in range(k)]
    return sorted({max(mult, int(round(x / mult)) * mult) for x in pts})


def wave_lengths(tr: dict):
    """The prompt length of every wave, in order: cycles of the traffic's
    lengths, each cycle in an order drawn from the traffic's ``order_seed``,
    the same for every ``--seed``: a window then serves the same lengths
    whatever the seed, which draws the prompts' tokens."""
    ls = lengths(tr)
    cycle = 0
    while True:
        rng = np.random.default_rng(np.random.SeedSequence(
            [tr["prompt_len"].get("order_seed", 0), 1, cycle]))
        yield from (ls[i] for i in rng.permutation(len(ls)))
        cycle += 1


def prompts(c: dict, tr: dict, seed: int, wave: int, length: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2, wave]))
    return rng.integers(0, c["vocab_size"], size=(tr["batch"], length), dtype=np.int32)


def run(run):
    import torch
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import Model
    from repro_torch.models.model import model_class

    c, tr, dev = run.c, run.tr, torch.device(run.device)
    mod = model_module(c)
    cfg = mod.port_config(c, ModelConfig)
    model = Model(cfg)
    V, B, new = mod.logits_width(c), tr["batch"], tr["max_new"]

    W = mod.make_weights(c, run.seed, dev)
    params = model_class(cfg)(cfg, dev, None)
    params.load_state_dict(W)
    del W
    log(run, f"weights made and loaded: {cfg.name}")

    def prefill(toks, length):
        logits, state = model.prefill(params, {"tokens": toks}, length + new)
        nxt = logits[:, :V].argmax(-1)
        return nxt, state, nxt.tolist()

    def decode(state, nxt):
        logits, state = model.decode_step(params, state, nxt)
        nxt = logits[:, :V].argmax(-1)
        return nxt, state, nxt.tolist()

    # set-up: every prompt length at the traffic's batch, longest first
    for length in sorted(lengths(tr), reverse=True):
        toks = torch.from_numpy(prompts(c, tr, run.seed, WARM + length, length)).to(dev)
        nxt, state, _ = prefill(toks, length)
        for _ in range(2):
            nxt, state, _ = decode(state, nxt)
        del state
    if run.traced and dev.type == "cuda":
        warm_profiler(torch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log(run, f"warmed up: prompt lengths {lengths(tr)} at batch {B}")

    # the window
    spans, waves = run.spans, []
    order = wave_lengths(tr)
    run.window_start = t0 = now()
    w = 0
    while now() - t0 < run.seconds:
        length = next(order)
        p = prompts(c, tr, run.seed, w, length)
        admit = now()
        with spans.span("serve.prefill", batch=B, length=length):
            nxt, state, ids = prefill(torch.from_numpy(p).to(dev), length)
        out, times = [ids], [now()]
        while len(out) < new and now() - t0 < run.seconds:
            with spans.span("serve.decode", batch=B):
                nxt, state, ids = decode(state, nxt)
            out.append(ids)
            times.append(now())
        waves.append({"wave": w, "length": length, "prompts": p, "admit": admit,
                      "times": times, "tokens": np.array(out, dtype=np.int64).T})
        w += 1
    t1 = now()
    if not any(len(x["times"]) == new for x in waves):
        # nothing finished in the window: finish the wave in flight, untimed
        x = waves[-1]
        while x["tokens"].shape[1] < new:
            nxt, state, ids = decode(state, nxt)
            x["tokens"] = np.concatenate([x["tokens"], np.array(ids)[:, None]], axis=1)
    del state, nxt
    steps = sorted(sp["t1"] - sp["t0"] for sp in spans.of("serve.decode"))
    log(run, f"window closed: {len(waves)} waves in {t1 - t0:.3f} s; prefills "
        + ", ".join(f"{sp['length']}: {sp['t1'] - sp['t0']:.4f}" for sp in spans.of("serve.prefill"))
        + (f"; decode steps median {steps[len(steps) // 2]:.4f} s, max {steps[-1]:.4f}"
           if steps else ""))
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    run.attempted = len(waves) * B
    n_tok = sum(len(x["times"]) * B for x in waves)
    run.e2e["serve_tok_s"] = n_tok / (t1 - t0)
    run.e2e["ttft_p95_s"] = percentile([x["times"][0] - x["admit"] for x in waves], 95)
    gaps = [b - a for x in waves for a, b in zip(x["times"], x["times"][1:])]
    if gaps:
        run.e2e["itl_p95_ms"] = percentile(gaps, 95) * 1e3
    run.e2e["setup_s"] = run.window_start - run.process_start

    # the traced region, after the window: one wave of every prompt length,
    # or of the one length with ``decode_steps`` of its decode steps
    if run.traced:
        traces = []
        n_decode = tr.get("trace", {}).get("decode_steps") or new - 1
        with profiled(torch, traces):
            for i, length in enumerate(lengths(tr)):
                toks = torch.from_numpy(prompts(c, tr, run.seed, TRACED + i, length)).to(dev)
                with torch.profiler.record_function(f"bench.prefill:{B}x{length}"):
                    nxt, state, _ = prefill(toks, length)
                for _ in range(n_decode):
                    with torch.profiler.record_function(f"bench.decode:{B}"):
                        nxt, state, _ = decode(state, nxt)
                del state
        run.trace = traces[0]
        log(run, "traced region read")
    del params, model
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run.finished = [x for x in waves if x["tokens"].shape[1] == new]
    run.readings["token_gap"] = check(run, mod, run.finished, dev)
    log(run, "checked")


def sample(finished: list, tr: dict, seed: int) -> list[tuple[dict, list[int]]]:
    """[(wave, its rows)] to check: the longest finished wave first, then rows
    drawn from the seed over every finished request until ``check_tokens``
    prompt and served tokens are taken."""
    if not finished:
        return []
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    budget = tr["check_tokens"]
    pool = [(i, r) for i, x in enumerate(finished) for r in range(x["tokens"].shape[0])]
    longest = max(range(len(finished)), key=lambda i: finished[i]["length"])
    picks = [(longest, int(rng.integers(finished[longest]["tokens"].shape[0])))]
    for j in rng.permutation(len(pool)):
        i, r = pool[j]
        if (i, r) in picks:
            continue
        if sum(finished[a]["length"] + finished[a]["tokens"].shape[1] for a, _ in picks) \
                + finished[i]["length"] + finished[i]["tokens"].shape[1] > budget:
            continue
        picks.append((i, r))
    by: dict = {}
    for i, r in picks:
        by.setdefault(i, []).append(r)
    return [(finished[i], sorted(rows)) for i, rows in sorted(by.items())]


def reference_logits(run, mod, finished, dev, quant=None):
    """[(served tokens (b, n), reference logits (b, n, V))] of the sample."""
    import torch
    W = mod.make_weights(run.c, run.seed, dev)
    out = []
    with torch.no_grad():
        for x, rows in sample(finished, run.tr, run.seed):
            p = torch.from_numpy(x["prompts"][rows]).to(dev)
            s = torch.from_numpy(x["tokens"][rows]).to(dev)
            lg = mod.served_logits(lambda n: W[n].float(), p, s, run.c, quant)
            out.append((s, lg))
    return out


def gaps_of(served, logits):
    """Largest amount by which a served token's logit lies under the best."""
    best = logits.max(-1).values
    got = logits.gather(-1, served[..., None])[..., 0]
    return float((best - got).max())


def check(run, mod, finished, dev) -> float:
    """The widest gap over the sample by which a served token's reference
    logit lies under the reference's best; inf where nothing finished."""
    run.reference_pairs = pairs = reference_logits(run, mod, finished, dev)
    return max((gaps_of(s, lg) for s, lg in pairs), default=math.inf)
