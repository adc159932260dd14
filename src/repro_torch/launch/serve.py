"""Batched serving driver: prefill a wave of requests, decode the wave one
token per step (greedy), retire it, measure tokens/s. Request spans and
trace dumps run through the I/O-aware runtime (the trace appends are I/O
tasks overlapping the decode compute). Mirror of ``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --full --prompt-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --full --prompt-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --full --prompt-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config, get_smoke_config
from ..core import Cluster, IORuntime, RealBackend, StorageDevice, WorkerNode, io, task
from ..device import resolve_device
from ..models import Model
from ..obs.report import percentile, span_latencies


@io
@task(returns=1)
def _dump_trace(path, record, prev=None):
    # `prev` is the previous dump's future: chaining it serializes appends
    # to the shared trace file (unordered writers on one path is exactly
    # lint diagnostic IO301 — and a real interleaving hazard on the
    # RealBackend's I/O thread pool)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
    return path


def serve(cfg, *, n_requests=8, prompt_len=32, max_new=16, batch=4,
          trace_path=None, seed=0, device=None, params=None):
    """Feeds token prompts, as the reference's ``serve`` does: the encoder
    (hubert) and VLM (llava) families run through ``Model`` instead.
    ``params``: the model for ``cfg.family`` (a ``Transformer``, an
    ``SSM`` for mamba2, a ``Zamba2`` for zamba2), for example converted from
    JAX; by default the port's own init from ``seed``. For the SSM and
    hybrid families ``prompt_len`` must be a multiple of ``cfg.ssm_chunk``,
    as in the reference: the prefill raises ``ValueError`` otherwise. The
    hybrid family's prefill keeps the reference's quirk: its decode starts
    from an empty state (``models.model.hybrid_prefill``)."""
    device = resolve_device(device)
    model = Model(cfg)
    if params is None:
        params = model.init(seed, device=device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len).astype(np.int32)
               for _ in range(n_requests)]
    V = cfg.vocab_size

    dev = StorageDevice(name="trace-fs", bandwidth=500, per_stream_cap=125)
    cluster = Cluster(workers=[WorkerNode(name="h0", cpus=2, io_executors=4,
                                          storage=dev)])
    done, t0 = [], time.monotonic()
    new_tokens = 0
    trace_tok = None
    lat = []
    with IORuntime(cluster, backend=RealBackend(), trace=True) as rt:
        rec = rt.trace()  # None under the lint CLI's capture mode
        now = rec.now if rec is not None else (lambda: time.monotonic() - t0)
        queue = list(enumerate(prompts))
        while queue:
            wave, queue = queue[:batch], queue[batch:]
            admit = {rid: now() for rid, _ in wave}
            toks = torch.from_numpy(np.stack([p for _, p in wave])).to(device)
            logits, state = model.prefill(params, {"tokens": toks},
                                          prompt_len + max_new)
            out = [[] for _ in wave]
            nxt = logits[:, :V].argmax(-1)
            first_tok = {}
            for _ in range(max_new):
                ids = nxt.tolist()       # one device sync per step
                for i, (rid, _) in enumerate(wave):
                    out[i].append(ids[i])
                    if rid not in first_tok:
                        first_tok[rid] = now()
                logits, state = model.decode_step(params, state, nxt)
                nxt = logits[:, :V].argmax(-1)
                new_tokens += len(wave)
            for (rid, _), o in zip(wave, out):
                t_end = now()
                lat.append(t_end - admit[rid])
                row = {"request": rid, "tokens": o,
                       "t": time.monotonic() - t0}
                done.append(row)
                if rec is not None:
                    # admission -> first-token -> finish span; the span
                    # event *is* the JSONL trace row, so the dumped file
                    # and the recorder's stream stay one schema
                    row = rec.span(
                        f"req-{rid}", cat="request", t0=admit[rid],
                        t1=t_end, request=rid, n_tokens=len(o),
                        first_token_s=first_tok[rid] - admit[rid])
                if trace_path:
                    trace_tok = _dump_trace(trace_path, row, trace_tok)
        if rec is not None:
            lat = span_latencies(rec, cat="request")
    wall = time.monotonic() - t0
    return {"requests": len(done), "new_tokens": new_tokens,
            "tokens_per_s": new_tokens / wall, "wall_s": wall,
            "p50_s": percentile(lat, 0.50), "p99_s": percentile(lat, 0.99),
            "completions": done}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    out = serve(cfg, n_requests=args.requests, prompt_len=args.prompt_len,
                max_new=args.max_new, batch=args.batch, trace_path=args.trace,
                device=args.device)
    print(f"[serve] {out['requests']} requests, {out['new_tokens']} tokens, "
          f"{out['tokens_per_s']:.1f} tok/s, wall {out['wall_s']:.1f}s, "
          f"latency p50 {out['p50_s']:.3f}s p99 {out['p99_s']:.3f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
