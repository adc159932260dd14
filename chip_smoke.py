"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit (nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the serving path from the checkout's sources;
  3. each kernel against its plain PyTorch version on the card, at the test
     cases and at the shape the serving path gives it, with its time, the
     plain version's, a PyTorch library call's (a yardstick only) and its
     bound (the least time the card could take for the same work);
  4. full-width tinyllama-1.1b prefill at fp32, flash kernel against the
     dense path on the same seeded weights and prompt;
  5. the main path: ``serve`` on full-width tinyllama-1.1b in bf16 with the
     flash kernel, 8 requests of 1024 prompt tokens + 64 new tokens, with
     the kernels' launch counts set to 0 just before and read just after;
  6. one JSON line of kernel numbers, then the result line.

Exits non-zero, printing no result, without CUDA or outside a checkout.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet, dense): memory rate,
# and the operation rate by input type (fp32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# (B, S, H, KV, hd, causal, window): tests/test_torch_flash.py's cases, then
# the shape of one serving prefill of tinyllama-1.1b (batch 4, 1024 tokens)
FLASH_CASES = [
    (1, 128, 4, 4, 64, True, 0),
    (2, 256, 8, 2, 64, True, 0),
    (1, 256, 4, 4, 32, False, 0),
    (2, 128, 4, 2, 64, True, 32),
    (1, 512, 2, 1, 128, True, 128),
    (1, 100, 4, 2, 64, True, 0),
    (2, 100, 4, 4, 32, False, 16),
]
SLICE_CASE = (4, 1024, 32, 4, 64, True, 0)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# full-width fp32 prefill, flash vs dense: both sum in fp32, in different
# orders (online softmax over 64-key tiles vs one softmax over the row);
# 22 random-weight layers carry those ~1e-7 relative differences into
# logits of order 1, so agreement is asked to 1e-3 of the largest logit
PREFILL_RTOL = 1e-3

SERVE = dict(n_requests=8, batch=4, prompt_len=1024, max_new=64)


def cuda_ms(torch, fn, reps=20, warmup=3):
    """Median over CUDA events of one call of ``fn``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flash_bound(torch, case, dtype):
    """(ms, "bytes" | "operations"): the larger of the traffic (q, k, v
    read once, o written once) over the memory rate and the work of the
    valid (q, k) pairs of this mask (2 products of 2*hd FLOPs each) over
    the peak rate for the input type."""
    B, S, H, KV, hd, causal, window = case
    qp, kp = torch.arange(S)[:, None], torch.arange(S)[None, :]
    mask = (kp <= qp) if causal else torch.ones((S, S), dtype=torch.bool)
    if window:
        mask = mask & (kp > qp - window)
    flops = 4 * hd * int(mask.sum()) * B * H
    nbytes = B * S * (2 * H + 2 * KV) * hd * (2 if dtype == "bfloat16" else 4)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def build_all(kernels):
    """Build every kernel's source afresh, one nvcc each, all at once."""
    from repro_torch.kernels import build
    for k in kernels:
        build.library_path(k["path"]).unlink(missing_ok=True)
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(kernels)) as ex:
        logs = [log for _, log in ex.map(lambda k: build.build(k["path"], verbose=True),
                                          kernels)]
    for log in logs:
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {line.strip()}")
    return time.monotonic() - t0


def check_flash(torch, ops, attention_ref, case, dtype, seed=0):
    B, S, H, KV, hd, causal, window = case
    F = torch.nn.functional
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(dt)
    k = torch.randn((B, S, KV, hd), generator=g, device="cuda").to(dt)
    v = torch.randn((B, S, KV, hd), generator=g, device="cuda").to(dt)
    out = ops.flash_attention(q, k, v, causal, window)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[dtype]
    bad = (out.float() - ref.float()).abs() > tol + tol * ref.float().abs()
    if bad.any() or not torch.isfinite(out).all():
        raise AssertionError(f"flash {case} {dtype}: max |err| {err:.3g} over "
                             f"tolerance {tol}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window:
        qp = torch.arange(S, device="cuda")[:, None]
        kp = torch.arange(S, device="cuda")[None, :]
        m = ((kp <= qp) if causal else torch.ones_like(kp <= qp)) & (kp > qp - window)
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m,
                                                     enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                     enable_gqa=True)
    bound_ms, bound_by = flash_bound(torch, case, dtype)
    row = {"max_abs_err": err,
           "ms": cuda_ms(torch, lambda: ops.flash_attention(q, k, v, causal, window)),
           "plain_ms": cuda_ms(torch, lambda: attention_ref(q, k, v, causal=causal,
                                                            window=window)),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": cuda_ms(torch, lib)}
    print(f"[flash] B,S,H,KV,hd,causal,window={case} {dtype}: max|err| {err:.3g} "
          f"(tol {tol}); kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"sdpa {row['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / row['ms']:.1f}% of bound")
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import attention_ref, ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import Model

    kernels = [{"name": "flash_attention_fwd", "route": "cuda", "path": ops.SOURCE,
                "replaces": "src/repro/kernels/flash_attention/kernel.py:30",
                "counter": ops.flash_attention}]

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build
    print(f"[build] {len(kernels)} kernel(s) built in {build_all(kernels):.1f} s")

    # 3. kernels against their plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for case in FLASH_CASES:
        for dtype in ("float32", "bfloat16"):
            check_flash(torch, ops, attention_ref, case, dtype)
    check_flash(torch, ops, attention_ref, SLICE_CASE, "float32")
    # each kernel's numbers at the main path's shape, for the kernels line
    rows = {"flash_attention_fwd": check_flash(torch, ops, attention_ref,
                                               SLICE_CASE, "bfloat16")}

    # 4. full-width fp32 prefill: flash kernel vs dense path
    cfg32 = get_config("tinyllama-1.1b").replace(dtype=torch.float32)
    params = Model(cfg32).init(0, device="cuda")
    prompt = np.random.default_rng(0).integers(0, cfg32.vocab_size, size=(1, 1024))
    batch = {"tokens": torch.from_numpy(prompt).cuda()}
    n0 = ops.flash_attention.launches
    lf, _ = Model(cfg32.replace(use_flash=True)).prefill(params, batch, 1024)
    n_flash = ops.flash_attention.launches - n0
    ld, _ = Model(cfg32.replace(use_flash=False)).prefill(params, batch, 1024)
    torch.cuda.synchronize()
    diff = (lf - ld).abs().max().item()
    scale = ld.abs().max().item()
    print(f"[prefill] tinyllama-1.1b fp32 B=1 S=1024: flash vs dense max|diff| "
          f"{diff:.3g}, max|logit| {scale:.3g}, flash launches {n_flash}")
    if n_flash != cfg32.n_layers:
        raise AssertionError(f"prefill launched the flash kernel {n_flash} times, "
                             f"expected {cfg32.n_layers}")
    if not (torch.isfinite(lf).all() and diff <= PREFILL_RTOL * scale):
        raise AssertionError(f"flash and dense prefill disagree: {diff:.3g} > "
                             f"{PREFILL_RTOL} * {scale:.3g}")
    del params, lf, ld
    torch.cuda.empty_cache()

    # 5. the main path: serve, with every launch count set to 0 around it
    cfg = get_config("tinyllama-1.1b").replace(use_flash=True)
    trace = ROOT / "build" / "chip_smoke" / "serve_trace.jsonl"
    trace.parent.mkdir(parents=True, exist_ok=True)
    trace.unlink(missing_ok=True)
    finite = []   # on the device: is every logits tensor serve sees finite

    class Checked(Model):
        def prefill(self, *a, **kw):
            logits, state = super().prefill(*a, **kw)
            finite.append(torch.isfinite(logits).all())
            return logits, state

        def decode_step(self, *a, **kw):
            logits, state = super().decode_step(*a, **kw)
            finite.append(torch.isfinite(logits).all())
            return logits, state

    serve_mod.Model = Checked
    torch.cuda.reset_peak_memory_stats()
    try:
        for k in kernels:
            k["counter"].launches = 0
        out = serve_mod.serve(cfg, trace_path=str(trace), device="cuda", **SERVE)
        torch.cuda.synchronize()
        launches = {k["name"]: k["counter"].launches for k in kernels}
    finally:
        serve_mod.Model = Model
    peak = torch.cuda.max_memory_allocated()
    waves = -(-SERVE["n_requests"] // SERVE["batch"])
    trace_rows = trace.read_text().splitlines()
    print(f"[serve] tinyllama-1.1b bf16 flash: {out['requests']} requests, "
          f"{out['new_tokens']} new tokens, {out['tokens_per_s']:.2f} tok/s, "
          f"wall {out['wall_s']:.3f} s, p50 {out['p50_s']:.4f} s, "
          f"p99 {out['p99_s']:.4f} s, peak memory {peak / 2**30:.3f} GiB, "
          f"launches {launches}, trace rows {len(trace_rows)}")
    expect = waves * cfg.n_layers
    if launches["flash_attention_fwd"] != expect:
        raise AssertionError(f"serve launched the flash kernel "
                             f"{launches['flash_attention_fwd']} times, expected {expect}")
    if not finite or not torch.stack(finite).all():
        raise AssertionError("serve produced non-finite logits")
    if out["requests"] != SERVE["n_requests"] or len(trace_rows) != SERVE["n_requests"]:
        raise AssertionError(f"{out['requests']} completions, {len(trace_rows)} trace rows")
    if any(len(c["tokens"]) != SERVE["max_new"] or
           not all(0 <= t < cfg.vocab_size for t in c["tokens"])
           for c in out["completions"]):
        raise AssertionError("a completion has the wrong length or a token "
                             "outside the vocabulary")

    # 6. kernel numbers, then the result line
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": k["route"],
         "source": str(Path(k["path"]).relative_to(ROOT)),
         "replaces": k["replaces"], "launches": launches[k["name"]], **rows[k["name"]]}
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
