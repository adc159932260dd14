"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit (nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA source of the serving paths from the checkout (flash
     attention: the bf16/fp16 tensor-core kernel and the exact fp32 one;
     the SSD scan: the bf16 TF32 tensor-core kernel and the exact fp32
     one), one nvcc each, all at once, with ptxas's registers and spills;
  3. each kernel against its plain PyTorch version on the card, at the test
     cases (flash: every dtype route, and the tile-boundary cases; SSD:
     both routes, the bf16 one also against the CPU model of its TF32
     roundings) and at the shape the serving path gives it; at that shape
     its time (CUDA events around one call; then its device time alone,
     for the SSD scan also with L2 flushed before each call, and its host
     time a call), the plain version's, a PyTorch library call's where one
     computes the same function (a yardstick only) and its bound (the least
     time the card could take for the same work);
  4. full-width fp32 prefills on the same seeded weights and prompt:
     tinyllama-1.1b, flash kernel against the dense path; mamba2-2.7b, SSD
     kernel against the plain scan;
  5. the main paths, each with every kernel's launch count set to 0 just
     before and read just after: ``serve`` in bf16, 8 requests of 1024
     prompt tokens + 64 new tokens, on full-width tinyllama-1.1b through the
     flash kernel and on full-width mamba2-2.7b through the SSD kernel;
  6. gradients through the kernels: fp32, full width, 2 layers, 1024
     tokens; the loss and every parameter's gradient with the kernel flag on
     (the kernel forward, its autograd backward) and off (the plain path);
  7. the train path: ``train`` on full-width, full-depth tinyllama-1.1b in
     bf16 through the flash kernel, batch 4 x 1024 tokens: 4 I/O-aware
     steps with one asynchronous checkpoint under ``build/``, a bit-for-bit
     restore of it, a 2-step resume from it, and the ``--no-io-aware``
     baseline (4 steps, one synchronous checkpoint); fails if the disk
     cannot hold a checkpoint;
  8. ``train`` on full-width, full-depth mamba2-2.7b in bf16 through the SSD
     kernel, batch 4 x 1024 tokens, 2 steps, no checkpoint;
  9. one JSON line of train numbers, one of kernel numbers, then the result
     line.

Exits non-zero, printing no result, without CUDA or outside a checkout.
"""
from __future__ import annotations

import json
import math
import shutil
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
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

# (B, S, H, KV, hd, causal, window): tests/test_torch_flash.py's cases, its
# tile-boundary cases, then the shape of one serving prefill of
# tinyllama-1.1b (batch 4, 1024 tokens)
FLASH_CASES = [
    (1, 128, 4, 4, 64, True, 0),
    (2, 256, 8, 2, 64, True, 0),
    (1, 256, 4, 4, 32, False, 0),
    (2, 128, 4, 2, 64, True, 32),
    (1, 512, 2, 1, 128, True, 128),
    (1, 100, 4, 2, 64, True, 0),
    (2, 100, 4, 4, 32, False, 16),
]
BOUNDARY_CASES = [
    (1, 1, 8, 1, 64, True, 0),
    (1, 63, 8, 1, 32, True, 0),
    (1, 65, 8, 1, 128, True, 0),
    (2, 127, 8, 1, 64, True, 0),
    (1, 129, 8, 1, 64, True, 0),
    (1, 1000, 8, 1, 64, True, 0),
    (1, 300, 8, 1, 64, True, 100),
    (1, 129, 8, 1, 64, False, 0),
]
SLICE_CASE = (4, 1024, 32, 4, 64, True, 0)
FLASH_DTYPES = ("float32", "bfloat16", "float16")
# f32: the exact route, summation orders differ; bf16 / fp16: P and the
# output are rounded to the input type. fp16 keeps 3 more mantissa bits than
# bf16, so its rounding is 8x finer (one step is ~0.002 at outputs of 2-4,
# bf16's ~0.016): its tolerance lies between the two, so that a route which
# rounded anything to bf16 would fail it
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 5e-3}
# (b, nc, Q, H, P, N): tests/test_torch_ssd.py's cases (the reference's
# SSD_CASES and the mamba2 smoke config's shape), then the shape of one
# serving prefill of mamba2-2.7b (batch 4, 1024 tokens in chunks of 256)
SSD_CASES = [
    (1, 4, 32, 8, 32, 16),
    (2, 2, 64, 4, 16, 32),
    (1, 8, 16, 16, 64, 128),
    (1, 2, 128, 8, 64, 64),
    (4, 2, 8, 8, 16, 16),
]
SSD_SLICE_CASE = (4, 4, 256, 80, 64, 128)
# f32: summation orders differ; bf16: the reference's own tolerance, which
# also covers the kernel's fp32 add of D.x before its one cast. At the
# serving shape the sums run over 256 steps x 128 states with terms up to
# the size of the largest output, and two fp32 orders differ there by up to
# ~8e-6 of it (1.6e-3 against outputs up to 218 on the H100): in f32 that
# shape's absolute tolerance is 1e-4 of the largest |output|
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# bf16 route against its CPU model of the same roundings (ref.ssd_scan_tf32_ref)
# on the same inputs: |kernel - model| <= 1e-3 max|model| + 1e-2 |model|. The
# two differ where a tf32 truncation falls on the other side in one of them
# (a change of 2^-11 of a term, the terms up to the size of the largest
# output) and by a bf16 rounding of y (2^-8 of it); 5x tighter in relative
# terms than SSD_TOL, so a slip in a fragment layout or a mask shows even
# where it stays inside 5e-2
SSD_MODEL_TOL = (1e-3, 1e-2)
# full-width fp32 prefill, kernel vs plain path: both sum in fp32, in
# different orders (flash: online softmax over 64-key tiles vs one softmax
# over the row; SSD: 64-row tiles and a warp scan vs whole-chunk einsums and
# cumsum); 22 or 64 random-weight layers carry those ~1e-7 relative
# differences into the logits, so agreement is asked to 1e-3 of the largest
# logit
PREFILL_RTOL = 1e-3

SERVE = dict(n_requests=8, batch=4, prompt_len=1024, max_new=64)
# the train phases: batch 4 x 1024 tokens, the serving prompt, so that each
# kernel runs at the shape phase 3 times
TRAIN = dict(batch=4, seq=1024)
# fp32, kernel vs plain path: the forwards differ by summation order (~1e-7
# relative), the backwards are the same recompute of the plain version, so
# every gradient leaf agrees within 1e-3 of its largest |g|
GRAD_RTOL = 1e-3


def cuda_ms(torch, fn, reps=20, warmup=3):
    """Median over CUDA events of one call of ``fn``: the device's time and
    whatever of the host's enqueue the device waits for, as a caller that
    launches the call and waits on it sees it."""
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


def device_ms(torch, fn, reps=20, warmup=3, before=None):
    """Median device time of one call of ``fn``: a spin kernel of ~1 ms
    ahead of the start event keeps the device busy while the host enqueues
    the call, so that the host's own time is not counted. ``before`` is
    enqueued after the spin, ahead of the start event (an L2 flush)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(torch, fn, reps=50, warmup=3):
    """Host time of one call of ``fn`` (its checks, the wrapper, the
    launch): the host clock over ``reps`` calls enqueued back to back, with
    no synchronisation between them, over ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def timings(torch, fn):
    """``fn``'s ms (CUDA events around one call), device ms and host ms."""
    return {"ms": cuda_ms(torch, fn), "device_ms": device_ms(torch, fn),
            "host_ms": host_ms(torch, fn)}


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
    nbytes = B * S * (2 * H + 2 * KV) * hd * (4 if dtype == "float32" else 2)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def ssd_bound(case, dtype):
    """(ms, "bytes" | "operations", fp32 CUDA-core ms): the larger of the
    traffic (x, dt, la, B, C, D read once, y and h_last written once) over
    the memory rate and the work over the peak rate for x's type. The work
    is C.B^T over the causal pairs once per (batch, chunk), and per head
    the intra-chunk product over the causal pairs, the inter-chunk product
    and the state update, 2 FLOPs a multiply-add."""
    b, nc, Q, H, P, N = case
    pairs = Q * (Q + 1) // 2
    flops = 2 * b * nc * (pairs * N + H * (pairs * P + 2 * Q * N * P))
    xb = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * nc * Q * H * P * xb + 4 * (2 * b * nc * Q * H + 2 * b * nc * Q * N
                                                 + H + b * H * N * P))
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, flops / PEAK_FLOPS["float32"] * 1e3


def build_all(sources):
    """Build every source afresh, one nvcc each, all at once; prints each
    kernel's registers and spills as ptxas reports them."""
    from repro_torch.kernels import build
    for src in sources:
        build.library_path(src).unlink(missing_ok=True)
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(sources)) as ex:
        logs = list(ex.map(lambda src: build.build(src, verbose=True)[1], sources))
    for src, log in zip(sources, logs):
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error",
                                       "warning", "Performance")):
                print(f"[build] {Path(src).name}: {line.strip()}")
    return time.monotonic() - t0


def check_flash(torch, ops, attention_ref, case, dtype, seed=0, timed=False):
    """The kernel of ``dtype``'s route against the plain version; with
    ``timed``, also its numbers for the kernels line."""
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
    if not timed:
        print(f"[flash] B,S,H,KV,hd,causal,window={case} {dtype}: max|err| {err:.3g} "
              f"(tol {tol})")
        return None
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
    kern = timings(torch, lambda: ops.flash_attention(q, k, v, causal, window))
    sdpa = timings(torch, lib)
    row = {"max_abs_err": err, "ms": kern["ms"],
           "plain_ms": cuda_ms(torch, lambda: attention_ref(q, k, v, causal=causal,
                                                            window=window)),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": sdpa["ms"],
           "device_ms": kern["device_ms"], "host_ms": kern["host_ms"]}
    print(f"[flash] B,S,H,KV,hd,causal,window={case} {dtype}: max|err| {err:.3g} "
          f"(tol {tol}); kernel {kern['ms']:.4f} ms (device {kern['device_ms']:.4f}, "
          f"host {kern['host_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
          f"sdpa {sdpa['ms']:.4f} ms (device {sdpa['device_ms']:.4f}, "
          f"host {sdpa['host_ms']:.4f}), bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / kern['ms']:.1f}% of bound, "
          f"{100 * bound_ms / kern['device_ms']:.1f}% by device time")
    return row


def check_flash_masked(torch, ops, dtype):
    """window=1, causal: each query sees only its own key, so every other key
    tile is masked for it and must add exactly 0; the own key's p is 1 (up
    to an fp32 rounding, exactly 1 in the input type) and l is p, so the
    output is that key's value row, exactly."""
    B, S, H, KV, hd = 2, 300, 8, 2, 64
    g = torch.Generator(device="cuda").manual_seed(1)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device="cuda").to(dt)
               for n in (H, KV, KV))
    out = ops.flash_attention(q, k, v, True, 1)
    want = v.repeat_interleave(H // KV, dim=2)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError(f"flash window=1 {dtype}: output is not the own value "
                             f"row, max |diff| {(out - want).abs().max().item():.3g}")
    print(f"[flash] window=1 {dtype}: every row is exactly its own value row")


def l2_flushed_ms(torch, fn):
    """``fn``'s device time with L2 emptied before each call: 128 MB (over
    twice the H100's 50 MB L2) written ahead of the start event."""
    junk = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    return device_ms(torch, fn, before=lambda: junk.fill_(1))


def check_ssd(torch, ops, ssd_scan_ref, case, dtype, seed=0, model=None):
    """The kernel of ``dtype``'s route against the plain version and, with
    ``model`` (bf16), against the CPU model of its roundings on the card;
    returns its numbers for the kernels line."""
    b, nc, Q, H, P, N = case
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    x = (randn(b, nc, Q, H, P) * 0.5).to(getattr(torch, dtype))
    dt = torch.nn.functional.softplus(randn(b, nc, Q, H))
    B, C = randn(b, nc, Q, N), randn(b, nc, Q, N)
    la = dt * -torch.exp(randn(H) * 0.2)
    D = 1 + 0.1 * randn(H)
    y, h = ops.ssd_scan(x, dt, B, C, la, D)
    ry, rh = ssd_scan_ref(x, dt, B, C, la, D)
    torch.cuda.synchronize()
    tol = SSD_TOL[dtype]
    err = 0.0
    for out, ref in ((y.float(), ry.float()), (h, rh)):
        err = max(err, (out - ref).abs().max().item())
        atol = tol * (ref.abs().max().item()
                      if case == SSD_SLICE_CASE and dtype == "float32" else 1.0)
        if ((out - ref).abs() > atol + tol * ref.abs()).any() or not torch.isfinite(out).all():
            raise AssertionError(f"ssd {case} {dtype}: max |err| {err:.3g} over "
                                 f"tolerance {atol:.3g} + {tol} |ref|")
    model_note = ""
    if model is not None:
        my, mh = model(x, dt, B, C, la, D)
        fracs = []
        for out, ref in ((y.float(), my.float()), (h, mh)):
            lim = SSD_MODEL_TOL[0] * ref.abs().max() + SSD_MODEL_TOL[1] * ref.abs()
            fracs.append(((out - ref).abs() / lim).max().item())
        model_note = (f"; against the tf32 model {max(fracs):.3g} of its tolerance "
                      f"{SSD_MODEL_TOL[0]} max + {SSD_MODEL_TOL[1]} |model|")
        if max(fracs) > 1:
            raise AssertionError(f"ssd {case} {dtype}: kernel and tf32 model differ by "
                                 f"{max(fracs):.3g} of their tolerance")
    bound_ms, bound_by, fp32_ms = ssd_bound(case, dtype)
    kern = timings(torch, lambda: ops.ssd_scan(x, dt, B, C, la, D))
    row = {"max_abs_err": err, "ms": kern["ms"],
           "plain_ms": cuda_ms(torch, lambda: ssd_scan_ref(x, dt, B, C, la, D)),
           "bound_ms": bound_ms, "bound_by": bound_by,
           # no single PyTorch call computes the SSD scan
           "library_ms": None,
           "device_ms": kern["device_ms"], "host_ms": kern["host_ms"]}
    if case == SSD_SLICE_CASE:
        row["device_l2_flushed_ms"] = l2_flushed_ms(torch, lambda: ops.ssd_scan(x, dt, B, C,
                                                                                  la, D))
    print(f"[ssd] b,nc,Q,H,P,N={case} {dtype}: max|err| {err:.3g} (tol {tol}){model_note}; "
          f"kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}, "
          f"host {row['host_ms']:.4f}"
          + (f", L2 flushed {row['device_l2_flushed_ms']:.4f}" if "device_l2_flushed_ms" in row
             else "")
          + f"), plain {row['plain_ms']:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / row['ms']:.2f}% "
          f"of bound; fp32 CUDA-core ceiling {fp32_ms:.4f} ms, "
          f"{100 * fp32_ms / row['ms']:.1f}% of it")
    return row


def check_prefill(torch, np, Model, cfg32, flag, counter):
    """Full-width fp32 prefill at B=1, S=1024 on one set of seeded weights,
    with ``flag`` on (through the kernel) and off (the plain path)."""
    params = Model(cfg32).init(0, device="cuda")
    prompt = np.random.default_rng(0).integers(0, cfg32.vocab_size, size=(1, 1024))
    batch = {"tokens": torch.from_numpy(prompt).cuda()}
    n0 = counter.launches
    lk, _ = Model(cfg32.replace(**{flag: True})).prefill(params, batch, 1024)
    n_kernel = counter.launches - n0
    lp, _ = Model(cfg32.replace(**{flag: False})).prefill(params, batch, 1024)
    torch.cuda.synchronize()
    diff = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    print(f"[prefill] {cfg32.name} fp32 B=1 S=1024: {flag} on vs off max|diff| "
          f"{diff:.3g}, max|logit| {scale:.3g}, relative {diff / scale:.3g} "
          f"(limit {PREFILL_RTOL}), kernel launches {n_kernel}")
    if n_kernel != cfg32.n_layers:
        raise AssertionError(f"prefill launched the kernel {n_kernel} times, "
                             f"expected {cfg32.n_layers}")
    if not (torch.isfinite(lk).all() and diff <= PREFILL_RTOL * scale):
        raise AssertionError(f"the {flag} prefills disagree: {diff:.3g} > "
                             f"{PREFILL_RTOL} * {scale:.3g}")
    del params, lk, lp
    torch.cuda.empty_cache()


def serve_path(torch, serve_mod, Model, cfg, kernels):
    """One main path: ``serve`` with every launch count set to 0 just before
    and read just after. Checks every logits tensor, the completions and
    the trace; returns the launch counts."""
    trace = ROOT / "build" / "chip_smoke" / f"serve_trace_{cfg.name}.jsonl"
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
    torch.cuda.empty_cache()
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
    trace_rows = trace.read_text().splitlines()
    print(f"[serve] {cfg.name} bf16: {out['requests']} requests, "
          f"{out['new_tokens']} new tokens, {out['tokens_per_s']:.2f} tok/s, "
          f"wall {out['wall_s']:.3f} s, p50 {out['p50_s']:.4f} s, "
          f"p99 {out['p99_s']:.4f} s, peak memory {peak / 2**30:.3f} GiB, "
          f"launches {launches}, trace rows {len(trace_rows)}")
    if not finite or not torch.stack(finite).all():
        raise AssertionError(f"{cfg.name}: serve produced non-finite logits")
    if out["requests"] != SERVE["n_requests"] or len(trace_rows) != SERVE["n_requests"]:
        raise AssertionError(f"{out['requests']} completions, {len(trace_rows)} trace rows")
    if any(len(c["tokens"]) != SERVE["max_new"] or
           not all(0 <= t < cfg.vocab_size for t in c["tokens"])
           for c in out["completions"]):
        raise AssertionError("a completion has the wrong length or a token "
                             "outside the vocabulary")
    return launches


def check_train_grads(torch, np, Model, cfg32, flag, counter):
    """Phase 6: fp32, full width, 2 layers, B=1 x 1024 tokens. The loss and
    every gradient leaf with ``flag`` on and off; no parameter without a
    gradient through the kernel; the kernel launched twice a layer (the
    forward, and its re-run under remat)."""
    cfg = cfg32.replace(n_layers=2)
    params = Model(cfg).init(0, device="cuda")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, 1024))).cuda()
             for k in ("tokens", "targets")}
    losses, grads, launches = [], [], []
    for on in (True, False):
        n0 = counter.launches
        loss = Model(cfg.replace(**{flag: on})).loss(params, batch)
        loss.backward()
        torch.cuda.synchronize()
        launches.append(counter.launches - n0)
        missing = [k for k, p in params.named_parameters() if p.grad is None]
        if missing:
            raise AssertionError(f"{cfg.name} {flag}={on}: no gradient for {missing}")
        grads.append({k: p.grad for k, p in params.named_parameters()})
        losses.append(loss.item())
        params.zero_grad(set_to_none=True)
    worst, worst_leaf = 0.0, None
    for k, g in grads[0].items():
        want = grads[1][k]
        frac = ((g - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()
        if not frac <= worst:
            worst, worst_leaf = frac, k
    print(f"[grads] {cfg.name} fp32 2 layers B=1 S=1024: loss {losses[0]:.6f} "
          f"({flag} on) vs {losses[1]:.6f} (off); {len(grads[0])} gradient leaves, "
          f"worst |diff| {worst:.3g} of its leaf's max |g| ({worst_leaf}; limit "
          f"{GRAD_RTOL}); kernel launches {launches[0]} on, {launches[1]} off")
    if launches != [2 * cfg.n_layers, 0]:
        raise AssertionError(f"launches {launches}, expected [{2 * cfg.n_layers}, 0]")
    if not (np.isfinite(losses).all() and abs(losses[0] - losses[1]) <= GRAD_RTOL * abs(losses[1])
            and worst <= GRAD_RTOL):
        raise AssertionError(f"{cfg.name}: kernel and plain gradients disagree: {worst:.3g} "
                             f"of a leaf's max ({worst_leaf}), losses {losses}")
    del params, grads
    torch.cuda.empty_cache()


def ckpt_bytes(cfg):
    """Bytes of one checkpoint of (params, AdamW state): the params in their
    dtypes and fp32 m and v, from a model on the meta device."""
    from repro_torch.models.model import SSM
    from repro_torch.models.transformer import Transformer
    m = (SSM if cfg.family == "ssm" else Transformer)(cfg, device="meta")
    return sum(p.numel() * (p.element_size() + 8) for p in m.parameters())


def train_run(torch, train_mod, cfg, kernels, name, **kw):
    """One run of ``train`` with every launch count set to 0 just before and
    read just after; checks finite losses and gnorms. Returns the result,
    the launches and its numbers: step time (median of the steps after the
    first, from the log's clock, which each step's loss and gnorm sync),
    tokens/s, peak memory, and per save the time ``save`` held the loop, the
    part of it spent copying to the host, the seconds from its start to the
    manifest's commit, the time ``wait`` held the loop at the end, and the
    overlap: the share of save-to-commit the loop spent elsewhere."""
    log = ROOT / "build" / "chip_smoke" / f"train_{name}.jsonl"
    log.parent.mkdir(parents=True, exist_ok=True)
    log.unlink(missing_ok=True)
    saves = []
    manager_mod = sys.modules[train_mod.CheckpointManager.__module__]
    to_host = manager_mod.to_host
    host_s = [0.0]

    def timed_to_host(leaf):
        t0 = time.monotonic()
        out = to_host(leaf)
        host_s[0] += time.monotonic() - t0
        return out

    class Timed(train_mod.CheckpointManager):
        def save(self, step, tree, sync=False):
            host_s[0] = 0.0
            t0 = time.monotonic()
            ok = super().save(step, tree, sync=sync)
            sv = {"step": step, "saved": ok, "save_call_s": time.monotonic() - t0,
                  "host_copy_s": host_s[0], "wait_s": 0.0}
            if ok and self._in_flight is not None:     # async: the commit's future
                sv["manifest"] = self._in_flight[1]    # resolves to the manifest
            elif ok:
                sv["manifest"] = json.loads(
                    (self.dir / f"step_{step:08d}" / "MANIFEST.json").read_text())
            saves.append(sv)
            return ok

        def wait(self):
            step = self._in_flight[0] if self._in_flight else None
            t0 = time.monotonic()
            super().wait()
            for sv in saves:
                if sv["step"] == step and sv["saved"]:
                    sv["wait_s"] = time.monotonic() - t0

    train_mod.CheckpointManager = Timed
    manager_mod.to_host = timed_to_host
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        for k in kernels:
            k["counter"].launches = 0
        out = train_mod.train(cfg, log_path=str(log), device="cuda", **TRAIN, **kw)
        torch.cuda.synchronize()
        launches = {k["name"]: k["counter"].launches for k in kernels}
    finally:
        train_mod.CheckpointManager = Timed.__mro__[1]
        manager_mod.to_host = to_host
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    steps = [r["t"] - p["t"] for p, r in zip(rows, rows[1:])]
    step_s = statistics.median(steps) if steps else rows[0]["t"]
    for sv in saves:
        if not sv["saved"]:       # skipped: the previous save was in flight
            continue
        manifest = sv.pop("manifest")
        manifest = manifest if isinstance(manifest, dict) else manifest.value()
        # save_seconds runs from after the host copy to the commit
        # (async: the host copy in the call, then the writes in the
        # background; sync: all of it in the call)
        sv["save_to_commit_s"] = sv["save_call_s"] + manifest["save_seconds"] \
            if kw["io_aware"] else sv["save_call_s"]
        sv["manifest_save_seconds"] = manifest["save_seconds"]
        # the share of save-to-commit the loop did not wait for, in save or
        # in the final wait (a save committed before it has none): 0 for a
        # synchronous save
        sv["overlap"] = (1 - (sv["save_call_s"] + sv["wait_s"]) / sv["save_to_commit_s"]
                         if kw["io_aware"] else 0.0)
    num = {"steps_run": out["steps_run"], "losses": out["losses"],
           "gnorms": [r["gnorm"] for r in rows], "step_s": step_s,
           "first_step_s": rows[0]["t"], "steps_s": steps,
           "tokens_per_s": TRAIN["batch"] * TRAIN["seq"] / step_s,
           "wall_s": out["wall_s"], "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "saves": saves, "launches": launches, "runtime_stats": out["runtime_stats"]}
    print(f"[train] {cfg.name} {name}: {out['steps_run']} steps, losses "
          f"{[round(x, 4) for x in out['losses']]}, gnorms "
          f"{[round(g, 4) for g in num['gnorms']]}, step {step_s:.4f} s (median of "
          f"{[round(x, 4) for x in steps]}; first {rows[0]['t']:.3f} s), "
          f"{num['tokens_per_s']:.1f} tok/s, wall {out['wall_s']:.3f} s, peak "
          f"{num['peak_gib']:.3f} GiB, launches {launches}, saves {saves}, "
          f"runtime {out['runtime_stats']}")
    if not all(map(math.isfinite, out["losses"] + num["gnorms"])):
        raise AssertionError(f"{cfg.name} {name}: a loss or gnorm is not finite")
    return out, launches, num


def train_dense(torch, train_mod, CheckpointManager, cfg, kernels):
    """Phase 7: I/O-aware run with one async checkpoint, restore check,
    resume, baseline. Returns (launches of the I/O-aware run, numbers)."""
    ck_root = ROOT / "build" / "chip_smoke" / "ckpt"
    shutil.rmtree(ck_root, ignore_errors=True)
    ck_root.mkdir(parents=True)
    need = ckpt_bytes(cfg)
    free = shutil.disk_usage(ck_root).free
    print(f"[disk] {free / 1e9:.2f} GB free under {ck_root.relative_to(ROOT)}; one "
          f"checkpoint of {cfg.name} (params + fp32 m, v) is {need / 1e9:.2f} GB")
    if free < need:
        raise AssertionError(f"{free / 1e9:.2f} GB free cannot hold a {need / 1e9:.2f} GB "
                             "checkpoint")
    per_step = cfg.n_layers * 2        # the forward, and its re-run under remat
    nums = {"checkpoint_gb": need / 1e9, "disk_free_gb": free / 1e9}

    def expect(launches, steps, what):
        want = {k["name"]: steps * per_step if k["name"] == "flash_attention_fwd" else 0
                for k in kernels}
        if launches != want:
            raise AssertionError(f"{cfg.name} {what} launched {launches}, expected {want}")

    d = ck_root / "io_aware"
    out, io_launches, nums["io_aware"] = train_run(
        torch, train_mod, cfg, kernels, "io_aware", steps=4, ckpt_dir=str(d), ckpt_every=4,
        io_aware=True, resume=False)
    expect(io_launches, 4, "the I/O-aware run")
    if CheckpointManager(d).steps() != [3]:
        raise AssertionError(f"checkpoint steps {CheckpointManager(d).steps()}, expected [3]")
    # the restore, bit for bit, against the state the run ended with (= saved)
    like = (out["params"].state_dict(), out["opt_state"])
    t0 = time.monotonic()
    (sd, opt), step = CheckpointManager(d).restore(like)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    checked: dict = {}
    for (key, want), (_, got) in zip(_leaves(like), _leaves((sd, opt))):
        if got.dtype != want.dtype or got.device != want.device or not torch.equal(got, want):
            raise AssertionError(f"restored {key} differs from the saved tensor")
        checked[str(want.dtype)] = checked.get(str(want.dtype), 0) + 1
    print(f"[restore] step {step} in {restore_s:.3f} s: every leaf equal bit for bit, "
          f"by dtype {checked}")
    nums["restore"] = {"step": step, "seconds": restore_s, "leaves_by_dtype": checked}
    del out, like, sd, opt
    torch.cuda.empty_cache()

    out, launches, nums["resume"] = train_run(
        torch, train_mod, cfg, kernels, "resume", steps=6, ckpt_dir=str(d), ckpt_every=4,
        io_aware=True, resume=True)
    if out["steps_run"] != 2:
        raise AssertionError(f"the resume ran {out['steps_run']} steps, expected 2")
    expect(launches, 2, "the resume")
    del out
    shutil.rmtree(d)

    d = ck_root / "baseline"
    out, launches, nums["baseline"] = train_run(
        torch, train_mod, cfg, kernels, "baseline", steps=4, ckpt_dir=str(d), ckpt_every=4,
        io_aware=False, resume=False)
    expect(launches, 4, "the baseline")
    if not (d / "step_00000003" / "MANIFEST.json").exists():
        raise AssertionError("the baseline wrote no step_00000003")
    del out
    shutil.rmtree(ck_root)
    torch.cuda.empty_cache()
    return io_launches, nums


def _leaves(tree):
    from repro_torch.checkpoint.serializer import flatten_with_paths
    for key, leaf in flatten_with_paths(tree):
        for i, t in enumerate(leaf if isinstance(leaf, list) else [leaf]):
            yield (f"{key}[{i}]" if isinstance(leaf, list) else key), t


def train_ssm(torch, train_mod, cfg, kernels):
    """Phase 8: 2 steps, no checkpoint; the SSD kernel twice a layer a step."""
    out, launches, nums = train_run(torch, train_mod, cfg, kernels, "ssm", steps=2,
                                    ckpt_dir=None, ckpt_every=0, io_aware=True)
    want = {k["name"]: 2 * cfg.n_layers * 2 if k["name"] == "ssd_scan_fwd" else 0
            for k in kernels}
    if launches != want or out["steps_run"] != 2:
        raise AssertionError(f"{cfg.name} train launched {launches} in {out['steps_run']} "
                             f"steps, expected {want} in 2")
    del out
    torch.cuda.empty_cache()
    return launches, nums


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import attention_ref, ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ssd_scan_ref, ssd_scan_tf32_ref
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import Model

    # the flash row's numbers are those of the bf16 route, the serving path's
    kernels = [{"name": "flash_attention_fwd", "route": "cuda",
                "path": ops.route(torch.bfloat16)[0],
                "replaces": "src/repro/kernels/flash_attention/kernel.py:30",
                "counter": ops.flash_attention},
               {"name": "ssd_scan_fwd", "route": "cuda",
                "path": ssd_ops.route(torch.bfloat16)[0],
                "replaces": "src/repro/kernels/ssd_scan/kernel.py:26",
                "counter": ssd_ops.ssd_scan}]

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build
    sources = [*ops.SOURCES, *ssd_ops.SOURCES]
    print(f"[build] {len(sources)} sources built in {build_all(sources):.1f} s")

    # 3. kernels against their plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for case in FLASH_CASES + BOUNDARY_CASES:
        for dtype in FLASH_DTYPES:
            check_flash(torch, ops, attention_ref, case, dtype)
    for dtype in ("bfloat16", "float16"):
        check_flash_masked(torch, ops, dtype)
    check_flash(torch, ops, attention_ref, SLICE_CASE, "float32", timed=True)
    check_flash(torch, ops, attention_ref, SLICE_CASE, "float16", timed=True)
    # each kernel's numbers at the main path's shape, for the kernels line
    rows = {"flash_attention_fwd": check_flash(torch, ops, attention_ref, SLICE_CASE,
                                               "bfloat16", timed=True)}
    # f32 through the exact route, bf16 through the tf32 tensor-core route
    for case in SSD_CASES:
        check_ssd(torch, ssd_ops, ssd_scan_ref, case, "float32")
        check_ssd(torch, ssd_ops, ssd_scan_ref, case, "bfloat16", model=ssd_scan_tf32_ref)
    check_ssd(torch, ssd_ops, ssd_scan_ref, SSD_SLICE_CASE, "float32")
    rows["ssd_scan_fwd"] = check_ssd(torch, ssd_ops, ssd_scan_ref, SSD_SLICE_CASE,
                                     "bfloat16", model=ssd_scan_tf32_ref)

    # 4. full-width fp32 prefills: each kernel against the plain path
    check_prefill(torch, np, Model, get_config("tinyllama-1.1b").replace(
        dtype=torch.float32), "use_flash", ops.flash_attention)
    check_prefill(torch, np, Model, get_config("mamba2-2.7b").replace(
        dtype=torch.float32), "use_ssd_kernel", ssd_ops.ssd_scan)

    # 5. the main paths: each kernel's launches on its own serving path
    waves = -(-SERVE["n_requests"] // SERVE["batch"])
    launches = {}
    for arch, flag, name in (("tinyllama-1.1b", "use_flash", "flash_attention_fwd"),
                             ("mamba2-2.7b", "use_ssd_kernel", "ssd_scan_fwd")):
        cfg = get_config(arch).replace(**{flag: True})
        got = serve_path(torch, serve_mod, Model, cfg, kernels)
        expect = {k["name"]: waves * cfg.n_layers if k["name"] == name else 0
                  for k in kernels}
        if got != expect:
            raise AssertionError(f"{arch} serve launched {got}, expected {expect}")
        launches[name] = got[name]

    # 6. gradients through each kernel against the plain path
    check_train_grads(torch, np, Model, get_config("tinyllama-1.1b").replace(
        dtype=torch.float32), "use_flash", ops.flash_attention)
    check_train_grads(torch, np, Model, get_config("mamba2-2.7b").replace(
        dtype=torch.float32), "use_ssd_kernel", ssd_ops.ssd_scan)

    # 7-8. the train paths: each kernel's launches on its own train path
    train_nums = {"card": smi}
    dense = get_config("tinyllama-1.1b").replace(use_flash=True)
    flash_train, train_nums[dense.name] = train_dense(torch, train_mod, CheckpointManager,
                                                      dense, kernels)
    ssm = get_config("mamba2-2.7b").replace(use_ssd_kernel=True)
    ssd_train, train_nums[ssm.name] = train_ssm(torch, train_mod, ssm, kernels)
    train_paths = {
        "flash_attention_fwd": (flash_train["flash_attention_fwd"],
                                "tinyllama-1.1b train, I/O-aware, 4 steps of 4 x 1024 tokens"),
        "ssd_scan_fwd": (ssd_train["ssd_scan_fwd"],
                         "mamba2-2.7b train, 2 steps of 4 x 1024 tokens")}

    # 9. train numbers, kernel numbers, then the result line
    print(json.dumps({"train": train_nums}))
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": k["route"],
         "source": str(Path(k["path"]).relative_to(ROOT)),
         "replaces": k["replaces"], "launches": launches[k["name"]], **rows[k["name"]],
         "train_launches": train_paths[k["name"]][0], "train_path": train_paths[k["name"]][1]}
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
