"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit (nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA source of the serving paths from the checkout (flash
     attention: the bf16/fp16 tensor-core kernel and the exact fp32 one;
     the SSD scan: the bf16 TF32 tensor-core kernel and the exact fp32
     one), one nvcc each, all at once, with ptxas's registers and spills;
  3. each kernel against its plain PyTorch version on the card, at the test
     cases (flash: every dtype route, the tile-boundary cases and head dim
     80; SSD: both routes, the bf16 one also against the CPU model of its
     TF32 roundings) and at the shapes the main paths give it
     (tinyllama-1.1b, zamba2-1.2b, qwen2-moe-a2.7b, llava-next-mistral-7b
     and hubert-xlarge (head dim 80, bidirectional, in every dtype route)
     for flash, mamba2-2.7b and zamba2-1.2b for the SSD scan); at those
     shapes its time (CUDA events around one call; then its device time
     alone, for the SSD scan also with L2 flushed before each call, and its
     host time a call), the plain version's, a PyTorch library call's where
     one computes the same function (a yardstick only) and its bound (the
     least time the card could take for the same work);
  4. full-width fp32 prefills on the same seeded weights and inputs, the
     kernels against the plain paths: tinyllama-1.1b (flash), mamba2-2.7b
     (SSD), zamba2-1.2b (full depth, both), qwen2-moe-a2.7b (depth cut 24
     -> 2; the tokens whose top-k experts differ between the two runs are
     counted), hubert-xlarge ``Model.encode`` (full depth, 1024 frames) and
     llava-next-mistral-7b (depth cut 32 -> 4, 1152 vision embeddings +
     1024 tokens); then one full-width qwen2-moe-a2.7b MoE layer in fp32
     on 1024 tokens on the card against the CPU (routing, output, aux) and
     twice on the card in bf16 (equal bit for bit: the combine is
     deterministic);
  5. the main paths, each with every kernel's launch count set to 0 just
     before and read just after: ``serve`` in bf16, 8 requests of 1024
     prompt tokens + 64 new tokens, on full-width tinyllama-1.1b through the
     flash kernel, on full-width mamba2-2.7b through the SSD kernel, on
     full-width zamba2-1.2b through both (the shared attention block at 7
     sites, 38 Mamba2 layers) and on full-width, full-depth qwen2-moe-a2.7b
     through flash; ``serve`` of 4 requests of 1024 + 16 tokens on
     full-width mixtral-8x22b cut to 2 layers (top-2 of 8 experts, G = 6,
     window 4096); ``Model.prefill`` of 4 x (1152 vision embeddings + 1024
     tokens) and 64 greedy ``decode_step``s on full-width
     llava-next-mistral-7b;
  6. gradients through the kernels: fp32, full width, 2 layers, 1024
     tokens; the loss and every parameter's gradient with the kernel flags
     on (the kernel forward, its autograd backward) and off (the plain
     path), for tinyllama-1.1b, mamba2-2.7b, zamba2-1.2b (both kernels),
     hubert-xlarge (head dim 80, bidirectional) and qwen2-moe-a2.7b (held
     to the tolerance where the routing of the two runs agrees);
  7. the train path: ``train`` on full-width, full-depth tinyllama-1.1b in
     bf16 through the flash kernel, batch 4 x 1024 tokens: 4 I/O-aware
     steps with one asynchronous checkpoint under ``build/``, a bit-for-bit
     restore of it, a 2-step resume from it, and the ``--no-io-aware``
     baseline (4 steps, one synchronous checkpoint); fails if the disk
     cannot hold a checkpoint;
  8. ``train`` on full-width, full-depth mamba2-2.7b in bf16 through the SSD
     kernel, batch 4 x 1024 tokens, 2 steps, no checkpoint;
  9. ``train`` on full-width, full-depth zamba2-1.2b in bf16 through both
     kernels, batch 4 x 1024 tokens, 2 steps, no checkpoint; ``train`` on
     full-width qwen2-moe-a2.7b cut to 6 layers through flash, 2 steps; 2
     steps of ``train_step`` (``Model.loss``, backward, AdamW) on
     full-width, full-depth hubert-xlarge on 4 x 1024 seeded frame
     embeddings;
 10. one JSON line of train numbers, one of kernel numbers, then the result
     line.

Exits non-zero, printing no result, without CUDA or outside a checkout.
"""
from __future__ import annotations

import contextlib
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
# head dim 80 (hubert-xlarge's): tests/test_torch_flash.py's HD80_CASES
HD80_CASES = [
    (1, 128, 4, 4, 80, True, 0),
    (2, 192, 4, 2, 80, False, 0),
    (1, 100, 4, 2, 80, True, 16),
    (1, 129, 8, 1, 80, True, 0),
]
SLICE_CASE = (4, 1024, 32, 4, 64, True, 0)
# zamba2-1.2b's shared attention block at batch 4 x 1024 tokens: 32 heads of
# 64 over a 2 x 2048-wide input, as many KV heads as query heads (G = 1)
ZAMBA_FLASH_CASE = (4, 1024, 32, 32, 64, True, 0)
# the later families' attention at batch 4 x 1024 tokens (llava: 1152 vision
# positions ahead of the 1024 text tokens)
FAMILY_FLASH_CASES = {
    "qwen2-moe-a2.7b": (4, 1024, 16, 16, 128, True, 0),
    "llava-next-mistral-7b": (4, 2176, 32, 8, 128, True, 0),
    "hubert-xlarge": (4, 1024, 16, 16, 80, False, 0),
    "mixtral-8x22b": (4, 1024, 48, 8, 128, True, 4096),
}
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
# zamba2-1.2b's Mamba2 layers at batch 4 x 1024 tokens: 64 heads of 64, state 64
ZAMBA_SSD_CASE = (4, 4, 256, 64, 64, 64)
# f32: summation orders differ; bf16: the reference's own tolerance, which
# also covers the kernel's fp32 add of D.x before its one cast. At the
# serving shape the sums run over 256 steps x 128 states with terms up to
# the size of the largest output, and two fp32 orders differ there by up to
# ~8e-6 of it (1.6e-3 against outputs up to 218 on the H100): in f32 the
# serving shapes' absolute tolerance is 1e-4 of the largest |output|
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SSD_SERVING_CASES = (SSD_SLICE_CASE, ZAMBA_SSD_CASE)
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
# cumsum); 22, 64 or 38 + 7 random-weight layers carry those ~1e-7 relative
# differences into the logits, so agreement is asked to 1e-3 of the largest
# logit
PREFILL_RTOL = 1e-3

SERVE = dict(n_requests=8, batch=4, prompt_len=1024, max_new=64)
# mixtral-8x22b cut to 2 of its 56 layers (5.4 B parameters, 10.8 GB in bf16)
MIXTRAL_SERVE = dict(n_requests=4, max_new=16)
# the depth cuts: (the fp32 prefill, the gradients of phase 6, train)
CUT_LAYERS = {"qwen2-moe-a2.7b": {"prefill": 2, "train": 6},
              "llava-next-mistral-7b": {"prefill": 4},
              "mixtral-8x22b": {"serve": 2}}
# one full-width qwen2-moe-a2.7b MoE layer, fp32, card against CPU on the same
# inputs and weights, at the tokens routed alike: both sum D = 2048 and F =
# 1408 products in fp32 in different orders (~1e-7 relative), so the outputs
# agree within 1e-5 of the largest |output| and the aux within 1e-5 of itself
MOE_RTOL = 1e-5
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
                      if case in SSD_SERVING_CASES and dtype == "float32" else 1.0)
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
    if case in SSD_SERVING_CASES:
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


def counts(kernels):
    return {k["name"]: k["counter"].launches for k in kernels}


def make_batch(torch, np, cfg, B, S, seed=0):
    """Seeded inputs on the card for ``cfg``'s input mode: S tokens, S frame
    embeddings (hubert) or ``cfg.vision_seq`` vision embeddings and S
    tokens (llava); targets for the S (text) positions."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.input_mode == "embeds":
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, size=(B, S))
    if cfg.input_mode == "vlm":
        b["vision_embeds"] = rng.standard_normal((B, cfg.vision_seq, cfg.d_model),
                                                 dtype=np.float32)
    b["targets"] = rng.integers(0, cfg.vocab_size, size=(B, S))
    return {k: torch.from_numpy(v).cuda() for k, v in b.items()}


@contextlib.contextmanager
def routing_log(torch):
    """Every MoE dispatch's top-k expert ids (ascending per token) while the
    context is open, from the same router product the dispatch computes."""
    from repro_torch.models import moe as moe_mod
    dispatch, log = moe_mod._dispatch_ffn, []

    def logged(p, xt, n_top, capacity_factor):
        probs = torch.softmax(xt.float() @ p.router, dim=-1)
        log.append(torch.topk(probs, n_top, dim=-1)[1].sort(-1)[0])
        return dispatch(p, xt, n_top, capacity_factor)
    moe_mod._dispatch_ffn = logged
    try:
        yield log
    finally:
        moe_mod._dispatch_ffn = dispatch


def topk_mismatch(a, b):
    """(token-dispatches whose top-k sets differ between logs a and b, of
    how many)."""
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} MoE dispatches against {len(b)}")
    return (sum(int((x != y).any(-1).sum()) for x, y in zip(a, b)),
            sum(x.shape[0] for x in a))


def check_prefill(torch, np, Model, cfg32, kernels, flags, want):
    """Full-width fp32 prefill (``Model.encode`` for an encoder) at B=1,
    S=1024 (text) on one set of seeded weights and inputs, with every flag
    of ``flags`` on (through the kernels) and off (the plain paths);
    ``want``: each kernel's launches with them on. For MoE the tokens whose
    top-k experts differ between the two runs are counted."""
    params = Model(cfg32).init(0, device="cuda")
    batch = make_batch(torch, np, cfg32, 1, 1024)
    total = 1024 + (cfg32.vision_seq if cfg32.input_mode == "vlm" else 0)

    def run(on):
        m = Model(cfg32.replace(**{f: on for f in flags}))
        if cfg32.input_mode == "embeds":
            return m.encode(params, batch)
        return m.prefill(params, batch, total)[0]
    n0 = counts(kernels)
    with routing_log(torch) as rk:
        lk = run(True)
    n_kernel = {k: n - n0[k] for k, n in counts(kernels).items()}
    with routing_log(torch) as rp:
        lp = run(False)
    torch.cuda.synchronize()
    diff = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    moved, of = topk_mismatch(rk, rp)
    what = "encode" if cfg32.input_mode == "embeds" else "prefill"
    print(f"[prefill] {cfg32.name} fp32 {cfg32.n_layers} layers B=1 S={total} {what}: "
          f"{'+'.join(flags)} on vs off max|diff| {diff:.3g}, max|logit| {scale:.3g}, "
          f"relative {diff / scale:.3g} (limit {PREFILL_RTOL}), kernel launches {n_kernel}"
          + (f", top-k differs for {moved} of {of} token-layers" if of else ""))
    if n_kernel != want:
        raise AssertionError(f"{what} launched {n_kernel}, expected {want}")
    if not (torch.isfinite(lk).all() and diff <= PREFILL_RTOL * scale):
        raise AssertionError(f"the {flags} {what}s disagree: {diff:.3g} > "
                             f"{PREFILL_RTOL} * {scale:.3g}")
    del params, lk, lp
    torch.cuda.empty_cache()
    return {"max_abs_diff": diff, "max_abs_logit": scale, "launches": n_kernel,
            "topk_mismatch": [moved, of]}


def check_moe_layer(torch, cfg):
    """One full-width MoE layer of ``cfg``, fp32, on 1 x 1024 tokens: the card
    against the CPU on the same weights and inputs (routing, output at the
    tokens routed alike, aux), then twice on the card in bf16 (router fp32):
    the two outputs must be equal bit for bit."""
    from repro_torch.models.moe import MoE, capacity, moe_apply
    D, T, k = cfg.d_model, 1024, cfg.n_experts_per_tok
    gen = torch.Generator().manual_seed(0)
    layer = MoE(D, cfg.moe_d_ff, cfg.n_experts, torch.float32, cfg.shared_d_ff, "cpu", gen)
    x = torch.randn((1, T, D), generator=gen)
    with torch.no_grad():
        with routing_log(torch) as rc:
            yc, auxc = moe_apply(layer, x, n_top=k)
        layer.cuda()
        xg = x.cuda()
        with routing_log(torch) as rg:
            yg, auxg = moe_apply(layer, xg, n_top=k)
        torch.cuda.synchronize()
        same = (rc[0] == rg[0].cpu()).all(-1)
        moved = int((~same).sum())
        err = (yg.cpu()[0][same] - yc[0][same]).abs().max().item()
        scale = yc.abs().max().item()
        aux_err = abs(auxg.item() - auxc.item())
        layer16 = MoE(D, cfg.moe_d_ff, cfg.n_experts, torch.bfloat16, cfg.shared_d_ff,
                      "cuda", torch.Generator(device="cuda").manual_seed(0))
        x16 = xg.to(torch.bfloat16)
        runs = [moe_apply(layer16, x16, n_top=k)[0] for _ in range(2)]
        torch.cuda.synchronize()
        equal = torch.equal(*runs)
    C = capacity(T, k, cfg.n_experts, 1.25)
    print(f"[moe] {cfg.name} layer E={cfg.n_experts} top-{k} D={D} F={cfg.moe_d_ff} "
          f"shared {cfg.shared_d_ff}, T={T} (C={C}) fp32 card vs CPU: top-k differs for "
          f"{moved} of {T} tokens; output max|diff| {err:.3g} of max|y| {scale:.3g} "
          f"(limit {MOE_RTOL} of it), aux {auxg.item():.6f} vs {auxc.item():.6f}; bf16 "
          f"twice on the card: {'equal bit for bit' if equal else 'NOT equal'}")
    if not (err <= MOE_RTOL * scale and (moved or aux_err <= MOE_RTOL * abs(auxc.item()))):
        raise AssertionError(f"{cfg.name} MoE layer: card and CPU disagree ({err:.3g}, "
                             f"aux {aux_err:.3g})")
    if not equal:
        raise AssertionError(f"{cfg.name} MoE layer: two bf16 runs on the card differ")
    del layer, layer16, runs
    torch.cuda.empty_cache()
    return {"topk_mismatch": [moved, T], "capacity": C, "max_abs_diff": err,
            "max_abs_y": scale, "aux": [auxg.item(), auxc.item()],
            "bf16_repeat_equal": equal}


def serve_path(torch, serve_mod, Model, cfg, kernels, **override):
    """One main path: ``serve`` (``SERVE``'s traffic, ``override`` on it)
    with every launch count set to 0 just before and read just after.
    Checks every logits tensor, the completions and the trace; returns the
    launch counts."""
    kw = {**SERVE, **override}
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
        out = serve_mod.serve(cfg, trace_path=str(trace), device="cuda", **kw)
        torch.cuda.synchronize()
        launches = counts(kernels)
    finally:
        serve_mod.Model = Model
    peak = torch.cuda.max_memory_allocated()
    trace_rows = trace.read_text().splitlines()
    print(f"[serve] {cfg.name} bf16 ({cfg.n_layers} layers): {out['requests']} requests, "
          f"{out['new_tokens']} new tokens, {out['tokens_per_s']:.2f} tok/s, "
          f"wall {out['wall_s']:.3f} s, p50 {out['p50_s']:.4f} s, "
          f"p99 {out['p99_s']:.4f} s, peak memory {peak / 2**30:.3f} GiB, "
          f"launches {launches}, trace rows {len(trace_rows)}")
    if not finite or not torch.stack(finite).all():
        raise AssertionError(f"{cfg.name}: serve produced non-finite logits")
    if out["requests"] != kw["n_requests"] or len(trace_rows) != kw["n_requests"]:
        raise AssertionError(f"{out['requests']} completions, {len(trace_rows)} trace rows")
    if any(len(c["tokens"]) != kw["max_new"] or
           not all(0 <= t < cfg.vocab_size for t in c["tokens"])
           for c in out["completions"]):
        raise AssertionError("a completion has the wrong length or a token "
                             "outside the vocabulary")
    return launches


def vlm_path(torch, np, Model, cfg, kernels):
    """llava's main path through the ``Model`` facade (``serve`` feeds tokens
    only, as the reference's does): with every launch count set to 0
    just before and read just after, ``prefill`` of 4 x (``cfg.vision_seq``
    seeded vision embeddings + 1024 tokens), then 64 greedy ``decode_step``s.
    Checks finite logits and in-vocabulary tokens; returns the launches and
    its numbers (host clock, each end synchronised)."""
    B, S, new = SERVE["batch"], SERVE["prompt_len"], SERVE["max_new"]
    model = Model(cfg)
    params = model.init(0, device="cuda")
    batch = make_batch(torch, np, cfg, B, S)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k["counter"].launches = 0
    t0 = time.monotonic()
    logits, state = model.prefill(params, batch, cfg.vision_seq + S + new)
    nxt = logits[:, :cfg.vocab_size].argmax(-1)
    torch.cuda.synchronize()
    t_prefill = time.monotonic() - t0
    finite, toks = [torch.isfinite(logits).all()], []
    for _ in range(new):
        toks.append(nxt)
        logits, state = model.decode_step(params, state, nxt)
        finite.append(torch.isfinite(logits).all())
        nxt = logits[:, :cfg.vocab_size].argmax(-1)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = counts(kernels)
    toks = torch.stack(toks, 1)
    num = {"prefill_s": t_prefill, "decode_step_s": (wall - t_prefill) / new, "wall_s": wall,
           "tokens_per_s": B * new / wall, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches}
    print(f"[vlm] {cfg.name} bf16: prefill 4 x ({cfg.vision_seq} vision + {S} tokens) "
          f"{t_prefill:.4f} s, {new} decode steps at {num['decode_step_s'] * 1e3:.2f} ms, "
          f"{num['tokens_per_s']:.2f} tok/s, wall {wall:.3f} s, peak memory "
          f"{num['peak_gib']:.3f} GiB, launches {launches}")
    if not torch.stack(finite).all():
        raise AssertionError(f"{cfg.name}: non-finite logits")
    if toks.shape != (B, new) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{cfg.name}: a token outside the vocabulary")
    del params, state, logits
    torch.cuda.empty_cache()
    return launches, num


def check_train_grads(torch, np, Model, cfg32, kernels, flags, want):
    """Phase 6: fp32, full width, 2 layers, B=1 x 1024 tokens (frames for an
    encoder). The loss and every gradient leaf with every flag of ``flags``
    on and off; no parameter without a gradient through the kernels;
    ``want``: each kernel's launches with them on (a kernel under remat runs
    twice a layer: the forward, and its re-run). For MoE the tokens whose
    top-k experts differ between the two runs are counted, and the
    gradients are held to the tolerance only where none does: a flipped
    expert moves a token's output by a step, not by a rounding."""
    cfg = cfg32.replace(n_layers=2)
    params = Model(cfg).init(0, device="cuda")
    batch = make_batch(torch, np, cfg, 1, 1024)
    losses, grads, launches, routes = [], [], [], []
    for on in (True, False):
        n0 = counts(kernels)
        with routing_log(torch) as log:
            loss = Model(cfg.replace(**{f: on for f in flags})).loss(params, batch)
            loss.backward()
        torch.cuda.synchronize()
        routes.append(log)
        launches.append({k: n - n0[k] for k, n in counts(kernels).items()})
        missing = [k for k, p in params.named_parameters() if p.grad is None]
        if missing:
            raise AssertionError(f"{cfg.name} {flags}={on}: no gradient for {missing}")
        grads.append({k: p.grad for k, p in params.named_parameters()})
        losses.append(loss.item())
        params.zero_grad(set_to_none=True)
    worst, worst_leaf = 0.0, None
    for k, g in grads[0].items():
        plain = grads[1][k]
        frac = ((g - plain).abs().max() / plain.abs().max().clamp(min=1e-30)).item()
        if not frac <= worst:
            worst, worst_leaf = frac, k
    moved, of = topk_mismatch(*routes)
    print(f"[grads] {cfg.name} fp32 2 layers B=1 S=1024: loss {losses[0]:.6f} "
          f"({'+'.join(flags)} on) vs {losses[1]:.6f} (off); {len(grads[0])} gradient "
          f"leaves, worst |diff| {worst:.3g} of its leaf's max |g| ({worst_leaf}; limit "
          f"{GRAD_RTOL}); kernel launches {launches[0]} on, {launches[1]} off"
          + (f"; top-k differs for {moved} of {of} token-dispatches"
             + (", so the tolerance is not held" if moved else "") if of else ""))
    off = {k: 0 for k in want}
    if launches != [want, off]:
        raise AssertionError(f"launches {launches}, expected [{want}, {off}]")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{cfg.name}: a loss is not finite: {losses}")
    if not moved and not (abs(losses[0] - losses[1]) <= GRAD_RTOL * abs(losses[1])
                          and worst <= GRAD_RTOL):
        raise AssertionError(f"{cfg.name}: kernel and plain gradients disagree: {worst:.3g} "
                             f"of a leaf's max ({worst_leaf}), losses {losses}")
    del params, grads
    torch.cuda.empty_cache()
    return {"losses": losses, "worst": worst, "worst_leaf": worst_leaf,
            "launches": launches[0], "topk_mismatch": [moved, of]}


def ckpt_bytes(cfg):
    """Bytes of one checkpoint of (params, AdamW state): the params in their
    dtypes and fp32 m and v, from a model on the meta device."""
    from repro_torch.models.model import model_class
    m = model_class(cfg)(cfg, device="meta")
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
        launches = counts(kernels)
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


def train_steps(torch, train_mod, cfg, kernels, name, per_step):
    """Phases 8-9: 2 I/O-aware steps, no checkpoint; ``per_step``: each
    kernel's launches a step."""
    out, launches, nums = train_run(torch, train_mod, cfg, kernels, name, steps=2,
                                    ckpt_dir=None, ckpt_every=0, io_aware=True)
    want = {k: 2 * n for k, n in per_step.items()}
    if launches != want or out["steps_run"] != 2:
        raise AssertionError(f"{cfg.name} train launched {launches} in {out['steps_run']} "
                             f"steps, expected {want} in 2")
    del out
    torch.cuda.empty_cache()
    return launches, nums


def encoder_train(torch, np, train_mod, Model, cfg, kernels, steps=2):
    """hubert's train path through the ``Model`` facade (``train`` feeds
    tokens only, as the reference's does): ``steps`` of
    ``train_step`` (``Model.loss``, backward, AdamW) on 4 x 1024 seeded frame
    embeddings, with every launch count set to 0 just before and read just
    after. Checks finite losses and gnorms; returns the launches and its
    numbers (host clock around each step, which ends in the loss's and
    gnorm's sync)."""
    from repro_torch.optim import AdamWConfig, adamw_init
    B, S = TRAIN["batch"], TRAIN["seq"]
    model = Model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, device="cuda")
    opt_state = adamw_init(params.state_dict())
    opt = AdamWConfig(total_steps=steps, warmup_steps=1)
    rng = np.random.default_rng(0)
    for k in kernels:
        k["counter"].launches = 0
    times, losses, gnorms = [], [], []
    for _ in range(steps):
        b = {"embeds": rng.standard_normal((B, S, cfg.d_model), dtype=np.float32),
             "targets": rng.integers(0, cfg.vocab_size, size=(B, S))}
        t0 = time.monotonic()
        opt_state, loss, gnorm = train_mod.train_step(model, params, opt_state, b, opt)
        losses.append(loss.item())
        gnorms.append(gnorm.item())
        times.append(time.monotonic() - t0)
    launches = counts(kernels)
    num = {"losses": losses, "gnorms": gnorms, "steps_s": times, "step_s": times[-1],
           "tokens_per_s": B * S / times[-1],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches}
    print(f"[train] {cfg.name} encoder ({cfg.n_layers} layers): {steps} steps of "
          f"train_step on {B} x {S} frame embeddings, losses {[round(x, 4) for x in losses]}, "
          f"gnorms {[round(g, 4) for g in gnorms]}, step {times[-1]:.4f} s (first "
          f"{times[0]:.3f} s), {num['tokens_per_s']:.1f} tok/s, peak {num['peak_gib']:.3f} "
          f"GiB, launches {launches}")
    if not all(map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"{cfg.name}: a loss or gnorm is not finite")
    del params, opt_state
    torch.cuda.empty_cache()
    return launches, num


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
    for case in FLASH_CASES + BOUNDARY_CASES + HD80_CASES + [ZAMBA_FLASH_CASE]:
        for dtype in FLASH_DTYPES:
            check_flash(torch, ops, attention_ref, case, dtype)
    for dtype in ("bfloat16", "float16"):
        check_flash_masked(torch, ops, dtype)
    check_flash(torch, ops, attention_ref, SLICE_CASE, "float32", timed=True)
    check_flash(torch, ops, attention_ref, SLICE_CASE, "float16", timed=True)
    # each kernel's numbers at the main paths' shapes, for the kernels line
    rows = {"flash_attention_fwd": check_flash(torch, ops, attention_ref, SLICE_CASE,
                                               "bfloat16", timed=True)}
    zamba_rows = {"flash_attention_fwd": check_flash(torch, ops, attention_ref,
                                                     ZAMBA_FLASH_CASE, "bfloat16", timed=True)}
    # head dim 80 in every dtype route at hubert's shape, then the later
    # families' shapes in bf16, their serving type
    hubert_case = FAMILY_FLASH_CASES["hubert-xlarge"]
    for dtype in ("float32", "float16"):
        check_flash(torch, ops, attention_ref, hubert_case, dtype, timed=True)
    family_rows = {arch: {"case": case, **check_flash(torch, ops, attention_ref, case,
                                                      "bfloat16", timed=True)}
                   for arch, case in FAMILY_FLASH_CASES.items()}
    # f32 through the exact route, bf16 through the tf32 tensor-core route
    for case in SSD_CASES:
        check_ssd(torch, ssd_ops, ssd_scan_ref, case, "float32")
        check_ssd(torch, ssd_ops, ssd_scan_ref, case, "bfloat16", model=ssd_scan_tf32_ref)
    for case in SSD_SERVING_CASES:
        check_ssd(torch, ssd_ops, ssd_scan_ref, case, "float32")
    rows["ssd_scan_fwd"] = check_ssd(torch, ssd_ops, ssd_scan_ref, SSD_SLICE_CASE,
                                     "bfloat16", model=ssd_scan_tf32_ref)
    zamba_rows["ssd_scan_fwd"] = check_ssd(torch, ssd_ops, ssd_scan_ref, ZAMBA_SSD_CASE,
                                           "bfloat16", model=ssd_scan_tf32_ref)
    zamba_rows["flash_attention_fwd"]["case"] = ZAMBA_FLASH_CASE
    zamba_rows["ssd_scan_fwd"]["case"] = ZAMBA_SSD_CASE

    # each arch's kernel flags, and each kernel's launches in one forward:
    # flash once a site of zamba2's shared block (7 in 38 layers) or once a
    # tinyllama layer, SSD once a Mamba2 layer
    K1, K2 = "flash_attention_fwd", "ssd_scan_fwd"
    zamba = get_config("zamba2-1.2b")
    sites = len(range(0, zamba.n_layers, zamba.attn_every))
    archs = {"tinyllama-1.1b": (("use_flash",),
                                {K1: get_config("tinyllama-1.1b").n_layers, K2: 0}),
             "mamba2-2.7b": (("use_ssd_kernel",),
                             {K1: 0, K2: get_config("mamba2-2.7b").n_layers}),
             "zamba2-1.2b": (("use_flash", "use_ssd_kernel"), {K1: sites, K2: zamba.n_layers})}

    # 4. full-width fp32 prefills: the kernels against the plain paths
    for arch, (flags, per_pass) in archs.items():
        check_prefill(torch, np, Model, get_config(arch).replace(dtype=torch.float32),
                      kernels, flags, per_pass)
    # the later families through flash: qwen2-moe and llava cut in depth
    family_nums = {}
    for arch in ("qwen2-moe-a2.7b", "hubert-xlarge", "llava-next-mistral-7b"):
        cfg32 = get_config(arch).replace(dtype=torch.float32)
        cfg32 = cfg32.replace(n_layers=CUT_LAYERS.get(arch, {}).get("prefill", cfg32.n_layers))
        family_nums[arch] = {"prefill": check_prefill(torch, np, Model, cfg32, kernels,
                                                      ("use_flash",),
                                                      {K1: cfg32.n_layers, K2: 0})}
    family_nums["qwen2-moe-a2.7b"]["moe_layer"] = check_moe_layer(
        torch, get_config("qwen2-moe-a2.7b"))

    # 5. the main paths: each kernel's launches on each serving path
    waves = -(-SERVE["n_requests"] // SERVE["batch"])
    serve_launches = {}
    for arch, (flags, per_pass) in archs.items():
        cfg = get_config(arch).replace(**{f: True for f in flags})
        got = serve_path(torch, serve_mod, Model, cfg, kernels)
        expect = {k: waves * n for k, n in per_pass.items()}
        if got != expect:
            raise AssertionError(f"{arch} serve launched {got}, expected {expect}")
        serve_launches[arch] = got
    # qwen2-moe at full depth, mixtral cut in depth, through serve; llava
    # through the Model facade
    qwen = get_config("qwen2-moe-a2.7b").replace(use_flash=True)
    mixtral = get_config("mixtral-8x22b").replace(
        use_flash=True, n_layers=CUT_LAYERS["mixtral-8x22b"]["serve"])
    for cfg, kw in ((qwen, {}), (mixtral, MIXTRAL_SERVE)):
        got = serve_path(torch, serve_mod, Model, cfg, kernels, **kw)
        n_waves = -(-kw.get("n_requests", SERVE["n_requests"]) // SERVE["batch"])
        expect = {K1: n_waves * cfg.n_layers, K2: 0}
        if got != expect:
            raise AssertionError(f"{cfg.name} serve launched {got}, expected {expect}")
        serve_launches[cfg.name] = got
    llava = get_config("llava-next-mistral-7b").replace(use_flash=True)
    serve_launches[llava.name], family_nums[llava.name]["serve"] = vlm_path(
        torch, np, Model, llava, kernels)
    if serve_launches[llava.name] != {K1: llava.n_layers, K2: 0}:
        raise AssertionError(f"llava launched {serve_launches[llava.name]}")

    # 6. gradients through the kernels against the plain paths, 2 layers (for
    # zamba2: one site); remat re-runs the SSD kernel, not the shared block
    grad_launches = {"tinyllama-1.1b": {K1: 4, K2: 0}, "mamba2-2.7b": {K1: 0, K2: 4},
                     "zamba2-1.2b": {K1: 1, K2: 4}}
    for arch, (flags, _) in archs.items():
        check_train_grads(torch, np, Model, get_config(arch).replace(dtype=torch.float32),
                          kernels, flags, grad_launches[arch])
    for arch in ("hubert-xlarge", "qwen2-moe-a2.7b"):
        family_nums[arch]["grads"] = check_train_grads(
            torch, np, Model, get_config(arch).replace(dtype=torch.float32), kernels,
            ("use_flash",), {K1: 4, K2: 0})

    # 7-9. the train paths: each kernel's launches on each train path
    train_nums = {"card": smi}
    dense = get_config("tinyllama-1.1b").replace(use_flash=True)
    flash_train, train_nums[dense.name] = train_dense(torch, train_mod, CheckpointManager,
                                                      dense, kernels)
    ssm = get_config("mamba2-2.7b").replace(use_ssd_kernel=True)
    ssd_train, train_nums[ssm.name] = train_steps(torch, train_mod, ssm, kernels, "ssm",
                                                  {K1: 0, K2: 2 * ssm.n_layers})
    hybrid = zamba.replace(use_flash=True, use_ssd_kernel=True)
    hybrid_train, train_nums[hybrid.name] = train_steps(
        torch, train_mod, hybrid, kernels, "hybrid", {K1: sites, K2: 2 * hybrid.n_layers})
    cut = CUT_LAYERS["qwen2-moe-a2.7b"]["train"]
    moe = qwen.replace(n_layers=cut)
    moe_train, train_nums[moe.name] = train_steps(
        torch, train_mod, moe, kernels, f"moe_{cut}_of_{qwen.n_layers}_layers",
        {K1: 2 * cut, K2: 0})
    hubert = get_config("hubert-xlarge").replace(use_flash=True)
    enc_train, train_nums[hubert.name] = encoder_train(torch, np, train_mod, Model, hubert,
                                                       kernels)
    if enc_train != {K1: 2 * 2 * hubert.n_layers, K2: 0}:
        raise AssertionError(f"hubert train launched {enc_train}")
    family_train = {qwen.name: moe_train, hubert.name: enc_train}
    train_paths = {
        K1: (flash_train[K1], "tinyllama-1.1b train, I/O-aware, 4 steps of 4 x 1024 tokens"),
        K2: (ssd_train[K2], "mamba2-2.7b train, 2 steps of 4 x 1024 tokens")}
    launches = {K1: serve_launches["tinyllama-1.1b"][K1],
                K2: serve_launches["mamba2-2.7b"][K2]}

    # 10. train numbers, kernel numbers, then the result line
    print(json.dumps({"train": train_nums, "families": family_nums}))
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": k["route"],
         "source": str(Path(k["path"]).relative_to(ROOT)),
         "replaces": k["replaces"], "launches": launches[k["name"]], **rows[k["name"]],
         "train_launches": train_paths[k["name"]][0], "train_path": train_paths[k["name"]][1],
         "zamba2": {"serve_launches": serve_launches["zamba2-1.2b"][k["name"]],
                    "train_launches": hybrid_train[k["name"]],
                    "paths": "zamba2-1.2b serve (8 requests, 2 waves of 4 x 1024) and "
                             "train (2 steps of 4 x 1024 tokens)",
                    **zamba_rows[k["name"]]},
         "families": {arch: {"launches": serve_launches.get(arch, {}).get(k["name"]),
                             "train_launches": family_train.get(arch, {}).get(k["name"]),
                             **row}
                      for arch, row in family_rows.items()} if k["name"] == K1 else {}}
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
