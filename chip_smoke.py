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
 10. the distributed layer over NCCL at world size 1 (one card:
     ``make_local_mesh()``, a (1, 1) ("data", "model") mesh, so every
     placement is a Shard over an axis of size 1 but every DTensor, local
     kernel call and collective path runs): 3 bf16 train steps of
     full-width, full-depth tinyllama-1.1b (batch 4 x 1024) and of
     zamba2-1.2b under ``tp_fsdp`` (``shard_params``, ``mesh_context``,
     ``Model.loss``, ``adamw_update`` without warm-up) against the same
     steps unsharded (every step's loss and gradient norm; the first
     step's parameters and each tensor's update) with each kernel's
     launches, the later ones timed both ways, and the peak memory; one full-width
     qwen2-moe-a2.7b MoE layer in fp32 under ``dp_tp_moe`` against the
     unsharded layer (output, aux, gradients); ``compressed_grads`` over the
     tinyllama gradient tree (time, and its error against the exact mean,
     at world 1 the int8 round trip);
 11. the port's dry-run (``repro_torch.launch.dryrun``) against the card,
     in processes of their own (its faked process group must not meet
     phase 10's NCCL group): the steps of phases 7, 9 and 5 (tinyllama-1.1b
     and zamba2-1.2b train, a tinyllama-1.1b prefill wave; bf16, 4 x 1024
     tokens) traced on ``meta`` at world 1, each predicted peak (argument
     + temp, less the plain attention's score matrices, which the kernel
     routes do not hold) against the phase's measured peak within 25%; the
     traced flops of the tinyllama step over phase 7's step time, as a
     share of the bf16 peak; the production dry-run of tinyllama-1.1b on the
     faked 16x16 mesh (``python -m repro_torch.launch.dryrun``, its three
     cells ok); the examples ``examples/torch/serve_batched.py`` and
     ``train_with_io_aware_checkpointing.py`` on the card;
 12. the shapes past the serving ones, which the Pallas kernels take as
     well: K1 at every head dim of tests/test_torch_flash.py's ANY_HD_CASES
     (96 and 256 built natively, the others zero-padded by the wrapper to the
     next built width), B 4, S 2048, 32 query / 8 KV heads, causal and
     bidirectional, in every dtype route; K2 in fp16 at mamba2-2.7b's
     serving shape and at Q 512, N 256, P 128 in bf16 and fp32; each held
     against its plain version and timed as in phase 3 (padded widths also
     with the kernel alone at the padded width). Then three full-width
     paths, each with the launch counts set to 0 just before and read just
     after: ``serve`` of mamba2-2.7b in fp16 (4 requests of 1024 + 64
     tokens, batch 2) through K2's fp16 route, its greedy tokens against
     the same serve with the kernel off; the fp16 prefill (4 x 1024) kernel
     on against off; mamba2-2.7b with ``ssm_chunk=512`` in bf16 (K2 at Q
     512) and tinyllama-1.1b with ``head_dim=256`` in bf16 (K1 at hd 256),
     4 x 1024 prefills kernel on against off; each 16-bit prefill also
     against the plain path in fp32 on the same weights, which sets the
     scale of the 16-bit rounding the comparison allows;
 13. past 256, and the zoo's last configs that fit one card (what the
     earlier phases held freed first): K1 at head dims 264, 320, 384, 512
     and 1024 (padded to a multiple of 64, output columns in passes of 256),
     B 4, S 2048, 32 query / 8 KV heads, causal and bidirectional, and K2 at
     (4, 2, 256, 40, 64) with N 320 and 512 (the state in slices of 256),
     each in every dtype route, held against its plain version and timed as
     in phase 3; each kernel timed at the shapes of the paths below. Then,
     each path with the launch counts set to 0 just before and read just
     after: ``serve`` of full-width, full-depth granite-20b in bf16 (8
     requests of 1024 + 64 tokens in waves of 4; MQA, 48 query heads on one
     KV head); granite-20b cut 52 -> 4 layers for a fp32 4 x 1024 prefill
     kernel on against off and 2 bf16 ``train`` steps of 4 x 1024 tokens
     (every parameter's gradient present and finite); smollm-360m at full
     size: ``train`` 2 steps, ``serve`` and the fp32 prefill check;
     tinyllama-1.1b with ``head_dim=512`` and mamba2-2.7b with
     ``ssm_state=512``, bf16 4 x 1024 prefills kernel on against off and
     against the plain path in fp32, as in phase 12;
 14. one JSON line of train numbers, one of kernel numbers, then the result
     line.

Exits non-zero, printing no result, without CUDA or outside a checkout.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
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
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2, "float16": 5e-2}
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
# phase 12: K1 at the head dims of tests/test_torch_flash.py's ANY_HD_CASES,
# (B, S, H, KV) below, causal and bidirectional, in every dtype route
SHAPE_HEAD_DIMS = (8, 16, 20, 48, 96, 112, 160, 192, 256)
SHAPE_FLASH = (4, 2048, 32, 8)
# K2: fp16 at mamba2-2.7b's serving shape; Q 512, N 256, P 128 (mamba2-2.7b's
# d_inner of 5120 as 40 heads of 128, a 1024-token sequence in 2 chunks)
SSD_LARGE_CASE = (4, 2, 512, 40, 128, 256)
SHAPE_SSD = [(SSD_SLICE_CASE, "float16"), (SSD_LARGE_CASE, "bfloat16"),
             (SSD_LARGE_CASE, "float32")]
# the kernels at the shapes the two bf16 paths below give them: mamba2-2.7b's
# Mamba2 layer at chunk 512, tinyllama-1.1b's attention at head dim 256
SSD_CHUNK512_CASE = (4, 2, 512, 80, 64, 128)
FLASH_HD256_CASE = (4, 1024, 32, 4, 256, True, 0)
# the full-width 16-bit paths: serve of 4 requests of the serving prompt and
# decode lengths at batch 2 (2 waves), prefills of 4 x 1024 tokens
SHAPE_SERVE = dict(n_requests=4, batch=2)
SHAPE_PREFILL = (4, 1024)
# phase 13: K1 past head dim 256 at SHAPE_FLASH (widths padded to a multiple
# of 64, output columns in passes of 256), K2 past state 256 at
# WIDE_SSD_CASE's (b, nc, Q, H, P) (the state in slices of 256), every dtype
WIDE_HEAD_DIMS = (264, 320, 384, 512, 1024)
WIDE_SSD_CASE = (4, 2, 256, 40, 64)
WIDE_STATES = (320, 512)
# the kernels at the shapes phase 13's paths give them: granite-20b (MQA,
# 48 query heads on 1 KV head), smollm-360m (15 on 5), tinyllama-1.1b at
# head dim 512; mamba2-2.7b at state 512
WIDE_PATH_FLASH = {"granite-20b": (4, 1024, 48, 1, 128, True, 0),
                   "smollm-360m": (4, 1024, 15, 5, 64, True, 0),
                   "tinyllama-1.1b head_dim 512": (4, 1024, 32, 4, 512, True, 0)}
WIDE_PATH_SSD = (4, 4, 256, 80, 64, 512)
# granite-20b's depth for the fp32 prefill check and the train steps
WIDE_CUT_LAYERS = 4
# a 16-bit prefill through the kernel against the plain 16-bit path: within
# twice the plain path's own distance from the plain path in fp32 (what 16
# bits cost through the model; the two paths round differently, and if
# each lay that far from fp32 in opposite directions they would differ by
# twice it). On the H100 the ratio was 1.04-1.15
SHAPE_PREFILL_LIMIT = 2.0


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


def timings(torch, fn, reps=20):
    """``fn``'s ms (CUDA events around one call), device ms and host ms,
    medians of ``reps`` calls (host ms: of 2.5x as many)."""
    return {"ms": cuda_ms(torch, fn, reps), "device_ms": device_ms(torch, fn, reps),
            "host_ms": host_ms(torch, fn, reps * 5 // 2)}


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
    xb = 4 if dtype == "float32" else 2
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


def check_flash(torch, ops, attention_ref, case, dtype, seed=0, timed=False, reps=20):
    """The kernel of ``dtype``'s route against the plain version; with
    ``timed``, also its numbers for the kernels line (medians of ``reps``
    calls)."""
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
    kern = timings(torch, lambda: ops.flash_attention(q, k, v, causal, window), reps)
    sdpa = timings(torch, lib, reps)
    row = {"max_abs_err": err, "ms": kern["ms"],
           "plain_ms": cuda_ms(torch, lambda: attention_ref(q, k, v, causal=causal,
                                                            window=window), reps),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": sdpa["ms"],
           "device_ms": kern["device_ms"], "host_ms": kern["host_ms"]}
    width = ops.launch_plan(hd)[0]
    if width != hd:
        # the kernel alone at the padded width, on inputs padded beforehand:
        # the rest of the wrapper's time is the padding copies and the slice
        qp, kp, vp = (F.pad(t, (0, width - hd)) for t in (q, k, v))
        at_width = cuda_ms(torch, lambda: ops._launch(qp, kp, vp, causal, window,
                                                      1 / math.sqrt(hd)), reps)
        row.update(padded_to=width, kernel_at_width_ms=at_width,
                   padding_copy_share=1 - at_width / kern["ms"],
                   zero_column_share=1 - hd / width)
    print(f"[flash] B,S,H,KV,hd,causal,window={case} {dtype}: max|err| {err:.3g} "
          f"(tol {tol}); kernel {kern['ms']:.4f} ms (device {kern['device_ms']:.4f}, "
          f"host {kern['host_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
          f"sdpa {sdpa['ms']:.4f} ms (device {sdpa['device_ms']:.4f}, "
          f"host {sdpa['host_ms']:.4f}), bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / kern['ms']:.1f}% of bound, "
          f"{100 * bound_ms / kern['device_ms']:.1f}% by device time"
          + (f"; padded to {width}: the kernel alone {row['kernel_at_width_ms']:.4f} ms, "
             f"the padding copies {100 * row['padding_copy_share']:.1f}% of the call"
             if width != hd else ""))
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
        # in f32, sums as long as the serving ones (Q x N >= 256 x 128) are
        # held to 1e-4 of the largest |output|, as the tests hold them
        long_sums = case in SSD_SERVING_CASES or Q * N >= 256 * 128
        atol = tol * (ref.abs().max().item() if long_sums and dtype == "float32" else 1.0)
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


def check_prefill(torch, np, Model, cfg32, kernels, flags, want, B=1):
    """Full-width fp32 prefill (``Model.encode`` for an encoder) at B (1 unless
    named), S=1024 (text) on one set of seeded weights and inputs, with every flag
    of ``flags`` on (through the kernels) and off (the plain paths);
    ``want``: each kernel's launches with them on. For MoE the tokens whose
    top-k experts differ between the two runs are counted."""
    params = Model(cfg32).init(0, device="cuda")
    batch = make_batch(torch, np, cfg32, B, 1024)
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
    print(f"[prefill] {cfg32.name} fp32 {cfg32.n_layers} layers B={B} S={total} {what}: "
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
    launch counts, the peak of allocated device memory (bytes) and serve's
    output."""
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
    print(f"[serve] {cfg.name} {str(cfg.dtype).split('.')[-1]} ({cfg.n_layers} layers): "
          f"{out['requests']} requests, "
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
    return launches, peak, out


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
    overlap: the share of save-to-commit the loop spent elsewhere. The save's
    times are the port's own spans (``ckpt.save``, ``ckpt.to_host``,
    ``ckpt.wait``), read from the run's trace: the run's runtime is traced
    through ``repro_torch.obs.FORCE``."""
    from repro_torch import obs
    log = ROOT / "build" / "chip_smoke" / f"train_{name}.jsonl"
    log.parent.mkdir(parents=True, exist_ok=True)
    log.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_runs = len(obs.RUNS)
    obs.FORCE = True
    try:
        for k in kernels:
            k["counter"].launches = 0
        out = train_mod.train(cfg, log_path=str(log), device="cuda", **TRAIN, **kw)
        torch.cuda.synchronize()
        launches = counts(kernels)
    finally:
        obs.FORCE = False
    (_, rt), = obs.RUNS[n_runs:]
    del obs.RUNS[n_runs:]
    saves = save_spans(rt.trace().events)
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    steps = [r["t"] - p["t"] for p, r in zip(rows, rows[1:])]
    step_s = statistics.median(steps) if steps else rows[0]["t"]
    for sv in saves:
        if not sv["saved"]:       # skipped: the previous save was in flight
            continue
        manifest = json.loads((Path(kw["ckpt_dir"]) / f"step_{sv['step']:08d}" /
                               "MANIFEST.json").read_text())
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


def save_spans(events):
    """Per ``ckpt.save`` span of a traced run, in order: its step, whether it
    saved (False: skipped, the previous save in flight), the seconds it held
    the loop, the seconds of its ``ckpt.to_host`` spans, and the seconds of
    the last ``ckpt.wait`` span for its step (0 if none)."""
    spans = sorted((e for e in events if e["type"] == "span" and e["cat"] == "ckpt"),
                   key=lambda e: e["t"])
    saves = []
    for sp in spans:
        a = sp["args"]
        if sp["name"] != "ckpt.save":
            continue
        waits = [w["dur"] for w in spans
                 if w["name"] == "ckpt.wait" and w["args"]["step"] == a["step"]]
        saves.append({"step": a["step"], "saved": a["saved"], "save_call_s": sp["dur"],
                      "host_copy_s": sum(c["dur"] for c in spans if c["name"] == "ckpt.to_host"
                                         and c["args"]["parent"] == a["id"]),
                      "wait_s": waits[-1] if waits and a["saved"] else 0.0})
    return saves


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


# the distributed phase: later steps timed each way (the first step of a
# sharded run includes DTensor's sharding propagation, cached after it)
DIST_STEPS = 3
# AdamW without warm-up: the first step then moves a bf16 weight by about
# lr = 3e-4, one to a few bf16 steps (at the default warm-up it moves it by
# 3e-6, and most weights keep their value)
DIST_ADAMW = {"warmup_steps": 0}
# sharded steps against the unsharded ones at world size 1, where nothing is
# split, so the two differ only in the order of a few sums. The first step:
# loss and gradient norm, relative; each parameter, absolute (a gradient
# near 0 can change sign with the order of its sum, and AdamW's first step
# moves its weight by up to lr either way); each tensor's update (new minus
# old) against the unsharded update's 2-norm. The later steps start from
# parameters that differ by those few values: their loss and gradient norm,
# relative. The limits stand 5-60x above the gaps measured on the H100
# (PERF.md), and below what a lost or misplaced update gives.
DIST_FIRST_RTOL = 1e-6
DIST_PARAM_ATOL = 1e-4
DIST_UPDATE_RTOL = 1e-3
DIST_LATER_LOSS_RTOL = 1e-4
DIST_LATER_GNORM_RTOL = 5e-3


def _step(torch, model, params, batch, opt_state, acfg):
    """One train step: ``Model.loss``, backward, ``adamw_update`` on
    ``.grad``. Returns (loss, gnorm, the gradients)."""
    from repro_torch.optim import adamw_update
    loss = model.loss(params, batch)
    loss.backward()
    named = dict(params.named_parameters())
    grads = {k: p.grad for k, p in named.items()}
    _, _, gnorm = adamw_update(grads, named, opt_state, acfg)
    for p in named.values():
        p.grad = None
    return loss.detach(), gnorm, grads


def dist_train_step(torch, np, cfg, kernels, mesh, strategy, keep_grads=False):
    """``DIST_STEPS`` steps of ``cfg`` unsharded, then the same under
    ``strategy`` on ``mesh`` (``shard_params``, ``mesh_context``), from the
    same seeded weights and batches. Holds the sharded steps against the
    unsharded ones (every step's loss and gradient norm; the first step's
    parameters and each tensor's update); returns their numbers (the
    launches of the sharded first step) and, with ``keep_grads``, the
    unsharded first step's gradients."""
    from repro_torch.distributed import STRATEGIES, mesh_context, place, shard_params
    from repro_torch.distributed.sharding import full
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    model, acfg = Model(cfg), AdamWConfig(**DIST_ADAMW)
    batches = [make_batch(torch, np, cfg, TRAIN["batch"], TRAIN["seq"], seed=i)
               for i in range(DIST_STEPS)]
    runs, first = {}, {}
    for name in ("unsharded", strategy):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(0, device="cuda")
        init = ({k: p.detach().clone() for k, p in params.named_parameters()}
                if name == "unsharded" else None)

        def ctx():
            return (contextlib.nullcontext() if name == "unsharded"
                    else mesh_context(mesh, STRATEGIES[strategy]))
        with ctx():
            if name != "unsharded":
                place(params, shard_params(params, model.logical_axes(params)))
        opt_state = adamw_init(dict(params.named_parameters()))
        times, losses, gnorms = [], [], []
        for i, b in enumerate(batches):
            for k in kernels:
                k["counter"].launches = 0
            torch.cuda.synchronize()
            t0 = time.monotonic()
            with ctx():
                loss, gnorm, grads = _step(torch, model, params, b, opt_state, acfg)
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
            losses.append(float(full(loss)))
            gnorms.append(float(gnorm))
            if i == 0:
                launches = counts(kernels)
                after = {k: full(p.detach()) for k, p in params.named_parameters()}
                if name == "unsharded":
                    first["after"] = {k: t.clone() for k, t in after.items()}
                    first["update_norm"] = {k: (t.float() - init[k].float()).norm().item()
                                            for k, t in after.items()}
                    init = None
                    if keep_grads:
                        first["grads"] = dict(grads)
                else:
                    param_diff, update_err = 0.0, {}
                    for k, t in after.items():
                        d = t.float() - first["after"][k].float()
                        param_diff = max(param_diff, d.abs().max().item())
                        un = first["update_norm"][k]
                        update_err[k] = d.norm().item() / un if un else d.norm().item()
                    del first["after"]
                del after
            del grads
        if not all(map(math.isfinite, losses + gnorms)):
            raise AssertionError(f"{cfg.name} {name}: a loss or gnorm is not finite")
        runs[name] = {"losses": losses, "gnorms": gnorms, "steps_s": times,
                      "later_step_s": statistics.median(times[1:]),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "launches": launches}
        del params, opt_state
    sh, un = runs[strategy], runs["unsharded"]
    if not max(first["update_norm"].values()) > 0:
        raise AssertionError(f"{cfg.name}: the unsharded step updated no parameter")
    d_loss = [abs(a - b) / abs(b) for a, b in zip(sh["losses"], un["losses"])]
    d_gnorm = [abs(a - b) / b for a, b in zip(sh["gnorms"], un["gnorms"])]
    worst = max(update_err, key=update_err.get)
    print(f"[dist] {cfg.name} {strategy} on mesh {tuple(mesh.mesh.shape)} vs unsharded, "
          f"{DIST_STEPS} steps: losses {sh['losses']} vs {un['losses']} (relative diffs "
          f"{d_loss}), gnorms {sh['gnorms']} vs {un['gnorms']} ({d_gnorm}); limits "
          f"{DIST_FIRST_RTOL} for the first step, then {DIST_LATER_LOSS_RTOL} and "
          f"{DIST_LATER_GNORM_RTOL}; first step: largest parameter diff {param_diff:.3g} "
          f"(limit {DIST_PARAM_ATOL}), largest update diff {update_err[worst]:.3g} of its "
          f"norm ({worst}, limit {DIST_UPDATE_RTOL}); "
          f"later steps {sh['later_step_s']:.4f} s vs {un['later_step_s']:.4f} s "
          f"({sh['later_step_s'] / un['later_step_s']:.3f}x), first {sh['steps_s'][0]:.3f} s "
          f"vs {un['steps_s'][0]:.3f} s; peak {sh['peak_gib']:.3f} vs {un['peak_gib']:.3f} "
          f"GiB; launches {sh['launches']} vs {un['launches']}")
    if not (d_loss[0] <= DIST_FIRST_RTOL and d_gnorm[0] <= DIST_FIRST_RTOL
            and param_diff <= DIST_PARAM_ATOL and update_err[worst] <= DIST_UPDATE_RTOL
            and max(d_loss[1:]) <= DIST_LATER_LOSS_RTOL
            and max(d_gnorm[1:]) <= DIST_LATER_GNORM_RTOL):
        raise AssertionError(f"{cfg.name} {strategy}: the sharded steps disagree with the "
                             f"unsharded ones")
    if sh["launches"] != un["launches"]:
        raise AssertionError(f"{cfg.name} {strategy}: launches {sh['launches']} vs "
                             f"{un['launches']} unsharded")
    return {"strategy": strategy, "sharded": sh, "unsharded": un, "loss_rel_diff": d_loss,
            "gnorm_rel_diff": d_gnorm, "max_param_diff": param_diff,
            "max_update_rel_diff": [worst, update_err[worst]]}, first.get("grads")


def dist_moe_layer(torch, cfg, mesh):
    """One full-width MoE layer of ``cfg`` in fp32 on 4 x 1024 tokens under
    ``dp_tp_moe`` on ``mesh`` against the unsharded layer: with one data
    shard the capacity is the same, so output, aux and the gradients must
    agree to ``check_moe_layer``'s tolerance."""
    from repro_torch.distributed import STRATEGIES, mesh_context, place, shard_params
    from repro_torch.distributed.sharding import full
    from repro_torch.models import Model
    from repro_torch.models.moe import MoE, moe_apply
    gen = torch.Generator(device="cuda").manual_seed(0)
    layer = MoE(cfg.d_model, cfg.moe_d_ff, cfg.n_experts, torch.float32, cfg.shared_d_ff,
                "cuda", gen)
    x = torch.randn((TRAIN["batch"], TRAIN["seq"], cfg.d_model), generator=gen, device="cuda")
    out = {}
    for name in ("unsharded", "dp_tp_moe"):
        ctx = (mesh_context(mesh, STRATEGIES["dp_tp_moe"]) if name != "unsharded"
               else contextlib.nullcontext())
        if name != "unsharded":          # the same weights, placed by the strategy
            with mesh_context(mesh, STRATEGIES["dp_tp_moe"]):
                place(layer, shard_params(layer, Model.logical_axes(layer)))
        layer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with ctx:
            y, aux = moe_apply(layer, x, n_top=cfg.n_experts_per_tok)
            (y.float().square().mean() + aux).backward()
            y, aux = full(y.detach()), float(full(aux.detach()))
        torch.cuda.synchronize()
        out[name] = {"y": y, "aux": aux, "s": time.monotonic() - t0,
                     "grads": {k: full(p.grad).clone() for k, p in layer.named_parameters()}}
    sh, un = out["dp_tp_moe"], out["unsharded"]
    scale = un["y"].abs().max().item()
    err = (sh["y"] - un["y"]).abs().max().item()
    g_err = max(((sh["grads"][k] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item()
                for k, g in un["grads"].items())
    print(f"[dist] {cfg.name} MoE layer under dp_tp_moe on mesh {tuple(mesh.mesh.shape)} vs "
          f"unsharded, fp32, {TRAIN['batch']} x {TRAIN['seq']} tokens: output max|diff| "
          f"{err:.3g} of max|y| {scale:.3g} (limit {MOE_RTOL} of it), aux {sh['aux']:.6f} vs "
          f"{un['aux']:.6f}, gradients {g_err:.3g} of each largest (limit {MOE_RTOL}); "
          f"forward+backward {sh['s']:.4f} s vs {un['s']:.4f} s (first call each)")
    if not (err <= MOE_RTOL * scale and abs(sh["aux"] - un["aux"]) <= MOE_RTOL * abs(un["aux"])
            and g_err <= MOE_RTOL):
        raise AssertionError(f"{cfg.name} sharded MoE layer disagrees with the unsharded one")
    del layer, out
    torch.cuda.empty_cache()
    return {"max_abs_diff": err, "max_abs_y": scale, "aux": [sh["aux"], un["aux"]],
            "grad_rel_diff": g_err, "sharded_s": sh["s"], "unsharded_s": un["s"]}


def dist_compressed(torch, grads):
    """``compressed_grads`` over a gradient tree at world size 1: its time
    (median of 5 calls after one) and its error against the exact mean."""
    from repro_torch.optim import compressed_grads
    compressed_grads(grads)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = compressed_grads(grads)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    rel = max(((out[k].float() - g.float()).abs().max() / g.float().abs().max()
               .clamp(min=1e-30)).item() for k, g in grads.items())
    n = sum(g.numel() for g in grads.values())
    ms = statistics.median(times) * 1e3
    print(f"[dist] compressed_grads over {len(grads)} tensors ({n} values): {ms:.3f} ms "
          f"(median of {times}), error {rel:.3g} of each tensor's largest |g|")
    if not rel < 1e-2:
        raise AssertionError(f"compressed_grads: error {rel:.3g}")
    return {"ms": ms, "times_s": times, "max_rel_err": rel, "n_tensors": len(grads),
            "n_values": n}


def distributed_phase(torch, np, get_config, kernels):
    """Phase 10: the distributed layer on one card over NCCL at world size
    1. Returns its numbers and each kernel's launches on the sharded
    steps."""
    import logging

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    # DTensor notes each reduction over both axes of the mesh as two collectives
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    mesh = make_local_mesh()
    print(f"[dist] {dist.get_backend()} world {dist.get_world_size()}, mesh "
          f"{tuple(mesh.mesh.shape)} over {mesh.mesh_dim_names}")
    K1, K2 = (k["name"] for k in kernels)
    nums = {}
    try:
        dense = get_config("tinyllama-1.1b").replace(use_flash=True)
        nums[dense.name], grads = dist_train_step(torch, np, dense, kernels, mesh, "tp_fsdp",
                                                  keep_grads=True)
        want = {K1: 2 * dense.n_layers, K2: 0}
        if nums[dense.name]["sharded"]["launches"] != want:
            raise AssertionError(f"sharded tinyllama launched "
                                 f"{nums[dense.name]['sharded']['launches']}, expected {want}")
        nums["compressed_grads"] = dist_compressed(torch, grads)
        del grads
        zamba = get_config("zamba2-1.2b").replace(use_flash=True, use_ssd_kernel=True)
        sites = len(range(0, zamba.n_layers, zamba.attn_every))
        nums[zamba.name], _ = dist_train_step(torch, np, zamba, kernels, mesh, "tp_fsdp")
        want = {K1: sites, K2: 2 * zamba.n_layers}
        if nums[zamba.name]["sharded"]["launches"] != want:
            raise AssertionError(f"sharded zamba2 launched "
                                 f"{nums[zamba.name]['sharded']['launches']}, expected {want}")
        nums["qwen2-moe-a2.7b/moe_layer"] = dist_moe_layer(torch, get_config("qwen2-moe-a2.7b"),
                                                           mesh)
    finally:
        dist.destroy_process_group()
    launches = {k["name"]: {arch: nums[arch]["sharded"]["launches"][k["name"]]
                            for arch in ("tinyllama-1.1b", "zamba2-1.2b")} for k in kernels}
    return nums, launches


# phase 11: the dry-run's steps, as cells of (batch, tokens), at world 1:
# phase 7's and 9's train steps and a prefill wave of phase 5
DRYRUN_STEPS = [("tinyllama-1.1b", "train"), ("zamba2-1.2b", "train"),
                ("tinyllama-1.1b", "prefill")]
DRYRUN_CELL = (4, 1024)
# each predicted peak, less the plain attention's score matrices (the card
# runs the kernels: only their backward's recompute makes them, one layer
# at a time), against the measured peak
MEMORY_RTOL = 0.25
DRYRUN_TIMEOUT = 600
DRYRUN_WORLD1 = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.dryrun import fake_mesh, trace_cell
steps, (B, S) = json.loads(sys.argv[1])
mesh = fake_mesh((1, 1), ("data", "model"))
print(json.dumps({f"{arch}/{kind}": trace_cell(get_config(arch), ShapeCell(kind, S, B, kind),
                                               mesh)
                  for arch, kind in steps}))
"""


def _run(args, what):
    """A process of its own, from the checkout's root with ``src`` on its
    path; fails if it does not exit 0. Returns its output."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH")
                               else []))}
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=DRYRUN_TIMEOUT)
    print(f"[{what}] exit {res.returncode} in {time.monotonic() - t0:.1f} s")
    if res.returncode:
        raise AssertionError(f"{what} failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return res.stdout


def dryrun_phase(measured, step_s):
    """Phase 11: the dry-run's predictions against the card, the production
    dry-run on the card's host, the examples on the card. ``measured``:
    ``{arch/kind: peak bytes}`` from phases 5, 7 and 9; ``step_s``: phase
    7's step time. Returns its numbers."""
    recs = json.loads(_run(["-c", DRYRUN_WORLD1, json.dumps([DRYRUN_STEPS, DRYRUN_CELL])],
                           "dryrun world 1").splitlines()[-1])
    nums = {"cell": DRYRUN_CELL, "steps": {}}
    for key, rec in recs.items():
        mem = rec["memory"]
        predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        scores = mem["attention_scores_at_peak_in_bytes"]
        rel = (predicted - scores) / measured[key] - 1
        nums["steps"][key] = {"predicted_bytes": predicted, "scores_bytes": scores,
                              "measured_bytes": measured[key], "rel": rel,
                              "flops": rec["flops"], "trace_s": rec["trace_s"]}
        print(f"[dryrun] {key} {DRYRUN_CELL[0]} x {DRYRUN_CELL[1]}: predicted peak "
              f"{predicted / 2**30:.3f} GiB (arguments {mem['argument_size_in_bytes'] / 2**30:.3f}"
              f" + temp {mem['temp_size_in_bytes'] / 2**30:.3f}), of it the plain attention's "
              f"score matrices {scores / 2**30:.3f} GiB; without them "
              f"{(predicted - scores) / 2**30:.3f} GiB against {measured[key] / 2**30:.3f} GiB "
              f"measured ({rel:+.1%}); traced in {rec['trace_s']} s")
        if abs(rel) > MEMORY_RTOL:
            raise AssertionError(f"{key}: predicted peak off by {rel:+.1%}")
    flops = recs["tinyllama-1.1b/train"]["flops"]
    nums["train_flops_share"] = flops / step_s / PEAK_FLOPS["bfloat16"]
    print(f"[dryrun] tinyllama-1.1b train step: {flops:.4e} flops traced over {step_s:.4f} s "
          f"measured = {flops / step_s / 1e12:.2f} TFLOP/s, "
          f"{nums['train_flops_share']:.1%} of the bf16 dense peak")
    out = _run(["-m", "repro_torch.launch.dryrun", "--arch", "tinyllama-1.1b", "--mesh",
                "single", "--force"], "dryrun 16x16")
    print(out.strip())
    rows = {line.split()[1]: line.split()[3] for line in out.splitlines()
            if line.startswith("tinyllama-1.1b")}
    if rows != {"train_4k": "ok", "prefill_32k": "ok", "decode_32k": "ok",
                "long_500k": "skipped"}:
        raise AssertionError(f"the production dry-run gave {rows}")
    nums["production"] = rows
    for ex in ("serve_batched", "train_with_io_aware_checkpointing"):
        out = _run([str(ROOT / "examples" / "torch" / f"{ex}.py")], f"example {ex}")
        print(out.strip())
    return nums


def prefill_16(torch, np, Model, cfg, kernels, flag, want, limit):
    """Full-width 16-bit prefill of ``cfg`` at ``SHAPE_PREFILL`` on seeded
    weights and tokens: with ``flag`` on (the kernel; launch counts set to 0
    just before and read just after, against ``want``) and off (the plain
    path), then the plain path in fp32 on the same weights cast up. The
    plain 16-bit path's distance from fp32 is the rounding that 16 bits
    carry through the model; the kernel path must lie within ``limit``
    times that distance of the plain 16-bit path (``limit`` None: measure
    only)."""
    B, S = SHAPE_PREFILL
    params = Model(cfg).init(0, device="cuda")
    batch = make_batch(torch, np, cfg, B, S)

    def run(c):
        return Model(c).prefill(params, batch, S)[0].float()
    for k in kernels:
        k["counter"].launches = 0
    lk = run(cfg.replace(**{flag: True}))
    torch.cuda.synchronize()
    launches = counts(kernels)
    lp = run(cfg.replace(**{flag: False}))
    params.float()
    l32 = run(cfg.replace(dtype=torch.float32, **{flag: False}))
    torch.cuda.synchronize()
    d_kp, d_k32, d_p32 = ((a - b).abs().max().item() for a, b in ((lk, lp), (lk, l32), (lp, l32)))
    scale = l32.abs().max().item()
    same_top = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    finite = bool(torch.isfinite(lk).all() and torch.isfinite(lp).all())
    what = f"{cfg.name} {str(cfg.dtype).split('.')[-1]} {cfg.n_layers} layers {flag} B={B} S={S}"
    print(f"[shapes] prefill {what}: kernel vs plain max|diff| {d_kp:.4g}, kernel vs fp32 "
          f"{d_k32:.4g}, plain vs fp32 {d_p32:.4g} (max|logit| {scale:.4g}); kernel vs plain "
          f"{d_kp / d_p32:.3g}x the plain path's 16-bit rounding (limit {limit}); top-1 equal "
          f"in {same_top} of {B}; finite {finite}; launches {launches}")
    if launches != want:
        raise AssertionError(f"{what} launched {launches}, expected {want}")
    if not finite:
        raise AssertionError(f"{what}: non-finite logits")
    if limit is not None and d_kp > limit * d_p32:
        raise AssertionError(f"{what}: kernel and plain path differ by {d_kp:.4g} > {limit} x "
                             f"{d_p32:.4g}")
    del params, lk, lp, l32
    torch.cuda.empty_cache()
    return {"max_abs_diff": d_kp, "kernel_vs_fp32": d_k32, "plain_vs_fp32": d_p32,
            "max_abs_logit": scale, "top1_equal": [same_top, B], "launches": launches}


def serve_greedy(torch, serve_mod, Model, cfg, kernels, flag, want):
    """``serve`` of ``cfg`` (``SHAPE_SERVE``'s traffic) through the kernel,
    its launches against ``want``, then the same serve with the kernel off;
    the greedy tokens must be the same. Returns serve's numbers."""
    got, peak, out = serve_path(torch, serve_mod, Model, cfg.replace(**{flag: True}), kernels,
                                **SHAPE_SERVE)
    if got != want:
        raise AssertionError(f"{cfg.name} serve launched {got}, expected {want}")
    off, _, ref = serve_path(torch, serve_mod, Model, cfg.replace(**{flag: False}), kernels,
                             **SHAPE_SERVE)
    if any(off.values()):
        raise AssertionError(f"{cfg.name} serve with {flag} off launched {off}")
    a = [c["tokens"] for c in out["completions"]]
    b = [c["tokens"] for c in ref["completions"]]
    same = sum(x == y for r, q in zip(a, b) for x, y in zip(r, q))
    total = sum(len(r) for r in b)
    print(f"[shapes] serve {cfg.name} {str(cfg.dtype).split('.')[-1]}: greedy tokens equal "
          f"kernel on vs off at {same} of {total} positions")
    if a != b:
        raise AssertionError(f"{cfg.name}: greedy tokens differ with {flag} on and off")
    keys = ("requests", "new_tokens", "tokens_per_s", "wall_s", "p50_s", "p99_s")
    return {"kernel": {k: out[k] for k in keys}, "plain": {k: ref[k] for k in keys},
            "peak_gib": peak / 2**30, "launches": got, "tokens_equal": [same, total]}


def shapes_phase(torch, np, Model, serve_mod, get_config, ops, attention_ref, ssd_ops,
                 ssd_scan_ref, ssd_scan_tf32_ref, kernels):
    """Phase 12: the kernels at the shapes past the serving ones, then the
    three full-width 16-bit paths. Returns (K1 rows, K2 rows, path numbers,
    each kernel's launches on each path)."""
    K1, K2 = "flash_attention_fwd", "ssd_scan_fwd"
    B, S, H, KV = SHAPE_FLASH
    flash_rows = []
    for hd in SHAPE_HEAD_DIMS:
        for causal in (True, False):
            case = (B, S, H, KV, hd, causal, 0)
            for dtype in FLASH_DTYPES:
                row = check_flash(torch, ops, attention_ref, case, dtype, timed=True)
                flash_rows.append({"case": case, "dtype": dtype, **row})
    flash_rows.append({"case": FLASH_HD256_CASE, "dtype": "bfloat16",
                       **check_flash(torch, ops, attention_ref, FLASH_HD256_CASE, "bfloat16",
                                     timed=True)})
    ssd_rows = [{"case": case, "dtype": dtype,
                 **check_ssd(torch, ssd_ops, ssd_scan_ref, case, dtype,
                             model=None if dtype == "float32" else ssd_scan_tf32_ref)}
                for case, dtype in SHAPE_SSD + [(SSD_CHUNK512_CASE, "bfloat16")]]

    mamba = get_config("mamba2-2.7b")
    tiny = get_config("tinyllama-1.1b")
    per_pass = {"mamba2": {K1: 0, K2: mamba.n_layers}, "tiny": {K1: tiny.n_layers, K2: 0}}
    waves = -(-SHAPE_SERVE["n_requests"] // SHAPE_SERVE["batch"])
    nums, launches = {}, {}
    m16 = mamba.replace(dtype=torch.float16)
    name = "mamba2-2.7b fp16 serve"
    nums[name] = serve_greedy(torch, serve_mod, Model, m16, kernels, "use_ssd_kernel",
                              {K1: 0, K2: waves * mamba.n_layers})
    launches[name] = nums[name]["launches"]
    paths = {"mamba2-2.7b fp16 prefill": (m16, "use_ssd_kernel", per_pass["mamba2"]),
             "mamba2-2.7b chunk 512 bf16 prefill": (mamba.replace(ssm_chunk=512),
                                                    "use_ssd_kernel", per_pass["mamba2"]),
             "tinyllama-1.1b head_dim 256 bf16 prefill": (tiny.replace(head_dim=256),
                                                          "use_flash", per_pass["tiny"])}
    for name, (cfg, flag, want) in paths.items():
        nums[name] = prefill_16(torch, np, Model, cfg, kernels, flag, want,
                                SHAPE_PREFILL_LIMIT)
        launches[name] = nums[name]["launches"]
    return flash_rows, ssd_rows, nums, launches


@contextlib.contextmanager
def grads_checked(torch, train_mod, seen):
    """While open, every AdamW update of ``train`` first checks that each
    parameter has a gradient (raises otherwise) and appends whether all of
    them are finite (a device bool) to ``seen``."""
    update = train_mod.adamw_update

    def checked(grads, named, state, opt):
        missing = [k for k, g in grads.items() if g is None]
        if missing:
            raise AssertionError(f"no gradient for {missing}")
        seen.append(torch.stack([torch.isfinite(g).all() for g in grads.values()]).all())
        return update(grads, named, state, opt)
    train_mod.adamw_update = checked
    try:
        yield
    finally:
        train_mod.adamw_update = update


def wide_phase(torch, np, Model, serve_mod, train_mod, get_config, ops, attention_ref,
               ssd_ops, ssd_scan_ref, ssd_scan_tf32_ref, kernels):
    """Phase 13: K1 past head dim 256 and K2 past state 256 alone, then the
    zoo's last single-card configs and the new shapes on main paths. Returns
    (K1 rows, K2 rows, path numbers, each kernel's launches on each path)."""
    K1, K2 = "flash_attention_fwd", "ssd_scan_fwd"
    flash_rows, ssd_rows, nums, launches = [], [], {}, {}
    for hd in WIDE_HEAD_DIMS:
        for causal in (True, False):
            for dtype in FLASH_DTYPES:
                case = (*SHAPE_FLASH, hd, causal, 0)
                # the fp32 route takes 10-300 ms a call here: fewer repeats
                row = check_flash(torch, ops, attention_ref, case, dtype, timed=True,
                                  reps=5 if dtype == "float32" else 20)
                flash_rows.append({"case": case, "dtype": dtype,
                                   "column_passes": ops.launch_plan(hd)[1], **row})
    for n in WIDE_STATES:
        for dtype in FLASH_DTYPES:
            case = (*WIDE_SSD_CASE, n)
            ssd_rows.append({"case": case, "dtype": dtype, "slices": -(-n // ssd_ops.N_SLICE),
                             **check_ssd(torch, ssd_ops, ssd_scan_ref, case, dtype,
                                         model=None if dtype == "float32"
                                         else ssd_scan_tf32_ref)})
    # the kernels at the shapes the paths below give them, bf16
    for name, case in WIDE_PATH_FLASH.items():
        flash_rows.append({"case": case, "dtype": "bfloat16", "path": name,
                           **check_flash(torch, ops, attention_ref, case, "bfloat16",
                                         timed=True)})
    ssd_rows.append({"case": WIDE_PATH_SSD, "dtype": "bfloat16",
                     "path": "mamba2-2.7b ssm_state 512",
                     **check_ssd(torch, ssd_ops, ssd_scan_ref, WIDE_PATH_SSD, "bfloat16",
                                 model=ssd_scan_tf32_ref)})

    # granite-20b: served whole, bf16, full width and depth (56.3 GB of
    # weights); then cut 52 -> 4 layers for the fp32 prefill check and 2
    # train steps (fp32 at full depth would need 113 GB)
    waves = -(-SERVE["n_requests"] // SERVE["batch"])
    granite = get_config("granite-20b").replace(use_flash=True)
    got, peak, out = serve_path(torch, serve_mod, Model, granite, kernels)
    want = {K1: waves * granite.n_layers, K2: 0}
    if got != want:
        raise AssertionError(f"granite-20b serve launched {got}, expected {want}")
    keys = ("requests", "new_tokens", "tokens_per_s", "wall_s", "p50_s", "p99_s")
    name = "granite-20b serve"
    nums[name] = {**{k: out[k] for k in keys}, "peak_gib": peak / 2**30, "launches": got}
    launches[name] = got
    del out
    cut = WIDE_CUT_LAYERS
    g32 = granite.replace(dtype=torch.float32, n_layers=cut)
    name = f"granite-20b fp32 prefill, {cut} of {granite.n_layers} layers"
    nums[name] = check_prefill(torch, np, Model, g32, kernels, ("use_flash",), {K1: cut, K2: 0},
                               B=TRAIN["batch"])
    launches[name] = nums[name]["launches"]
    for cfg, name in ((granite.replace(n_layers=cut),
                       f"granite-20b train, {cut} of {granite.n_layers} layers"),
                      (get_config("smollm-360m").replace(use_flash=True), "smollm-360m train")):
        seen = []
        with grads_checked(torch, train_mod, seen):
            got, nums[name] = train_steps(torch, train_mod, cfg, kernels, name.replace(" ", "_"),
                                          {K1: (2 if cfg.remat else 1) * cfg.n_layers, K2: 0})
        if len(seen) != 2 or not torch.stack(seen).all():
            raise AssertionError(f"{name}: {len(seen)} updates, a gradient not finite")
        print(f"[wide] {name}: every parameter had a finite gradient in both steps")
        launches[name] = got

    # smollm-360m at full size: serve, the fp32 prefill kernel on against off
    smollm = get_config("smollm-360m").replace(use_flash=True)
    got, peak, out = serve_path(torch, serve_mod, Model, smollm, kernels)
    want = {K1: waves * smollm.n_layers, K2: 0}
    if got != want:
        raise AssertionError(f"smollm-360m serve launched {got}, expected {want}")
    name = "smollm-360m serve"
    nums[name] = {**{k: out[k] for k in keys}, "peak_gib": peak / 2**30, "launches": got}
    launches[name] = got
    del out
    name = "smollm-360m fp32 prefill"
    nums[name] = check_prefill(torch, np, Model, smollm.replace(dtype=torch.float32), kernels,
                               ("use_flash",), {K1: smollm.n_layers, K2: 0})
    launches[name] = nums[name]["launches"]

    # the new shapes on main paths: 16-bit prefills against the plain path
    tiny, mamba = get_config("tinyllama-1.1b"), get_config("mamba2-2.7b")
    paths = {"tinyllama-1.1b head_dim 512 bf16 prefill":
             (tiny.replace(head_dim=512), "use_flash", {K1: tiny.n_layers, K2: 0}),
             "mamba2-2.7b ssm_state 512 bf16 prefill":
             (mamba.replace(ssm_state=512), "use_ssd_kernel", {K1: 0, K2: mamba.n_layers})}
    for name, (cfg, flag, want) in paths.items():
        nums[name] = prefill_16(torch, np, Model, cfg, kernels, flag, want,
                                SHAPE_PREFILL_LIMIT)
        launches[name] = nums[name]["launches"]
    return flash_rows, ssd_rows, nums, launches


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
    serve_launches, serve_peaks = {}, {}
    for arch, (flags, per_pass) in archs.items():
        cfg = get_config(arch).replace(**{f: True for f in flags})
        got, serve_peaks[arch], _ = serve_path(torch, serve_mod, Model, cfg, kernels)
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
        got, _, _ = serve_path(torch, serve_mod, Model, cfg, kernels, **kw)
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

    # 10. the distributed layer over NCCL at world size 1
    dist_nums, sharded_launches = distributed_phase(torch, np, get_config, kernels)

    # 11. the dry-run against the card, its production run, the examples
    measured = {"tinyllama-1.1b/train": train_nums[dense.name]["io_aware"]["peak_gib"] * 2**30,
                "zamba2-1.2b/train": train_nums[hybrid.name]["peak_gib"] * 2**30,
                "tinyllama-1.1b/prefill": serve_peaks["tinyllama-1.1b"]}
    dryrun_nums = dryrun_phase(measured, train_nums[dense.name]["io_aware"]["step_s"])

    # 12. the shapes past the serving ones; three full-width 16-bit paths
    shape_rows = {}
    shape_rows[K1], shape_rows[K2], shape_nums, shape_launches = shapes_phase(
        torch, np, Model, serve_mod, get_config, ops, attention_ref, ssd_ops, ssd_scan_ref,
        ssd_scan_tf32_ref, kernels)

    # 13. past head dim and state 256 alone; granite-20b, smollm-360m and the
    # new shapes on main paths. What the earlier phases held is freed first:
    # granite-20b's weights take 56.3 GB of the card's 80
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[wide] before phase 13: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
          f"allocated, {torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved")
    wide_rows = {}
    wide_rows[K1], wide_rows[K2], wide_nums, wide_launches = wide_phase(
        torch, np, Model, serve_mod, train_mod, get_config, ops, attention_ref, ssd_ops,
        ssd_scan_ref, ssd_scan_tf32_ref, kernels)

    # 14. train numbers, kernel numbers, then the result line
    print(json.dumps({"train": train_nums, "families": family_nums,
                      "distributed": dist_nums, "dryrun": dryrun_nums,
                      "shapes": shape_nums, "wide": wide_nums}))
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": k["route"],
         "source": str(Path(k["path"]).relative_to(ROOT)),
         "replaces": k["replaces"], "launches": launches[k["name"]], **rows[k["name"]],
         "train_launches": train_paths[k["name"]][0], "train_path": train_paths[k["name"]][1],
         "sharded_launches": sharded_launches[k["name"]],
         "shapes": shape_rows[k["name"]],
         "shape_path_launches": {path: n[k["name"]] for path, n in shape_launches.items()},
         "wide": wide_rows[k["name"]],
         "wide_path_launches": {path: n[k["name"]] for path, n in wide_launches.items()},
         "sharded_path": "one tp_fsdp train step of 4 x 1024 tokens on a (1, 1) mesh "
                         "over NCCL, each arch",
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
