"""Where the time of the bf16 SSD-scan kernel (K2, ssd_fwd_sm90.cu) goes, on
one GPU, at the mamba2-2.7b serving shape (b=4, nc=4, Q=256, H=80, P=64,
N=128) with tests/test_torch_ssd.py's inputs. There is no ncu on the card
this was written for, so the script builds patched copies of the source
under build/probe/ (the committed source is not touched):

  python3 scripts/probe_ssd_sm90.py --phases
      clock64() around each phase of the scan kernel, read back per
      consumer warpgroup: mean cycles a block in the prologue (of which
      waiting for the chunk's staged inputs), the inter term, the intra
      term, the epilogue and the state update, and cycles spent waiting on
      the TMA ring;
  python3 scripts/probe_ssd_sm90.py --ablate
      device time of copies with one part removed each (the A-fragment
      builds, the register-A wgmmas, the inter wgmmas, the x conversion,
      the y stores), then all of them. The results are wrong by design and
      the parts overlap, so the differences bound, and do not add up to,
      each part's cost;
  python3 scripts/probe_ssd_sm90.py --stress [--reps 8]
      the committed kernel, through its wrapper, on STRESS shapes (2-4 row
      tiles a chunk, more blocks than SMs, odd N and P, and zamba2-1.2b's
      N = 64 with 256-long chunks), each run --reps times: the count of y
      and h elements outside the bf16 tolerance of the plain version. A race
      between the kernel's warps shows as counts that are not 0 at random.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/ssd_scan/csrc/ssd_fwd_sm90.cu"
OUT = ROOT / "build" / "probe"
CASE = (4, 4, 256, 80, 64, 128)
STRESS = [(1, 2, 128, 140, 64, 128), (2, 3, 128, 100, 64, 64), (1, 3, 128, 100, 64, 64),
          (4, 4, 256, 80, 64, 128), (2, 2, 64, 200, 32, 64), (3, 3, 192, 90, 64, 96),
          (2, 5, 100, 70, 32, 64), (1, 2, 256, 70, 128, 128), (4, 4, 256, 64, 64, 64)]
PHASES = ["total", "prologue", "inputs_wait", "inter", "intra", "epilogue", "state",
          "ring_wait"]

TIMERS = [
    ("__device__ __forceinline__ const uint8_t* consume(uint8_t* ring, uint64_t* full, int n) {\n"
     "  const int s = n % STAGES;\n  mbar_wait(&full[s], (n / STAGES) & 1);",
     "__device__ unsigned long long g_probe[1 << 16];\n__shared__ long long ring_wait[2];\n"
     "__device__ __forceinline__ const uint8_t* consume(uint8_t* ring, uint64_t* full, int n) {\n"
     "  const int s = n % STAGES;\n  const long long t0 = clock64();\n"
     "  mbar_wait(&full[s], (n / STAGES) & 1);\n"
     "  if (threadIdx.x % 128 == 0) ring_wait[threadIdx.x / 128] += clock64() - t0;"),
    ("  int n = 0;                         // position in this warpgroup's ring",
     "  int n = 0;\n  if (wtid == 0) ring_wait[wg] = 0;\n"
     "  long long T[8] = {0, 0, 0, 0, 0, 0, 0, 0}, tp = 0;\n  const long long t_all = clock64();"),
    ("    mbar_wait(in_full, ci & 1);\n    consumer_sync();  // the last chunk is done with every buffer\n",
     "    tp = clock64();\n    mbar_wait(in_full, ci & 1);\n"
     "    consumer_sync();  // the last chunk is done with every buffer\n    T[2] += clock64() - tp;\n"),
    ("      vdt[s] = s < Q ? dts[s] * ex2(lc[min(s | (TILE - 1), Q - 1)] - lc[s]) : 0.f;\n    consumer_sync();\n",
     "      vdt[s] = s < Q ? dts[s] * ex2(lc[min(s | (TILE - 1), Q - 1)] - lc[s]) : 0.f;\n"
     "    consumer_sync();\n    T[1] += clock64() - tp;\n"),
    ("      {  // inter-chunk term", "      tp = clock64();\n      {  // inter-chunk term"),
    ("        n += SPT;\n      }\n", "        n += SPT;\n      }\n      T[3] += clock64() - tp;\n"),
    ("      for (int jt = 0; jt <= it; ++jt) {\n        intra(wa, jt);",
     "      tp = clock64();\n      for (int jt = 0; jt <= it; ++jt) {\n        intra(wa, jt);"),
    ("      fence_regs(acc);\n      // epilogue: + D.x",
     "      fence_regs(acc);\n      T[4] += clock64() - tp;\n      tp = clock64();\n"
     "      // epilogue: + D.x"),
    ("      }\n    }\n\n    // ---- state: h",
     "      }\n      T[5] += clock64() - tp;\n    }\n\n    // ---- state: h"),
    ("    if (has_state) {\n      const float decay",
     "    tp = clock64();\n    if (has_state) {\n      const float decay"),
    ("      fence_regs(hacc);\n    }\n", "      fence_regs(hacc);\n    }\n    T[6] += clock64() - tp;\n"),
    ("  // h_last (b, H, N, P) from this warpgroup's state rows",
     "  if (wtid == 0) {\n    T[0] = clock64() - t_all;\n    T[7] = ring_wait[wg];\n"
     "    unsigned long long* o = g_probe + ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
     " + blockIdx.x) * 16 + wg * 8;\n    for (int i = 0; i < 8; ++i) o[i] = T[i];\n  }\n"
     "  // h_last (b, H, N, P) from this warpgroup's state rows"),
]
READ = ('\nextern "C" int probe_read(void* dst, int bytes) {\n'
        '  return cudaMemcpyFromSymbol(dst, g_probe, bytes);\n}\n')

SKIPS = {
    "BUILD": [("  const uint8_t* row = cbt + r0 * 128 + c * 4;\n  const int g = r0 & 7;\n",
               "  const uint8_t* row = cbt + r0 * 128 + c * 4;\n  const int g = r0 & 7;\n"
               "  if (SKIP_BUILD) { for (int k = 0; k < 32; ++k) a[k / 4][k % 4] = 0u; return; }\n"),
              ("  uint32_t off[2][2];\n  bool ok[2];\n",
               "  if (SKIP_BUILD) { for (int k = 0; k < 32; ++k) a[k / 4][k % 4] = 0u; return; }\n"
               "  uint32_t off[2][2];\n  bool ok[2];\n")],
    "MMA": [("  for (int kk = 0; kk < 8; ++kk) MmaTf32<PT>::rs(",
             "  for (int kk = 0; kk < (SKIP_MMA ? 0 : 8); ++kk) MmaTf32<PT>::rs(")],
    "INTER": [("          for (int kk = 0; kk < (NA < 2 ? 4 : 8); ++kk)",
               "          for (int kk = 0; kk < (SKIP_INTER ? 0 : (NA < 2 ? 4 : 8)); ++kk)")],
    "CONV": [("      const int items = (QT / 32) * PB;",
              "      const int items = SKIP_CONV ? 0 : (QT / 32) * PB;")],
    "STORE": [("        if (wtid == 0) {\n          tma_store_4d",
               "        if (wtid == 0 && !SKIP_STORE) {\n          tma_store_4d")],
}


def patched(pairs, text):
    for old, new in pairs:
        if text.count(old) != 1:
            raise SystemExit(f"probe: anchor not found once in {SRC.name}: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build(name, text, flags=()):
    from repro_torch.kernels import build as kb
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    res = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, *flags, "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{res.stderr[-3000:]}")
    return lib


def caller(torch, lib_path):
    """The C entry point of ``lib_path`` on the slice's inputs, as a thunk."""
    from test_torch_ssd import as_torch, inputs
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.ssd_fwd_sm90
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    b, nc, Q, H, P, N = CASE
    args = as_torch(inputs(CASE), "bfloat16", "cuda")
    outs = [torch.empty((b, nc * Q, H, P), dtype=torch.bfloat16, device="cuda"),
            torch.empty((b, H, N, P), device="cuda"),
            torch.empty((b * nc, 256, 256), device="cuda")]
    ptrs = [t.data_ptr() for t in (*args, *outs)]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(*ptrs, b, nc, Q, H, P, N, stream)
        if err:
            raise RuntimeError(f"ssd_fwd_sm90: CUDA error {err}")
    return lib, call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--stress", action="store_true")
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_ssd_sm90: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]
    import chip_smoke
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    text = SRC.read_text()
    if args.stress:
        from repro_torch.kernels.ssd_scan import ops, ssd_scan_ref
        from test_torch_ssd import as_torch, inputs
        for case in STRESS:
            a = as_torch(inputs(case), "bfloat16", "cuda")
            ry, rh = ssd_scan_ref(*a)
            bad = []
            for _ in range(args.reps):
                y, h = ops.ssd_scan(*a)
                torch.cuda.synchronize()
                bad.append((int(((y.float() - ry.float()).abs()
                                 > 0.05 + 0.05 * ry.float().abs()).sum()),
                            int(((h - rh).abs() > 0.05 + 0.05 * rh.abs()).sum())))
            print(f"[stress] b,nc,Q,H,P,N={case}: (y, h) elements out of tolerance "
                  f"a run {bad}")
    if args.phases:
        lib, call = caller(torch, build("phases", patched(TIMERS, text) + READ))
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        b, nc, Q, H, P, N = CASE
        blocks = b * H * (P // 64)
        buf = np.zeros(blocks * 16, np.uint64)
        if lib.probe_read(ctypes.c_void_p(buf.ctypes.data), ctypes.c_int(buf.nbytes)):
            raise RuntimeError("probe_read failed")
        cyc = buf.reshape(blocks, 2, 8).astype(np.float64).mean(axis=0)
        for wg in range(2):
            print(f"[phases] warpgroup {wg}, mean cycles a block: "
                  + ", ".join(f"{k} {v:.0f}" for k, v in zip(PHASES, cyc[wg])))
        print(f"[phases] instrumented device_ms {chip_smoke.device_ms(torch, call):.4f}")
    if args.ablate:
        variants = {"none": []} | {k: [k] for k in SKIPS} | {"all": list(SKIPS)}
        pairs = [p for k in SKIPS for p in SKIPS[k]]
        src = patched(pairs, text)
        with ThreadPoolExecutor(len(variants)) as ex:
            libs = dict(zip(variants, ex.map(
                lambda v: build(f"skip_{v}", src, [f"-DSKIP_{k}={int(k in variants[v])}"
                                                   for k in SKIPS]), variants)))
        for v, lib_path in libs.items():
            _, call = caller(torch, lib_path)
            print(f"[ablate] without {v}: device_ms "
                  f"{chip_smoke.device_ms(torch, call):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
