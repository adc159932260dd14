"""Build the port's CUDA sources at first use, load them with ctypes, and
launch their C entry points: the one launch path of every kernel.

Each ``csrc/*.cu`` file has a plain C interface, so ``nvcc`` builds it into
a shared library in seconds (PyTorch's headers are never included). A
source may include the headers beside it and the shared Hopper helpers in
``kernels/csrc/`` (``hopper.cuh``). The library lands in ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``), named by a hash of
its source and of every header it can include, so an edited source or
header is rebuilt and an unchanged one is loaded as it is.

Every entry point takes the stream last and returns 0 or a CUDA error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SHARED_CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-I", str(SHARED_CSRC)]

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "host with the CUDA toolkit")
    return nvcc


def headers(source: Path, shared: Path = SHARED_CSRC) -> list[Path]:
    """Every header ``source`` can include: those beside it and the shared
    ones, in a fixed order."""
    dirs = dict.fromkeys((Path(source).resolve().parent, Path(shared).resolve()))
    return [h for d in dirs for h in sorted(d.glob("*.cuh"))]


def library_path(source: Path, shared: Path = SHARED_CSRC) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes())
    for h in headers(source, shared):
        digest.update(h.name.encode() + b"\0" + h.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:12]}.so"


def build(source: Path, verbose: bool = False) -> tuple[Path, str]:
    """Compile ``source`` unless its library is already there; returns the
    library and the compiler's output ("" when nothing was built). With
    ``verbose`` ptxas reports registers, shared memory and spills."""
    source = Path(source)
    out = library_path(source)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def load(source: Path) -> ctypes.CDLL:
    """The library built from ``source``, built and loaded once per process."""
    key = str(source)
    if key not in _LOADED:
        _LOADED[key] = ctypes.CDLL(str(build(source)[0]))
    return _LOADED[key]


def entry(source: Path, name: str, argtypes: tuple):
    """The C entry point ``name`` of ``source``'s library, its ``argtypes``
    (``argtypes``, then the stream pointer) and ``restype`` (int) set once
    per process."""
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(fn, name: str, device, *args) -> None:
    """The C entry point ``fn(*args, stream)`` on ``device`` and its current
    stream; RuntimeError naming ``name`` on its non-zero return (a CUDA
    error). The device is made current first: autograd's device threads,
    where a backward (and, under remat, its forward) runs, have a CUDA
    context current only after PyTorch's first kernel there, and the
    library's own runtime refuses a launch before that."""
    with torch.cuda.device(device):
        torch.cuda.set_device(device)
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
