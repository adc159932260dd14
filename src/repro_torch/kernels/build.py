"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface, so ``nvcc`` builds it into
a shared library in seconds (PyTorch's headers are never included). The
library lands in ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of its source, so an edited source is
rebuilt and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "host with the CUDA toolkit")
    return nvcc


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


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
