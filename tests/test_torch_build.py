"""The port's kernel build cache and the flash and SSD wrappers' routes, on
the CPU (no nvcc needed): a library is named by its source and every header
the source can include, and each dtype a wrapper takes names a source whose
C entry point has the arguments the wrapper passes."""
import re
import shutil
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops

KERNELS = Path(build.__file__).resolve().parent


@pytest.fixture
def tree(tmp_path):
    """A scratch copy of the flash sources and the shared headers."""
    local = tmp_path / "flash_attention" / "csrc"
    shared = tmp_path / "csrc"
    shutil.copytree(KERNELS / "flash_attention" / "csrc", local)
    shutil.copytree(KERNELS / "csrc", shared)
    return local / "flash_fwd_sm90.cu", shared


def test_library_path_is_stable_when_nothing_changes(tree):
    src, shared = tree
    first = build.library_path(src, shared)
    assert build.library_path(src, shared) == first
    assert first.parent == build.BUILD_DIR and first.name.startswith("flash_fwd_sm90-")


@pytest.mark.parametrize("edit", ["source", "shared header", "header beside the source",
                                  "new header beside the source"])
def test_library_path_changes_with_what_the_source_can_include(tree, edit):
    src, shared = tree
    before = build.library_path(src, shared)
    target = {"source": src,
              "shared header": shared / "hopper.cuh",
              "header beside the source": src.parent / "local.cuh",
              "new header beside the source": src.parent / "new.cuh"}[edit]
    if edit == "header beside the source":
        target.write_text("// v1\n")
        before = build.library_path(src, shared)
    target.write_text((target.read_text() if target.exists() else "") + "// edit\n")
    assert build.library_path(src, shared) != before


def test_sources_with_the_shared_header_hash_it():
    src = ops.route(torch.bfloat16)[0]
    assert '#include "hopper.cuh"' in src.read_text()
    assert KERNELS / "csrc" / "hopper.cuh" in build.headers(src)
    assert "-I" in build.NVCC_FLAGS and str(build.SHARED_CSRC) in build.NVCC_FLAGS


@pytest.mark.parametrize("dtype,source", [(torch.bfloat16, "flash_fwd_sm90.cu"),
                                          (torch.float16, "flash_fwd_sm90.cu"),
                                          (torch.float32, "flash_fwd.cu")])
def test_each_accepted_dtype_names_a_source_and_its_entry_point(dtype, source):
    src, name, extra = ops.route(dtype)
    assert src.name == source and src.exists() and src in ops.SOURCES
    sig = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src.read_text())
    assert sig, f"{src.name} has no C entry point {name}"
    args = [a.strip() for a in sig.group(1).split(",")]
    # q, k, v, o (+ the Hopper route's lse); B, S, H, KV, hd, causal, window;
    # the route's extras; the scale (of the unpadded head dim); stream
    n_ptr = 4 + (source == "flash_fwd_sm90.cu")
    assert len(args) == n_ptr + 7 + len(extra) + 2
    assert all("void*" in a for a in args[:n_ptr] + args[-1:])
    assert n_ptr == 4 or args[4] == "void* lse"
    assert all(a.startswith("int ") for a in args[n_ptr:-2])
    assert args[-2].startswith("float ")


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.uint8,
                                   torch.complex64])
def test_other_dtypes_raise(dtype):
    with pytest.raises(ValueError):
        ops.route(dtype)


def test_sources_are_built_once_each():
    """Both forward routes' sources and the backward kernel's."""
    assert len(ops.SOURCES) == len(set(ops.SOURCES)) == 3
    assert ops.BWD_SOURCE in ops.SOURCES


def test_the_backward_source_has_the_entry_point_the_wrapper_calls():
    """flash_bwd_sm90.cu: q, k, v, o, lse, dout, dq, dk, dv and the D
    scratch; B, S, H, KV, hd, causal, window, is_f16; the scale; stream (the
    counts ``ops._launch_bwd`` gives ctypes), built against the shared
    header, and every kernel in it named ``flash_bwd``, none ``flash_fwd``."""
    text = ops.BWD_SOURCE.read_text()
    sig = re.search(r'extern "C" int ' + ops.BWD_ENTRY + r"\(([^)]*)\)", text)
    assert sig and '#include "hopper.cuh"' in text
    args = [a.strip() for a in sig.group(1).split(",")]
    assert len(args) == 10 + 8 + 2
    assert all("void*" in a for a in args[:10] + args[-1:])
    assert all(a.startswith("int ") for a in args[10:-2]) and args[-2].startswith("float ")
    kernels = re.findall(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
                         text)
    assert len(kernels) == 2
    assert all("flash_bwd" in k and "flash_fwd" not in k for k in kernels)
    assert build.library_path(ops.BWD_SOURCE).name.startswith("flash_bwd_sm90-")


@pytest.mark.parametrize("dtype,source,n_ptr", [(torch.bfloat16, "ssd_fwd_sm90.cu", 10),
                                                (torch.float32, "ssd_fwd.cu", 9),
                                                (torch.float16, "ssd_fwd_sm90.cu", 10)])
def test_each_ssd_dtype_names_a_source_and_its_entry_point(dtype, source, n_ptr):
    src, name, extra = ssd_ops.route(dtype)
    assert src.name == source and src.exists() and src in ssd_ops.SOURCES
    assert bool(extra) == (n_ptr == 10)    # the 16-bit route: a CB scratch, x's type
    sig = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src.read_text())
    assert sig, f"{src.name} has no C entry point {name}"
    args = [a.strip() for a in sig.group(1).split(",")]
    # x, dt, B, C, la, D, y, h_last (+ the CB scratch), the scratch of the
    # state slices' parts of y; b, nc, Q, H, P, N; the route's extras; stream
    assert len(args) == n_ptr + 6 + len(extra) + 1
    assert all("void*" in a for a in args[:n_ptr] + args[-1:])
    assert all(a.startswith("int ") for a in args[n_ptr:-1])


@pytest.mark.parametrize("dtype", [torch.int8, torch.float64, torch.int32,
                                   torch.complex64])
def test_other_ssd_dtypes_raise(dtype):
    with pytest.raises(ValueError):
        ssd_ops.route(dtype)


def test_chip_smoke_builds_every_source():
    """chip_smoke.py builds both flash routes and both SSD routes."""
    text = (KERNELS.parents[2] / "chip_smoke.py").read_text()
    assert "sources = [*ops.SOURCES, *ssd_ops.SOURCES]" in text
    assert len(ssd_ops.SOURCES) == len(set(ssd_ops.SOURCES)) == 2
    assert {s.name for s in ssd_ops.SOURCES} == {"ssd_fwd_sm90.cu", "ssd_fwd.cu"}


def test_editing_the_shared_header_renames_both_hopper_libraries(tmp_path):
    """ssd_fwd_sm90.cu includes hopper.cuh like K1's Hopper source, so an edit
    of the header rebuilds both."""
    shared = tmp_path / "csrc"
    shutil.copytree(KERNELS / "csrc", shared)
    srcs = []
    for sub, src in (("flash_attention", ops.route(torch.bfloat16)[0]),
                     ("ssd_scan", ssd_ops.route(torch.bfloat16)[0])):
        assert '#include "hopper.cuh"' in src.read_text()
        local = tmp_path / sub / "csrc"
        shutil.copytree(src.parent, local)
        srcs.append(local / src.name)
    before = [build.library_path(s, shared) for s in srcs]
    (shared / "hopper.cuh").write_text((shared / "hopper.cuh").read_text() + "// edit\n")
    after = [build.library_path(s, shared) for s in srcs]
    assert all(a != b for a, b in zip(after, before))
