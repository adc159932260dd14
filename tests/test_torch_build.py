"""The port's kernel build cache and the flash wrapper's routes, on the CPU
(no nvcc needed): a library is named by its source and every header the
source can include, and each dtype the wrapper takes names a source whose
C entry point has the arguments the wrapper passes."""
import re
import shutil
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops

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
    # q, k, v, o; B, S, H, KV, hd, causal, window; the route's extras; stream
    assert len(args) == 4 + 7 + len(extra) + 1
    assert all("void*" in a for a in args[:4] + args[-1:])
    assert all(a.startswith("int ") for a in args[4:-1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.uint8,
                                   torch.complex64])
def test_other_dtypes_raise(dtype):
    with pytest.raises(ValueError):
        ops.route(dtype)


def test_sources_are_built_once_each():
    assert len(ops.SOURCES) == len(set(ops.SOURCES)) == 2
