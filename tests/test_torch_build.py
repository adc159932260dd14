"""The port's kernel build cache, its launch path and the flash and SSD
wrappers' routes, on the CPU (no nvcc needed): a library is named by its
source and every header the source can include, each dtype a wrapper takes
names a source whose C entry point has the argument types the wrapper
declares, and ``build.launch`` makes the device current before it calls.
The test marked ``cuda`` launches both kernels from a new thread on the
card: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_build.py``."""
import contextlib
import ctypes
import re
import shutil
import threading
from pathlib import Path
from types import SimpleNamespace

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


C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


def prototype(source, name):
    """[(ctypes type, argument name)] of the C entry point ``name`` in
    ``source``, ``const`` dropped."""
    sig = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", source.read_text())
    assert sig, f"{source.name} has no C entry point {name}"
    args = [re.sub(r"^const ", "", a.strip()).rsplit(" ", 1) for a in sig.group(1).split(",")]
    return [(C_TYPES[t], n) for t, n in args]


@pytest.mark.parametrize("kernel,dtype,source", [
    ("flash", torch.bfloat16, "flash_fwd_sm90.cu"), ("flash", torch.float16, "flash_fwd_sm90.cu"),
    ("flash", torch.float32, "flash_fwd.cu"), ("flash", "backward", "flash_bwd_sm90.cu"),
    ("ssd", torch.bfloat16, "ssd_fwd_sm90.cu"), ("ssd", torch.float32, "ssd_fwd.cu"),
    ("ssd", torch.float16, "ssd_fwd_sm90.cu")], ids=lambda v: str(v).replace("torch.", ""))
def test_each_entry_point_has_the_argument_types_the_wrapper_declares(kernel, dtype, source):
    """Each route's source (and the backward kernel's) holds its C entry
    point, whose arguments are, type by type, those the wrapper declares,
    then the stream. A route's extra int is the prototype's ``is_f16``, and
    the 16-bit flash forward takes ``lse`` after ``o``."""
    mod = {"flash": ops, "ssd": ssd_ops}[kernel]
    if dtype == "backward":
        (src, name, sig), extra = (ops.BWD_SOURCE, ops.BWD_ENTRY, ops.BWD_ARGS), ()
    else:
        src, name, sig, extra = mod.route(dtype)
    assert src.name == source and src.exists() and src in mod.SOURCES
    args = prototype(src, name)
    assert [t for t, _ in args] == [*sig, ctypes.c_void_p] and args[-1][1] == "stream"
    names = [n for _, n in args]
    if dtype != "backward":
        assert extra == ((int(dtype == torch.float16),) if "is_f16" in names else ())
    if kernel == "flash" and dtype != "backward":
        assert names[3] == "o" and ("lse" not in names or names[4] == "lse")
        assert ("lse" in names) == ("sm90" in source)


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
    """flash_bwd_sm90.cu holds the C entry point ``ops._launch_bwd`` calls
    (its argument types are checked with the other entry points'), built
    against the shared header, and every kernel in it named ``flash_bwd``,
    none ``flash_fwd``."""
    text = ops.BWD_SOURCE.read_text()
    assert re.search(r'extern "C" int ' + ops.BWD_ENTRY + r"\(", text)
    assert '#include "hopper.cuh"' in text
    kernels = re.findall(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
                         text)
    assert len(kernels) == 2
    assert all("flash_bwd" in k and "flash_fwd" not in k for k in kernels)
    assert build.library_path(ops.BWD_SOURCE).name.startswith("flash_bwd_sm90-")


@pytest.mark.parametrize("dtype", [torch.int8, torch.float64, torch.int32,
                                   torch.complex64])
def test_other_ssd_dtypes_raise(dtype):
    with pytest.raises(ValueError):
        ssd_ops.route(dtype)


def test_chip_smoke_builds_every_source():
    """chip_smoke.py builds both flash routes, both SSD routes and AdamW's
    kernels."""
    text = (KERNELS.parents[2] / "chip_smoke.py").read_text()
    assert "sources = [*ops.SOURCES, *ssd_ops.SOURCES, *adamw_ops.SOURCES]" in text
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


@pytest.mark.parametrize("err", [0, 700])
def test_launch_makes_the_device_current_then_calls_and_raises_on_an_error(monkeypatch, err):
    """``build.launch`` enters the device, makes it current, calls the entry
    point with its current stream last, and raises RuntimeError naming the
    entry point on a non-zero return."""
    calls = []
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: calls.append(("device", d)) or contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=1234))

    def fn(*args):
        calls.append(("fn", args))
        return err

    with pytest.raises(RuntimeError, match="an_entry: CUDA error 700") if err \
            else contextlib.nullcontext():
        build.launch(fn, "an_entry", "cuda:1", 5, 6.0)
    assert calls == [("device", "cuda:1"), ("set_device", "cuda:1"), ("fn", (5, 6.0, 1234))]


def test_entry_binds_the_argument_types_and_the_stream_once(monkeypatch):
    """``build.entry`` sets the declared types, then the stream pointer, and
    an int return on the library's function, once."""
    fn = SimpleNamespace(argtypes=None, restype=None)
    monkeypatch.setattr(build, "load", lambda source: SimpleNamespace(an_entry=fn))
    sig = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float)
    assert build.entry("x.cu", "an_entry", sig) is fn
    assert fn.argtypes == [*sig, ctypes.c_void_p] and fn.restype is ctypes.c_int
    fn.argtypes = marker = [ctypes.c_int]
    assert build.entry("x.cu", "an_entry", sig).argtypes is marker


def _ssd_call():
    b, nc, Q, H, P, N = 2, 2, 64, 4, 32, 16
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(s, device="cuda", generator=g)
    dt = torch.nn.functional.softplus(rnd(b, nc, Q, H))
    args = (rnd(b, nc, Q, H, P).to(torch.bfloat16) * 0.5, dt, rnd(b, nc, Q, N),
            rnd(b, nc, Q, N), dt * -torch.exp(rnd(H) * 0.2), 1 + 0.1 * rnd(H))
    return lambda: ssd_ops.ssd_scan(*args)


def _flash_call():
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 128, 4, 64), device="cuda", generator=g,
                           dtype=torch.float32).to(torch.bfloat16) for _ in range(3))
    return lambda: (ops.flash_attention(q, k, v, True, 0),)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["ssd_scan", "flash_attention"])
def test_cuda_kernel_launches_from_a_new_thread(kernel):
    """A new host thread has no CUDA context current, and the libraries'
    own runtime refuses a launch there (CUDA error 1 on an H100) unless the
    device is made current first, as ``build.launch`` does: so the kernel
    runs and gives, bit for bit, what it gives on the main thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    call = {"ssd_scan": _ssd_call, "flash_attention": _flash_call}[kernel]()
    want = call()
    torch.cuda.synchronize()
    got = {}

    def run():
        try:
            got["out"] = call()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001  (re-raised on the main thread)
            got["err"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    if "err" in got:
        raise got["err"]
    assert all(torch.equal(a, b) for a, b in zip(got["out"], want, strict=True))
