"""The multi-tensor AdamW kernels (``kernels/adamw``) and the dispatch of
``optim.adamw_update``. On the CPU: CPU and ``meta`` trees take the plain
loop and the ``optim.adamw`` span counts them, nothing is built before a
launch is asked for, the leaf table refuses what the kernels do not take,
and the wrapper's entry points and constants are the source's. The tests
marked ``cuda`` hold the kernels against the plain loop on the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_adamw_kernel.py``."""
import ctypes
import re
import threading

import pytest
import torch

from repro_torch.core import Cluster, IORuntime, RealBackend, StorageDevice, WorkerNode
from repro_torch.kernels import build
from repro_torch.kernels.adamw import ops
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, adamw_update_plain

DTYPES = {"bfloat16": [torch.bfloat16], "float16": [torch.float16],
          "float32": [torch.float32],
          "mixed": [torch.bfloat16, torch.float16, torch.float32]}
# sizes of the leaves: one element, a ragged vector group, a norm weight,
# past a norm chunk with a ragged end
SIZES = (1, 7, 960, 2**20 + 3)
NO_CLIP = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.0)
CLIP = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0)


def make_tree(sizes, dtypes, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return {f"l{i}": torch.randn(n, generator=g, device=device).to(dtypes[i % len(dtypes)])
            for i, n in enumerate(sizes)}


def grads_like(params, step):
    g = torch.Generator(device=next(iter(params.values())).device).manual_seed(100 + step)
    return {k: torch.randn(p.shape, generator=g, device=p.device).to(p.dtype)
            for k, p in params.items()}


def clone(tree):
    return {k: t.clone() for k, t in tree.items()}


def run(update, params, kw, steps=3):
    """``steps`` updates of ``params`` (in place) from fresh moments; the
    final state and each step's gnorm."""
    state, cfg, norms = adamw_init(params), AdamWConfig(**kw), []
    for i in range(steps):
        _, state, gnorm = update(grads_like(params, i), params, state, cfg)
        norms.append(gnorm)
    return state, norms


def bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def bit_equal(a: dict, b: dict) -> list:
    """The keys whose tensors differ in any bit."""
    return [k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]


def cluster():
    dev = StorageDevice(name="fs", bandwidth=2000, per_stream_cap=500)
    return Cluster(workers=[WorkerNode(name="w0", cpus=2, io_executors=4, storage=dev)])


@pytest.fixture
def no_build(monkeypatch):
    """Fails any attempt to build or load a kernel library."""
    def refuse(*a, **k):
        raise AssertionError("a kernel library was asked for")
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(ops, "entry", refuse)


@pytest.mark.parametrize("clip", [False, True], ids=["no-clip", "clip"])
@pytest.mark.parametrize("dtypes", list(DTYPES), ids=list(DTYPES))
def test_cpu_trees_take_the_plain_loop(no_build, dtypes, clip):
    """On the CPU ``adamw_update`` is the plain loop: p, m, v and gnorm equal
    ``adamw_update_plain``'s bit for bit over 3 steps, with no library."""
    kw = CLIP if clip else NO_CLIP
    a = make_tree((5, 7, 960), DTYPES[dtypes], "cpu")
    b = clone(a)
    sa, na = run(adamw_update, a, kw)
    sb, nb = run(adamw_update_plain, b, kw)
    assert not bit_equal(a, b) and not bit_equal(sa.m, sb.m) and not bit_equal(sa.v, sb.v)
    assert all(torch.equal(bits(x), bits(y)) for x, y in zip(na, nb))
    assert int(sa.count) == 3


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_the_span_counts_plain_leaves(no_build, device):
    params = make_tree((3, 4, 5, 0), [torch.bfloat16, torch.float32], "cpu")
    params = {k: p.to(device) for k, p in params.items()}
    state = adamw_init(params)
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    with IORuntime(cluster(), backend=RealBackend(), trace=True) as rt:
        adamw_update(grads, params, state, AdamWConfig())
    (sp,) = [e for e in rt.trace().events if e["type"] == "span" and e["name"] == "optim.adamw"]
    assert sp["args"]["plain_leaves"] == 4 and sp["args"]["fused_leaves"] == 0


def test_import_and_plain_trees_build_nothing():
    params = make_tree((3, 4), [torch.float32], "cpu")
    adamw_update(grads_like(params, 0), params, adamw_init(params), AdamWConfig())
    assert str(ops.SOURCE) not in build._LOADED


def test_the_table_refuses_cpu_leaves_before_any_build(no_build):
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ops.table([(p, p.clone(), p.clone(), p.clone())])


def bad_leaf(kind):
    p, z = torch.zeros(8, dtype=torch.bfloat16), torch.zeros(8)
    leaf = {"p": p, "g": p.clone(), "m": z, "v": z.clone()}
    change = {"p float64": ("p", torch.zeros(8, dtype=torch.float64)),
              "g int32": ("g", torch.zeros(8, dtype=torch.int32)),
              "m bf16": ("m", torch.zeros(8, dtype=torch.bfloat16)),
              "v shorter": ("v", torch.zeros(7)),
              "p strided": ("p", torch.zeros(16, dtype=torch.bfloat16)[::2]),
              "g strided": ("g", torch.zeros(8, 2, dtype=torch.bfloat16)[:, 0]),
              "m shorter": ("m", torch.zeros(9))}[kind]
    leaf[change[0]] = change[1]
    return leaf["p"], leaf["g"], leaf["m"], leaf["v"]


@pytest.mark.parametrize("kind,msg", [
    ("p float64", "p and g must be bf16, fp16 or fp32"), ("g int32", "p and g must be"),
    ("m bf16", "the moments fp32"), ("v shorter", "elements"),
    ("p strided", "must be contiguous"), ("g strided", "must be contiguous"),
    ("m shorter", "elements")])
def test_the_leaf_table_refuses(kind, msg):
    good = (torch.zeros(4),) * 4
    with pytest.raises(ValueError, match=msg):
        ops._rows([good, bad_leaf(kind)])


def test_the_leaf_table_rows():
    """Rows of p, g, m, v, numel and the two dtype tags, empty leaves left
    out; the norm's partials are one a NORM_CHUNK of each leaf."""
    leaves = []
    for n, pd, gd in ((5, torch.bfloat16, torch.bfloat16), (0, torch.float32, torch.float32),
                      (ops.NORM_CHUNK + 1, torch.float16, torch.float32)):
        leaves.append((torch.zeros(n, dtype=pd), torch.zeros(n, dtype=gd), torch.zeros(n),
                       torch.zeros(n)))
    rows, n, dev, partials = ops._rows(leaves)
    assert (n, dev, partials) == (2, torch.device("cpu"), 1 + 2)
    want = []
    for p, g, m, v in (leaves[0], leaves[2]):
        want += [p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                 ops.DTYPES[p.dtype], ops.DTYPES[g.dtype]]
    assert list(rows) == want


C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("decl", [ops.NORM, ops.UPDATE], ids=lambda d: d[1])
def test_each_entry_point_has_the_argument_types_the_wrapper_declares(decl):
    source, name, sig = decl
    text = source.read_text()
    proto = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert proto, f"{source.name} has no C entry point {name}"
    args = [re.sub(r"^const ", "", a.strip()).rsplit(" ", 1) for a in proto.group(1).split(",")]
    assert [C_TYPES[t] for t, _ in args] == [*sig, ctypes.c_void_p]
    assert args[-1][1] == "stream" and source in ops.SOURCES


def test_the_wrapper_mirrors_the_sources_constants():
    text = ops.SOURCE.read_text()
    const = dict(re.findall(r"constexpr (?:int|long long) (\w+) = (\d+);", text))
    assert int(const["MAX_LEAVES"]) == ops.MAX_LEAVES
    assert int(const["NORM_CHUNK"]) == ops.NORM_CHUNK
    assert int(const["ROW"]) == 7
    enum = re.search(r"enum Dtype : int \{ F32 = 0, BF16 = 1, F16 = 2 \};", text)
    assert enum and ops.DTYPES == {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    assert "__fmul_rn" in text and "__fdiv_rn" in text and "__fsqrt_rn" in text


@pytest.mark.parametrize("n,want", [(0, (1, 0)), (1, (2, 1)), (290, (2, 1)), (512, (2, 1)),
                                    (513, (3, 2)), (1500, (4, 3))])
def test_launch_counts(n, want):
    assert ops.launches(n) == want


@pytest.mark.parametrize("copies,want", [
    # plain tensors: one group, one launch
    ({"a": 0, "b": 0, "c": 0}, [["a", "b", "c"]]),
    # a few small copies (Partial gradients of norm weights) share one group
    ({"a": 0, "b": 8, "c": 0, "d": 8}, [["a", "c"], ["b", "d"]]),
    # every leaf copied (OPT_RULES moments): groups within the budget, 4 x the
    # largest leaf's 10 elements
    ({"a": 30, "b": 20, "c": 20, "d": 40, "e": 0}, [["e"], ["a"], ["b", "c"], ["d"]]),
])
def test_leaves_that_are_copied_take_groups_within_the_loops_copy(monkeypatch, copies, want):
    """``_groups``: the leaves taken as they are in one launch, then the
    copied ones in groups whose copies hold at most the plain loop's fp32
    copy of the largest leaf."""
    from repro_torch.optim import adamw as adamw_mod
    params = {k: torch.zeros(10 if k == "a" else 5) for k in copies}
    monkeypatch.setattr(adamw_mod, "_copies", lambda p, g, m: copies[key[id(p)]])
    key = {id(p): k for k, p in params.items()}
    assert adamw_mod._groups(params, params, params) == want


def test_plain_tensors_have_no_copies():
    from repro_torch.optim.adamw import _copies
    t = torch.zeros(4)
    assert _copies(t, t, t) == 0


def test_chip_smoke_checks_the_kernels():
    """chip_smoke.py checks and times the kernels at smollm-360m's tree and
    puts the row in its kernels line."""
    text = (build.BUILD_DIR.parents[1] / "chip_smoke.py").read_text()
    assert "adamw_row = check_adamw(torch, adamw_ops, get_config)" in text
    assert '"smollm-360m": adamw_row' in text


# -- on the card -------------------------------------------------------------

def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def misaligned(size, dtypes, seed=0):
    """Leaves that start one element into their buffers (2 or 4 bytes off
    16-byte alignment), moments too."""
    tree = make_tree([size + 1] * len(dtypes), dtypes, "cuda", seed)
    return {k: t[1:] for k, t in tree.items()}


def run_sliced(update, params, kw, steps=3):
    """``run`` with moments that also start off alignment."""
    zeros = {k: torch.zeros(p.numel() + 1, device=p.device)[1:] for k, p in params.items()}
    state = adamw_init(params)
    state = state._replace(m=zeros, v={k: z.clone() for k, z in zeros.items()})
    cfg = AdamWConfig(**kw)
    for i in range(steps):
        _, state, _ = update(grads_like(params, i), params, state, cfg)
    return state


@pytest.mark.cuda
@pytest.mark.parametrize("size", [*SIZES, "misaligned"], ids=str)
@pytest.mark.parametrize("dtypes", list(DTYPES), ids=list(DTYPES))
def test_kernel_update_is_bit_equal_to_the_plain_loop(dtypes, size):
    """Clipping off: 3 steps through the kernels give p, m and v equal to the
    plain loop's bit for bit, in 2 norm + 1 update launches a step."""
    cuda_or_skip()
    types = DTYPES[dtypes]
    if size == "misaligned":
        a, b = misaligned(1000, types), misaligned(1000, types)
        ops.norm.launches = ops.update.launches = 0
        sa, sb = run_sliced(adamw_update, a, NO_CLIP), run_sliced(adamw_update_plain, b, NO_CLIP)
    else:
        a = make_tree([size] * 3, types, "cuda")
        b = clone(a)
        ops.norm.launches = ops.update.launches = 0
        (sa, _), (sb, _) = run(adamw_update, a, NO_CLIP), run(adamw_update_plain, b, NO_CLIP)
    torch.cuda.synchronize()
    assert (ops.norm.launches, ops.update.launches) == (6, 3)
    assert not bit_equal(a, b), "p"
    assert not bit_equal(sa.m, sb.m), "m"
    assert not bit_equal(sa.v, sb.v), "v"


@pytest.mark.cuda
def test_kernel_update_on_smollm_360m_tree_is_bit_equal():
    """The 290 leaves of smollm-360m (bf16 matrices, fp32 norm weights; 361.8 M
    parameters), 3 steps with clipping off."""
    cuda_or_skip()
    from repro_torch.configs import get_config
    from repro_torch.models.model import model_class
    cfg = get_config("smollm-360m")
    a = dict(model_class(cfg)(cfg, torch.device("cuda"), None).state_dict())
    assert len(a) == 290
    b = clone(a)
    (sa, _), (sb, _) = run(adamw_update, a, NO_CLIP), run(adamw_update_plain, b, NO_CLIP)
    assert not bit_equal(a, b) and not bit_equal(sa.m, sb.m) and not bit_equal(sa.v, sb.v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", ["bfloat16", "mixed"])
def test_clipped_norm_is_close_and_deterministic(dtypes):
    """Clipping on: the kernels' gnorm within 1e-6 of ``global_norm``'s, and
    two runs from the same tree equal bit for bit."""
    cuda_or_skip()
    sizes = [*SIZES, 3 * 2**20, 49152 * 96]
    a = make_tree(sizes, DTYPES[dtypes], "cuda")
    b, c = clone(a), clone(a)
    sa, na = run(adamw_update, a, CLIP)
    sb, nb = run(adamw_update, b, CLIP)
    _, nc = run(adamw_update_plain, c, CLIP)
    assert all(torch.equal(x, y) for x, y in zip(na, nb))
    assert not bit_equal(a, b) and not bit_equal(sa.m, sb.m) and not bit_equal(sa.v, sb.v)
    for x, y in zip(na, nc):
        assert abs(float(x) - float(y)) <= 1e-6 * float(y), (float(x), float(y))


@pytest.mark.cuda
def test_kernels_launch_from_a_new_thread():
    """A fresh host thread has no CUDA context current; ``build.launch``
    makes the device current, so the kernels run there and give what they
    give on the main thread."""
    cuda_or_skip()
    want = make_tree(SIZES, DTYPES["mixed"], "cuda")
    got = clone(want)
    want_state, want_norms = run(adamw_update, want, CLIP)
    torch.cuda.synchronize()
    out = {}

    def body():
        try:
            out["state"], out["norms"] = run(adamw_update, got, CLIP)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001  (re-raised on the main thread)
            out["err"] = e

    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    if "err" in out:
        raise out["err"]
    assert not bit_equal(got, want) and not bit_equal(out["state"].m, want_state.m)
    assert all(torch.equal(x, y) for x, y in zip(out["norms"], want_norms))
