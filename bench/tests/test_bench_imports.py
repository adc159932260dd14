"""Nothing the benchmark runs loads JAX, the JAX package ``repro`` or the
JAX package's ``benchmarks/``, compared by whole top-level module name."""
import ast
import subprocess
import sys

import pytest

from bench.lib import harness

FILES = sorted(p for p in harness.BENCH.rglob("*.py") if "tests" not in p.parts)
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_banned_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops = [node.module.split(".")[0]]
        else:
            continue
        assert not BANNED & set(tops), (path, tops)


def test_whole_names_are_compared():
    assert "repro_torch".split(".")[0] not in harness.FORBIDDEN
    assert "repro.models".split(".")[0] in harness.FORBIDDEN


def test_a_run_loads_nothing_banned():
    """A whole tiny run of every driver in a fresh process, then sys.modules."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from bench.tests.tiny import cpu_run\n"
        "from bench.lib import harness\n"
        "import importlib\n"
        "for m in harness.manifest()['per_layer']: harness.metric_reader(m['name'])\n"
        "cpu_run('smollm-360m.train_ckpt', seconds=0.5)\n"
        "cpu_run('mamba2-2.7b.serve_long', seconds=0.5)\n"
        "bad = sorted({m for m in sys.modules if m.split('.')[0] in %r})\n"
        "print('BANNED', bad)\n" % (str(harness.ROOT), str(harness.ROOT / "src"), BANNED))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BANNED []" in out.stdout, out.stdout[-2000:]
