"""The port's int8 gradient compression (repro_torch.optim.compression)
against the JAX package's: tests/test_compression.py's cases on the port,
the quantisation bit for bit on the same numpy inputs, and
``compressed_psum`` over 8 gloo ranks against the JAX ``compressed_psum``
under ``shard_map`` on 8 faked XLA host devices."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis_support import given, settings, st

from repro_torch.optim.compression import dequantize_int8, quantize_int8

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
# (seed, shape, scale): the inputs held bit for bit against the reference
QUANT_CASES = [(0, (64,), 1.0), (1, (64,), 1e-3), (2, (64,), 1e3), (3, (8, 32), 1.0),
               (4, (3, 5, 7), 37.5), (5, (1,), 2.0), (6, (1000,), 1e-6)]


def _normal(seed, shape, scale):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# --------------------------------------------- tests/test_compression.py's
@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**31 - 1), st.floats(1e-3, 1e3))
def test_quant_roundtrip_error_bound(seed, scale):
    g = torch.from_numpy(_normal(seed, (64,), scale))
    q, s = quantize_int8(g)
    back = dequantize_int8(q, s)
    # absmax quantisation: error <= scale/2 = absmax/254 per element
    bound = float(g.abs().max()) / 254.0 + 1e-9
    assert float((back - g).abs().max()) <= bound * 1.01


def test_quant_roundtrip_error_bound_deterministic():
    for seed, scale in ((0, 1.0), (1, 1e-3), (2, 1e3)):
        g = torch.from_numpy(_normal(seed, (64,), scale))
        q, s = quantize_int8(g)
        back = dequantize_int8(q, s)
        bound = float(g.abs().max()) / 254.0 + 1e-9
        assert float((back - g).abs().max()) <= bound * 1.01


@pytest.mark.parametrize("seed,shape,scale", QUANT_CASES)
def test_quantisation_matches_the_reference_bit_for_bit(seed, shape, scale):
    import jax.numpy as jnp
    from repro.optim.compression import dequantize_int8 as jdeq, quantize_int8 as jquant
    a = _normal(seed, shape, scale)
    if a.size > 1:                  # half the largest |a|: 63.5 steps, a tie
        a.flat[-1] = 0.5 * np.abs(a.flat[:-1]).max()
    q, s = quantize_int8(torch.from_numpy(a))
    jq, js = jquant(jnp.asarray(a))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    back, jback = dequantize_int8(q, s), jdeq(jq, js)
    assert back.numpy().tobytes() == np.asarray(jback).tobytes()


def test_zero_gradient_uses_the_scale_floor():
    q, s = quantize_int8(torch.zeros(16))
    assert float(s) == np.float32(1e-12) / np.float32(127.0)
    assert not q.any()


def test_rounding_is_half_to_even_as_jnp_round():
    import jax.numpy as jnp
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.5], np.float32)
    assert np.array_equal(torch.round(torch.from_numpy(x)).numpy(), np.asarray(jnp.round(x)))


# -------------------------------------------------- 8 ranks against shard_map
JAX_PSUM = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.optim.compression import compressed_grads
g = np.load(sys.argv[1])
mesh = jax.make_mesh((8,), ("data",))
f = jax.jit(shard_map(lambda g: compressed_grads({"w": g}, "data")["w"], mesh=mesh,
                      in_specs=P("data"), out_specs=P("data")))
np.save(sys.argv[2], np.asarray(f(jnp.asarray(g))))
print("JAX_OK")
"""

PORT_PSUM = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.optim.compression import compressed_grads, compressed_psum
rank, store, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, 8), rank=rank, world_size=8)
g = torch.from_numpy(np.load(src))
out = compressed_psum(g[rank:rank + 1].clone())          # this rank's row
rows = [torch.empty_like(out) for _ in range(8)]
dist.all_gather(rows, out)
# a data-parallel mean of a tree whose leaves are the same on every rank
tree = {"a": g[0].clone(), "b": g[:, :4].clone()}
mean = compressed_grads(tree)
if rank == 0:
    np.save(dst, torch.cat(rows).numpy())
    rel = max(float((mean[k] - tree[k]).abs().max() / tree[k].abs().max()) for k in tree)
    print("PORT", json.dumps({"tree_rel": rel, "tree_dtypes": [str(mean[k].dtype) for k in tree]}))
dist.barrier()
dist.destroy_process_group()
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def _run_all(cmds, deadline):
    """Run the commands together; kill them all if one fails or time runs
    out. Returns each one's output."""
    procs = [subprocess.Popen([sys.executable, "-c", *c], cwd=ROOT, env=_env(), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [i for i, p in enumerate(procs) if p.returncode]
    assert not bad, outs[bad[0]][-4000:] if bad[0] < len(outs) else "timed out"
    return outs


@pytest.fixture(scope="module")
def psum(tmp_path_factory):
    d = tmp_path_factory.mktemp("psum")
    g = np.random.default_rng(0).standard_normal((8, 32)).astype(np.float32)
    g[3] *= 40.0                       # one rank's scale sets the global one
    np.save(d / "g.npy", g)
    deadline = time.monotonic() + TIMEOUT
    outs = _run_all([[JAX_PSUM, str(d / "g.npy"), str(d / "jax.npy")]] +
                    [[PORT_PSUM, str(r), str(d / "store"), str(d / "g.npy"), str(d / "port.npy")]
                     for r in range(8)], deadline)
    port = json.loads(outs[1].split("PORT", 1)[1].strip().splitlines()[0])
    return g, np.load(d / "jax.npy"), np.load(d / "port.npy"), port


def test_compressed_psum_over_8_ranks_matches_jax_shard_map(psum):
    """Each rank holds one row; every rank gets the mean, bit for bit the
    reference's on 8 devices."""
    g, jax_out, port_out, _ = psum
    assert port_out.tobytes() == jax_out.tobytes()
    rel = float(np.max(np.abs(port_out[0] - g.mean(0))) / np.max(np.abs(g)))
    print(f"compressed mean vs exact: {rel:.3g} of the largest |g|")
    assert rel < 1e-2
    assert all(np.array_equal(port_out[0], row) for row in port_out)


def test_compressed_grads_of_a_replicated_tree_stays_within_quantisation(psum):
    """tests/test_compression.py's single-host mean: the same gradients on
    every rank come back within int8 error, in their own dtype."""
    *_, port = psum
    assert port["tree_rel"] < 1e-2
    assert port["tree_dtypes"] == ["torch.float32", "torch.float32"]
