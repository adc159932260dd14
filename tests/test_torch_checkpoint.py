"""The port's checkpoint substrate (repro_torch.checkpoint): the JAX
package's tests/test_checkpoint.py on torch trees, and the format shared
with the JAX package, in both directions, bf16 included."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import Model as JaxModel
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.serializer import flatten_with_paths
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (from_jax, opt_state_from_jax, opt_state_to_jax,
                                 state_dict_from_jax)
from repro_torch.core import Cluster, IORuntime, RealBackend, StorageDevice, WorkerNode
from repro_torch.models import Model
from repro_torch.optim import adamw_init


def tree():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": torch.ones((4,), dtype=torch.bfloat16),
            "opt": {"count": torch.zeros((), dtype=torch.int32),
                    "m": torch.full((2, 2), 0.5)}}


def leaves(t):
    return [leaf for _, leaf in flatten_with_paths(t)]


def assert_tree_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x.float().numpy(), y.float().numpy())


def test_sync_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, n_shards=3)
    t = tree()
    mgr.save(5, t, sync=True)
    restored, step = mgr.restore(t)
    assert step == 5
    assert_tree_equal(t, restored)
    assert all(x.dtype == y.dtype for x, y in zip(leaves(t), leaves(restored)))


def test_latest_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, n_shards=2, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree(), sync=True)
    assert mgr.latest_step() == 4
    assert mgr.steps() == [3, 4]  # gc keeps 2


def test_torn_manifest_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path, n_shards=2)
    mgr.save(1, tree(), sync=True)
    mgr.save(2, tree(), sync=True)
    # simulate a torn step-3: shards written, manifest garbage
    d = tmp_path / "step_00000003"
    d.mkdir()
    (d / "MANIFEST.json").write_text("{not json")
    assert mgr.latest_step() == 2


def test_truncated_shard_detected(tmp_path):
    mgr = CheckpointManager(tmp_path, n_shards=1)
    t = tree()
    mgr.save(1, t, sync=True)
    shard = next((tmp_path / "step_00000001").glob("shard_*.bin"))
    shard.write_bytes(shard.read_bytes()[:-4])
    with pytest.raises(IOError, match="truncated"):
        mgr.restore(t)


def test_async_save_through_runtime(tmp_path):
    dev = StorageDevice(name="fs", bandwidth=2000, per_stream_cap=500)
    cluster = Cluster(workers=[WorkerNode(name="w0", cpus=2, io_executors=4,
                                          storage=dev)])
    mgr = CheckpointManager(tmp_path, n_shards=4)
    t = tree()
    with IORuntime(cluster, backend=RealBackend()):
        assert mgr.save(7, t)
        # the snapshot was taken in save: updating in place now changes
        # nothing that is written
        t_saved = {"w": t["w"].clone(), "b": t["b"].clone(),
                   "opt": {k: v.clone() for k, v in t["opt"].items()}}
        t["w"].add_(1)
        mgr.wait()
    restored, step = mgr.restore(t)
    assert step == 7
    assert_tree_equal(t_saved, restored)


def test_restore_onto_other_dtypes_and_the_like_device(tmp_path):
    """The port's counterpart of restoring with new shardings: each leaf
    comes back in the dtype and on the device of the like tree's leaf."""
    mgr = CheckpointManager(tmp_path, n_shards=2)
    t = tree()
    mgr.save(1, t, sync=True)
    like = {"w": torch.zeros((3, 4), dtype=torch.float64),
            "b": torch.zeros((4,), dtype=torch.float32),
            "opt": {"count": torch.zeros((), dtype=torch.int64),
                    "m": torch.zeros((2, 2), dtype=torch.bfloat16)}}
    restored, _ = mgr.restore(like)
    assert_tree_equal(t, restored)
    for x, y in zip(leaves(like), leaves(restored)):
        assert (x.dtype, x.device) == (y.dtype, y.device)


def test_restore_rejects_a_shape_mismatch(tmp_path):
    mgr = CheckpointManager(tmp_path, n_shards=2)
    mgr.save(1, tree(), sync=True)
    like = tree()
    like["w"] = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="shape mismatch for \\['w'\\]"):
        mgr.restore(like)


# ---------------------------------------------------------------- the format
# arch: a key of its (params, AdamWState) tree, as jax.tree_util.keystr
# gives it, and the tree's number of leaves
TREES = {
    "tinyllama-1.1b": ("[0]['layers']['attn']['q']", 37),
    "mamba2-2.7b": ("[0]['layers']['in_x']", 49),                 # SSM
    "smollm-360m": ("[0]['layers']['attn']['q']", 34),            # tied embeddings
    "zamba2-1.2b": ("[0]['mamba_layers']['in_x']", 79),           # hybrid
    "qwen2-moe-a2.7b": ("[0]['layers']['moe']['shared']['gate']", 49),  # MoE + shared
    "mixtral-8x22b": ("[0]['layers']['moe']['router']", 40),       # MoE
    "hubert-xlarge": ("[0]['head']", 34),                          # encoder: no embed
}


@pytest.fixture(scope="module", params=list(TREES))
def train_state(request):
    """(params, AdamWState) of an arch's smoke config in bf16 after one
    AdamW step (m and v non-zero), in the JAX package."""
    jcfg = jax_smoke_config(request.param)             # dtype bf16
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))[0]
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    state = jadamw.adamw_init(params)
    params, state, _ = jadamw.adamw_update(grads, params, state, jadamw.AdamWConfig())
    return jcfg, params, state


def port_tree(jcfg, params, state):
    tcfg = get_smoke_config(jcfg.name)
    return (from_jax(tcfg, params, device="cpu").state_dict(),
            opt_state_from_jax(state, device="cpu"))


def test_keys_and_order_are_jax_keystr(train_state):
    jcfg, params, state = train_state
    jkeys = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path((params, state))[0]]
    tkeys = [k for k, _ in flatten_with_paths(port_tree(jcfg, params, state))]
    assert tkeys == jkeys
    key, n_leaves = TREES[jcfg.name]
    assert key in tkeys and "[1].count" in tkeys
    assert len(tkeys) == n_leaves


def test_same_tree_same_files(train_state, tmp_path):
    """Both packages write the same state into byte-identical shards and the
    same manifest (but for the measured save time)."""
    jcfg, params, state = train_state
    JaxManager(tmp_path / "jax", n_shards=3).save(2, (params, state), sync=True)
    CheckpointManager(tmp_path / "torch", n_shards=3).save(
        2, port_tree(jcfg, params, state), sync=True)
    mj, mt = (json.loads((tmp_path / d / "step_00000002" / "MANIFEST.json").read_text())
              for d in ("jax", "torch"))
    mj.pop("save_seconds"), mt.pop("save_seconds")
    assert mt == mj
    for frag in mj["shards"]:
        assert ((tmp_path / "torch" / "step_00000002" / frag["file"]).read_bytes()
                == (tmp_path / "jax" / "step_00000002" / frag["file"]).read_bytes())


def test_jax_checkpoint_restores_into_the_port(train_state, tmp_path):
    jcfg, params, state = train_state
    JaxManager(tmp_path, n_shards=4).save(3, (params, state), sync=True)
    # a like tree of other values: the port's own init and a fresh state
    model = Model(get_smoke_config(jcfg.name)).init(1, device="cpu")
    like = (model.state_dict(), adamw_init(model.state_dict()))
    (sd, opt), step = CheckpointManager(tmp_path).restore(like)
    assert step == 3
    want_sd = state_dict_from_jax(params)
    assert sd.keys() == want_sd.keys()
    assert any(t.dtype == torch.bfloat16 for t in sd.values())
    for k in sd:
        assert sd[k].dtype == want_sd[k].dtype, k
        assert torch.equal(sd[k], want_sd[k]), k
    want_opt = opt_state_from_jax(state, device="cpu")
    for field in ("m", "v"):
        for k, t in getattr(opt, field).items():
            assert t.dtype == torch.float32
            assert torch.equal(t, getattr(want_opt, field)[k]), (field, k)
    assert opt.count.dtype == torch.int32 and int(opt.count) == 1


def test_port_checkpoint_restores_into_jax(train_state, tmp_path):
    jcfg, params, state = train_state
    CheckpointManager(tmp_path, n_shards=4).save(4, port_tree(jcfg, params, state), sync=True)
    zeros = jax.tree.map(jnp.zeros_like, (params, state))
    (rp, rs), step = JaxManager(tmp_path).restore(zeros)
    assert step == 4
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path((params, state))[0],
                                 jax.tree.leaves((rp, rs))):
        assert np.asarray(got).dtype == np.asarray(want).dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(got).reshape(-1).view(np.uint8),
                                      np.asarray(want).reshape(-1).view(np.uint8))


def test_opt_state_converts_both_ways(train_state):
    _, _, state = train_state
    back = jadamw.AdamWState(*opt_state_to_jax(opt_state_from_jax(state, device="cpu")))
    for path, want in jax.tree_util.tree_flatten_with_path(state)[0]:
        got = back
        for k in path:
            got = getattr(got, k.name) if hasattr(k, "name") else got[k.key]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=jax.tree_util.keystr(path))
