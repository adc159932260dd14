"""Every config of the port equals the JAX package's, field by field, with
``dtype`` mapped from jnp to torch; the port's own fields (for its port-only
configs) hold their defaults there."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

import repro.configs as jc
import repro_torch.configs as tc

DTYPE_MAP = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_registry_matches():
    assert tc.ARCHS == jc.ARCHS


@pytest.mark.parametrize("arch", jc.ARCHS)
@pytest.mark.parametrize("which", ["get_config", "get_smoke_config"])
def test_config_matches_jax(arch, which):
    j, t = fields(getattr(jc, which)(arch)), fields(getattr(tc, which)(arch))
    own = set(t) - set(j)
    assert set(j) <= set(t)
    defaults = fields(tc.ModelConfig(name="x", family="dense", n_layers=1, d_model=8))
    assert {k: t.pop(k) for k in own} == {k: defaults[k] for k in own}
    assert t.pop("dtype") == DTYPE_MAP[j.pop("dtype")]
    assert t == j
    assert getattr(tc, which)(arch).param_count() == getattr(jc, which)(arch).param_count()


def test_default_dtype_is_bf16():
    assert tc.ModelConfig(name="x", family="dense", n_layers=1, d_model=8).dtype \
        == torch.bfloat16


def test_shapes_and_cell_supported_match():
    assert {k: dataclasses.astuple(v) for k, v in tc.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jc.SHAPES.items()}
    for arch in jc.ARCHS:
        for name in jc.SHAPES:
            assert tc.cell_supported(tc.get_config(arch), tc.SHAPES[name]) == \
                jc.cell_supported(jc.get_config(arch), jc.SHAPES[name])


def test_full_configs_match_assignment():
    """The full configs carry the exact assigned hyperparameters (mirror of
    tests/test_models_smoke.py::test_full_configs_match_assignment)."""
    spec = {
        "llava-next-mistral-7b": (32, 4096, 32, 8, 14336, 32000),
        "smollm-360m": (32, 960, 15, 5, 2560, 49152),
        "granite-34b": (88, 6144, 48, 1, 24576, 49152),
        "granite-20b": (52, 6144, 48, 1, 24576, 49152),
        "tinyllama-1.1b": (22, 2048, 32, 4, 5632, 32000),
        "mixtral-8x22b": (56, 6144, 48, 8, 16384, 32768),
        "qwen2-moe-a2.7b": (24, 2048, 16, 16, 1408, 151936),
        "zamba2-1.2b": (38, 2048, 32, 32, 8192, 32000),
        "hubert-xlarge": (48, 1280, 16, 16, 5120, 504),
        "mamba2-2.7b": (64, 2560, 0, 0, 0, 50280),
    }
    for arch, (L, D, H, KV, F, V) in spec.items():
        c = tc.get_config(arch)
        got = (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
               c.moe_d_ff if c.name == "qwen2-moe-a2.7b" else c.d_ff,
               c.vocab_size)
        assert got == (L, D, H, KV, F, V), f"{arch}: {got}"
    assert tc.get_config("mixtral-8x22b").n_experts == 8
    assert tc.get_config("qwen2-moe-a2.7b").n_experts == 60
    assert tc.get_config("mamba2-2.7b").ssm_state == 128
    assert tc.get_config("zamba2-1.2b").ssm_state == 64


def test_port_only_configs():
    """granite-4.0-h-small: registered beside the JAX package's list, not in
    it; 32.2 B parameters with ~8.8 B active a token (published: 32B-A9B)."""
    assert tc.PORT_ARCHS == tc.ARCHS + ["granite-4.0-h-small"]
    c = tc.get_config("granite-4.0-h-small")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim, c.vocab_size) == \
        (40, 4096, 32, 8, 128, 100352)
    assert (c.n_experts, c.n_experts_per_tok, c.moe_d_ff, c.shared_d_ff) == (72, 10, 768, 1536)
    assert c.param_count() == pytest.approx(32.2e9, rel=0.005)
    assert c.active_param_count() == pytest.approx(8.8e9, rel=0.01)
