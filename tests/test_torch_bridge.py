"""Parameter bridge: JAX tree -> port modules -> JAX tree, bit for bit."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, get_config
from repro.models import init_model
from repro_torch import bridge
from repro_torch.configs import get_config as torch_get_config

ARCHS = ["llama-tiny", "internlm2-1.8b_smoke", "qwen2-72b_smoke", "qwen3-32b_smoke"]


def _jax_params(arch, dtype="float32"):
    rcfg = RunConfig(compute_dtype=dtype, param_dtype=dtype, policy_name="none")
    params, _ = init_model(get_config(arch), rcfg, jax.random.key(0))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_is_bit_exact(arch):
    params = _jax_params(arch)
    model = bridge.from_jax_params(params, torch_get_config(arch), device="cpu")
    back = bridge.to_jax_params(model)
    leaves, treedef = jax.tree.flatten(params)
    back_leaves, back_def = jax.tree.flatten(back)
    assert treedef == back_def
    for a, b in zip(leaves, back_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["internlm2-1.8b_smoke", "qwen3-32b_smoke"])
def test_bridge_names_and_stacked_layouts(arch):
    """Name for name and layer for layer: every JAX leaf lands on the
    state_dict key of the same dotted path, with the stage's leading
    layer axis and the (n_in, n_out) projection layout kept."""
    cfg = torch_get_config(arch)
    params = _jax_params(arch)
    model = bridge.from_jax_params(params, cfg, device="cpu")
    flat = {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(params)}
    state = model.state_dict()
    assert set(flat) == set(state)
    for key, val in flat.items():
        np.testing.assert_array_equal(state[key].numpy(), val)
    wq = model.stages[0][0].attn.wq
    assert tuple(wq.shape) == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim)
    layer1 = model.stages[0][0].layer(1)
    assert torch.equal(layer1["attn"]["wq"], wq[1])
    assert layer1["attn"]["wq"].data_ptr() == wq[1].data_ptr()   # a view


def test_bridge_round_trip_bfloat16():
    params = _jax_params("internlm2-1.8b_smoke", dtype="bfloat16")
    model = bridge.from_jax_params(params, torch_get_config("internlm2-1.8b_smoke"),
                                   device="cpu")
    assert model.head.dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(bridge.to_jax_params(model))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))
