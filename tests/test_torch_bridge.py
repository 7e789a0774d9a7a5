"""Parameter bridge: JAX tree -> port modules -> JAX tree, bit for bit."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, get_config
from repro.models import init_model
from repro_torch import bridge
from repro_torch.configs import get_config as torch_get_config

ARCHS = ["llama-tiny", "internlm2-1.8b_smoke", "qwen2-72b_smoke", "qwen3-32b_smoke",
         "granite-moe-3b-a800m_smoke", "kimi-k2-1t-a32b_smoke", "mamba2-370m_smoke",
         "recurrentgemma-9b_smoke"]


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


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m_smoke", "kimi-k2-1t-a32b_smoke"])
def test_bridge_moe_leaves_and_train_state(arch):
    """The MoE leaves with bf16 parameters: the router stays f32 (rep, d,
    E), the experts stack (rep, E, d, f) / (rep, E, f, d), kimi's shared
    expert is a dense FFN; a JAX TrainState's optimizer state goes both
    ways, and ``train_state_tree`` has the JAX TrainState's paths."""
    from repro.configs import RunConfig as JaxRunConfig
    from repro.train import init_train_state as jax_init_train_state
    from repro_torch.configs import RunConfig as TorchRunConfig
    from repro_torch.train import init_train_state

    cfg = torch_get_config(arch)
    jr = JaxRunConfig(compression="", param_dtype="bfloat16")
    jstate, _ = jax_init_train_state(get_config(arch), jr, jax.random.key(0))
    params = jax.tree.map(np.asarray, jstate.params)
    model = bridge.from_jax_params(params, cfg, device="cpu")
    si = next(i for i, (unit, _) in enumerate(cfg.stages) if "moe" in unit)
    rep = cfg.stages[si][1]
    moe = model.stages[si][0].ffn
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    assert moe.router.dtype == torch.float32 and tuple(moe.router.shape) == (rep, d, e)
    assert moe.w_gate.dtype == torch.bfloat16
    assert tuple(moe.w_gate.shape) == tuple(moe.w_up.shape) == (rep, e, d, f)
    assert tuple(moe.w_down.shape) == (rep, e, f, d)
    assert hasattr(moe, "shared") == bool(cfg.n_shared_experts)
    if cfg.n_shared_experts:
        assert tuple(moe.shared.w_gate.shape) == (rep, d, f * cfg.n_shared_experts)
    m = jax.tree.map(lambda p: np.full(p.shape, 0.5, np.float32), params)
    v = jax.tree.map(lambda p: np.full(p.shape, 0.25, np.float32), params)
    opt = bridge.opt_state_from_jax(np.int32(3), m, v, model)
    assert opt.step == 3 and set(opt.m) == {n for n, _ in model.named_parameters()}
    step, m2, v2 = bridge.opt_state_to_jax(opt, model)
    assert jax.tree.structure(m2) == jax.tree.structure(m)
    for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(v2)):
        np.testing.assert_array_equal(a, b)
    port = init_train_state(cfg, TorchRunConfig(compression="", param_dtype="bfloat16"),
                            device="cpu", seed=1)
    flat = lambda t: [jax.tree_util.keystr(p) for p, _ in
                      jax.tree_util.tree_flatten_with_path(t)[0]]
    assert flat(bridge.train_state_tree(port)) == flat(jstate)


def test_bridge_rec_leaves_and_train_state():
    """recurrentgemma smoke with bf16 parameters: a rec block's RG-LRU
    leaves (w_y, w_x, conv_w, w_a, w_i, lambda, out) name for name in the
    JAX layout, ``lambda`` staying f32 and w used as ``x @ w``; the latt
    block's attention leaves; a JAX TrainState's AdamW state both ways,
    and ``train_state_tree`` with the JAX TrainState's paths."""
    from repro.configs import RunConfig as JaxRunConfig
    from repro.train import init_train_state as jax_init_train_state
    from repro_torch.configs import RunConfig as TorchRunConfig
    from repro_torch.train import init_train_state

    arch = "recurrentgemma-9b_smoke"
    cfg = torch_get_config(arch)
    jr = JaxRunConfig(compression="", param_dtype="bfloat16")
    jstate, _ = jax_init_train_state(get_config(arch), jr, jax.random.key(0))
    params = jax.tree.map(np.asarray, jstate.params)
    model = bridge.from_jax_params(params, cfg, device="cpu")
    (unit, rep), d, w = cfg.stages[0], cfg.d_model, cfg.lru_width
    rec = model.stages[0][unit.index("rec")].rec
    assert [n for n, _ in rec.named_parameters()] == list(params["stages"][0][0]["rec"])
    assert rec.__getattr__("lambda").dtype == torch.float32
    assert tuple(rec.__getattr__("lambda").shape) == (rep, w)
    assert tuple(rec.w_x.shape) == (rep, d, w) and tuple(rec.out.shape) == (rep, w, d)
    assert tuple(rec.conv_w.shape) == (rep, cfg.conv_width, w)
    assert rec.w_a.dtype == torch.bfloat16 and tuple(rec.w_a.shape) == (rep, w, w)
    latt = model.stages[0][unit.index("latt")].attn
    assert tuple(latt.wk.shape) == (rep, d, cfg.n_kv_heads * cfg.head_dim)
    m = jax.tree.map(lambda p: np.full(p.shape, 0.5, np.float32), params)
    v = jax.tree.map(lambda p: np.full(p.shape, 0.25, np.float32), params)
    opt = bridge.opt_state_from_jax(np.int32(3), m, v, model)
    assert opt.step == 3 and set(opt.m) == {n for n, _ in model.named_parameters()}
    step, m2, v2 = bridge.opt_state_to_jax(opt, model)
    assert int(step) == 3 and jax.tree.structure(m2) == jax.tree.structure(m)
    for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(v2)):
        np.testing.assert_array_equal(a, b)
    port = init_train_state(cfg, TorchRunConfig(compression="", param_dtype="bfloat16"),
                            device="cpu", seed=1)
    flat = lambda t: [jax.tree_util.keystr(p) for p, _ in
                      jax.tree_util.tree_flatten_with_path(t)[0]]
    assert flat(bridge.train_state_tree(port)) == flat(jstate)
