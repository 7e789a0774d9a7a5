"""Rematerialisation in the port (``remat='full'`` / ``'pamm'``) on the
CPU against the JAX package's ``jax.checkpoint`` of the layer body and
against the port's own ``remat='none'``: loss, every gradient and the
site telemetry, with the same parameters (bridged) and the same generator
rows and CompAct projections (the JAX key chain replayed by
``JaxSampler``). JAX runs ``attn_kernel="jnp"``; the port its plain
kernel versions.

Tolerances (f32): loss 1e-5 absolute and gradients 1e-4 relative (norm of
the difference over the norm of the JAX gradient) against JAX, as in
``test_torch_training.py``; measured about 2e-6 at these shapes. Against
the port's ``remat='none'`` the recompute runs the same ops on the same
inputs, so loss and gradients are equal bit for bit -- all but the
embedding's, a CPU scatter-add whose summation order varies from run to
run (two ``remat='none'`` runs differ there too), held to 1e-6 relative.
"""
import dataclasses
import math
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.data import SyntheticStream
from repro.models import init_model as jax_init_model
from repro.models import loss_fn as jax_loss_fn
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config
from repro_torch.core.keys import Key
from repro_torch.core.linear import SiteMode
from repro_torch.core.policies import PammPolicy
from repro_torch.kernels import launches
from repro_torch.models import loss_fn
from repro_torch.models import model as model_mod
from repro_torch.optim import adamw_init
from repro_torch.train import TrainState, make_train_step
from tests.test_torch_linear import JaxSampler

SPEC = "attn.qkv=pamm(r=1/8);ffn.*=compact(r=1/4)"
ARCHS = ["llama-tiny", "internlm2-1.8b_smoke"]


def flat_tree(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def setup(arch, seq=64, batch=4, **kw):
    """JAX and port run configs (f32), JAX parameters, one batch, and the
    port model holding the same parameters."""
    common = dict(compression=SPEC, policy_name="none", compute_dtype="float32",
                  param_dtype="float32", loss_chunk=16, **kw)
    jr = JaxRunConfig(attn_kernel="jnp", **common)
    tr = RunConfig(**common)
    params, _ = jax_init_model(jax_get_config(arch), jr, jax.random.key(0))
    b = SyntheticStream.for_arch(jax_get_config(arch), seq, batch).get_batch(0)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), get_config(arch),
                                   device="cpu", trainable=True)
    return jr, tr, params, b, model


def jax_loss_grads(arch, jr, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, m), g = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jax_get_config(arch), jr, None, p, jb, jax.random.key(3)),
        has_aux=True))(params)
    return float(loss), flat_tree(g), {k: np.asarray(v) for k, v in m["sites"].items()}


def port_loss_grads(arch, tr, model, batch):
    """(loss, grads by name, site telemetry, launch counts) of one
    loss_fn + backward on the port."""
    launches.reset()
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, m = loss_fn(get_config(arch), tr, None, model, tb, Key(3, sampler=JaxSampler()))
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), dict(zip(names, grads)), {k: v.detach() for k, v in
                                                     m["sites"].items()}, launches.counts())


def check_against_jax(arch, tr, jr, params, batch, model):
    loss, grads, sites, counts = port_loss_grads(arch, tr, model, batch)
    loss_j, grads_j, sites_j = jax_loss_grads(arch, jr, params, batch)
    assert abs(float(loss) - loss_j) < 1e-5
    assert set(grads) == set(grads_j)
    for name, g in grads.items():
        assert rel(g.numpy(), grads_j[name]) < 1e-4, name
    assert sorted(sites) == sorted(sites_j)
    for path, v in sites_j.items():
        np.testing.assert_allclose(sites[path].numpy(), v, rtol=1e-6)
    return loss, grads, sites, counts


@pytest.mark.parametrize("remat", ["full", "pamm"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_jax_and_the_residual_path(arch, remat):
    """The layer recompute: equal to JAX under the same remat, bitwise
    equal to the port's remat='none'; K1 runs again under 'full' and not
    under 'pamm' (the states cross the boundary), K3 twice a layer."""
    jr, tr, params, batch, model = setup(arch, remat=remat)
    loss, grads, sites, counts = check_against_jax(arch, tr, jr, params, batch, model)
    n = get_config(arch).n_layers
    assert counts == {"csim_argmax_ref": (2 if remat == "full" else 1) * n,
                      "segment_matmul_ref": 3 * n, "flash_attention_fwd_ref": 2 * n,
                      "flash_attention_bwd_ref": n}
    loss0, grads0, sites0, counts0 = port_loss_grads(
        arch, dataclasses.replace(tr, remat="none"), model, batch)
    assert counts0["csim_argmax_ref"] == n and counts0["flash_attention_fwd_ref"] == n
    assert torch.equal(loss, loss0)
    for name, g in grads.items():
        if name == "embed":   # a scatter-add whose order varies from run to run
            assert rel(g.numpy(), grads0[name].numpy()) < 1e-6
        else:
            assert torch.equal(g, grads0[name]), name
    for path, v in sites0.items():
        assert torch.equal(sites[path], v), path


@pytest.mark.parametrize("mode", [{"remat": "full"}, {"remat": "pamm"},
                                  {"block_structure": "reversible"}])
def test_train_step_with_grad_accum_composes(mode):
    """make_train_step with grad_accum 2: each microbatch rematerialises
    (or reconstructs) on its own. Remat gives remat='none''s parameters
    and moments (bit for bit but for the embedding's, 1e-6); reversible gives reversible_ref's within the
    reversible contract (1e-4 relative per leaf; measured about 1e-6)."""
    arch = "internlm2-1.8b_smoke"
    base = ({"remat": "none"} if "remat" in mode
            else {"block_structure": "reversible_ref"})
    out = []
    for kw in (mode, base):
        _, tr, _, batch, model = setup(arch, grad_accum=2, weight_decay=0.01, **kw)
        step = make_train_step(get_config(arch), tr, total_steps=10, sampler=JaxSampler())
        state = TrainState(model, adamw_init(dict(model.named_parameters())))
        state, m = step(state, batch, 3)
        state, m = step(state, batch, 4)
        out.append((float(m["loss"]), bridge.train_state_tree(state)))
    (loss_a, tree_a), (loss_b, tree_b) = out
    a = {**flat_tree(tree_a.params), **{f"m.{k}": v for k, v in flat_tree(tree_a.opt.m).items()}}
    b = {**flat_tree(tree_b.params), **{f"m.{k}": v for k, v in flat_tree(tree_b.opt.m).items()}}
    if "remat" in mode:
        assert loss_a == pytest.approx(loss_b, rel=1e-6)
        for name in b:
            if name.endswith("embed"):
                assert rel(a[name], b[name]) < 1e-6, name
            else:
                np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    else:
        assert loss_a == pytest.approx(loss_b, rel=1e-6)
        for name in b:
            assert rel(a[name], b[name]) < 1e-4, name


def cut_depth(arch: str, layers: int):
    """``arch`` with one stage of ``layers`` layers."""
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers, stages=((cfg.stages[0][0], layers),))


def saved_bytes(cfg, rcfg, seq=32, batch=2):
    """Bytes a loss's graph keeps for backward, split into (a) tensors
    packed through ``saved_tensors_hooks`` outside any checkpoint (unique
    storages, parameters excluded) and (b) compressed states the remat
    regions' SiteModes hold; plus those SiteModes, as weak references."""
    from repro_torch.models import init_model

    model = init_model(cfg, rcfg, seed=0, device="cpu")
    param_ptrs = {p.untyped_storage().data_ptr() for p in model.parameters()}
    b = SyntheticStream.for_arch(cfg, seq, batch).get_batch(0)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    packed: dict[int, int] = {}
    modes: list[SiteMode] = []

    class Recording(SiteMode):
        def __init__(self, **kw):
            super().__init__(**kw)
            modes.append(self)

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in param_ptrs:
            packed[ptr] = t.untyped_storage().nbytes()
        return t

    mp = pytest.MonkeyPatch()
    mp.setattr(model_mod, "SiteMode", Recording)
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = loss_fn(cfg, rcfg, None, model, tb, Key(0))
    finally:
        mp.undo()
    states = [s for m in modes for s in m._states]
    state_bytes = sum(t.numel() * t.element_size() for s in states
                      for t in (s if isinstance(s, tuple) else (s,))
                      if isinstance(t, torch.Tensor))
    refs = [weakref.ref(m) for m in modes]
    n_states = len(states)
    del modes, states
    torch.autograd.grad(loss, list(model.parameters()))
    return sum(packed.values()), state_bytes, n_states, refs


def test_remat_pamm_saves_only_layer_inputs_and_pamm_states():
    """Per layer, remat='pamm' keeps the layer's input (B, L, d) and its
    sites' compressed states -- three a layer under this plan (attn.qkv,
    ffn.gate backing ffn.up, ffn.down) -- and nothing else; remat='none'
    keeps far more. The states are freed with the graph: no SiteMode
    outlives the backward."""
    seq, batch = 32, 2
    grown = {}
    for remat in ("pamm", "none"):
        res = {}
        for layers in (2, 4):
            cfg = cut_depth("llama-tiny", layers)
            rcfg = RunConfig(compression=SPEC, policy_name="none", compute_dtype="float32",
                             param_dtype="float32", loss_chunk=16, remat=remat)
            packed, states, n_states, refs = saved_bytes(cfg, rcfg, seq, batch)
            assert n_states == (3 * layers if remat == "pamm" else 0)
            assert all(r() is None for r in refs)
            res[layers] = (packed, states)
        grown[remat] = [(res[4][i] - res[2][i]) / 2 for i in range(2)]
    cfg = get_config("llama-tiny")
    b, d = batch * seq, cfg.d_model
    k = PammPolicy(ratio=1 / 8).k_for(b)
    # PAMM: generators (k, d), alpha and assign (b,), beta; CompAct sketches
    # (b, d/4) of ffn.gate and (b, d_ff/4) of ffn.down; all 4-byte
    pamm_states = 4 * (k * d + 2 * b + 1) + 4 * b * (math.ceil(d / 4) + math.ceil(cfg.d_ff / 4))
    packed_per_layer, state_per_layer = grown["pamm"]
    assert packed_per_layer == b * d * 4
    assert state_per_layer == pamm_states
    assert grown["none"][0] > 5 * (packed_per_layer + state_per_layer)
