"""The port's training slice on the CPU against the JAX package: loss,
every gradient and the site telemetry of ``loss_fn`` with
``attn.qkv=pamm(r=1/8)``, and the parameters and AdamW moments after one
``make_train_step`` (grad_accum 1 and 2), with the same parameters
(bridged) and the same generator rows (the JAX key chain replayed by
``JaxSampler``). JAX runs with ``attn_kernel="jnp"``, which the JAX
package's ``tests/test_flash_bwd.py`` holds equal to its Pallas path; the
port runs its plain kernel versions. Plus the optimizers, the CLI and the
refusals that remain.

Tolerances (f32): loss 1e-5 absolute and gradients 1e-4 relative (the
norm of the difference over the norm of the JAX gradient), the JAX
package's own cross-backend bounds; parameters and moments after a step
1e-5 relative per leaf. The one exception is a leaf that starts at zero
(the RMSNorm scales): after one step it holds only the Adam step
lr * g / (|g| + eps), which turns the rounding of a gradient element near
eps into an O(1) relative change of that element, so those leaves are
held to 1e-2 * lr per element instead.
"""
import os

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
from repro.optim import optimizers as jax_optim
from repro.train import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config
from repro_torch.core.keys import Key
from repro_torch.kernels import launches
from repro_torch.models import loss_fn, prefill
from repro_torch.optim import optimizers as torch_optim
from repro_torch.train import TrainState, make_train_step
from tests.test_torch_linear import JaxSampler

SPEC = "attn.qkv=pamm(r=1/8)"


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _setup(arch, seq=32, batch=2, **kw):
    jr = JaxRunConfig(compression=SPEC, policy_name="none", compute_dtype="float32",
                      param_dtype="float32", attn_kernel="jnp", loss_chunk=16, **kw)
    tr = RunConfig(compression=SPEC, policy_name="none", compute_dtype="float32",
                   param_dtype="float32", loss_chunk=16, **kw)
    params, _ = jax_init_model(jax_get_config(arch), jr, jax.random.key(0))
    batch = SyntheticStream.for_arch(jax_get_config(arch), seq, batch).get_batch(0)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), get_config(arch),
                                   device="cpu", trainable=True)
    return jr, tr, params, batch, model


@pytest.mark.parametrize("arch", ["llama-tiny", "internlm2-1.8b_smoke", "qwen2-72b_smoke",
                                  "qwen3-32b_smoke", "h2o-danube-3-4b_smoke"])
def test_loss_grads_and_telemetry_match_jax(arch):
    """MHA and GQA, qkv bias (qwen2), qk-norm (qwen3), a sliding window
    shorter than the sequence (danube)."""
    jr, tr, params, batch, model = _setup(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jax_get_config(arch), jr, None, p, jb, jax.random.key(3)),
        has_aux=True))(params)
    launches.reset()
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, m = loss_fn(get_config(arch), tr, None, model, tb, Key(3, sampler=JaxSampler()))
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    n_layers = get_config(arch).n_layers
    assert launches.counts() == {"csim_argmax_ref": n_layers, "segment_matmul_ref": 3 * n_layers,
                                 "flash_attention_fwd_ref": n_layers,
                                 "flash_attention_bwd_ref": n_layers}
    assert abs(float(loss.detach()) - float(loss_j)) < 1e-5
    flat = _flat(g_j)
    assert set(flat) == set(names)
    for name, g in zip(names, grads):
        assert _rel(g.numpy(), flat[name]) < 1e-4, name
    assert sorted(m["sites"]) == sorted(m_j["sites"]) and len(m["sites"]) == 1
    for path, v in m_j["sites"].items():
        np.testing.assert_allclose(m["sites"][path].numpy(), np.asarray(v), rtol=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_params_and_moments_match_jax(accum):
    arch = "internlm2-1.8b_smoke"
    jr, tr, params, batch, model = _setup(arch, batch=4, grad_accum=accum,
                                          weight_decay=0.01)
    state_j, _ = jax_init_train_state(jax_get_config(arch), jr, jax.random.key(0))
    step_j = jax.jit(jax_make_train_step(jax_get_config(arch), jr, total_steps=10))
    state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(3))
    opt = bridge.opt_state_from_jax(*jax.tree.map(
        np.asarray, jax_optim.adamw_init(params)), model)
    step = make_train_step(get_config(arch), tr, total_steps=10, sampler=JaxSampler())
    state, m = step(TrainState(model, opt), batch, 3)
    for k in ("loss", "nll", "grad_norm", "lr"):
        assert abs(float(m[k]) - float(m_j[k])) <= 1e-5 * max(1.0, abs(float(m_j[k]))), k
    for k in m_j:
        assert k in m
    step_n, mom1, mom2 = bridge.opt_state_to_jax(state.opt, state.params)
    assert step_n == int(state_j.opt.step) == 1
    before = _flat(params)
    for mine, theirs in ((bridge.to_jax_params(state.params), state_j.params),
                         (mom1, state_j.opt.m), (mom2, state_j.opt.v)):
        a, b = _flat(mine), _flat(theirs)
        assert set(a) == set(b)
        for name in b:
            if theirs is state_j.params and not before[name].any():
                assert np.abs(a[name] - b[name]).max() <= 1e-2 * float(m_j["lr"]), name
            else:
                assert _rel(a[name], b[name]) < 1e-5, name


def test_optimizers_match_jax_and_decay_at_the_plain_lr():
    """AdamW and Adafactor written out as the JAX package writes them; the
    PAMM lr scale reduces only the Adam step of wq/wk/wv."""
    rng = np.random.default_rng(0)
    tree = {"attn": {"wq": rng.standard_normal((6, 4), dtype=np.float32),
                     "wo": rng.standard_normal((6, 4), dtype=np.float32)},
            "norm": rng.standard_normal(5, dtype=np.float32)}
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32), tree)
    flat_p, flat_g = _flat(tree), _flat(grads)
    for init_j, upd_j, init_t, upd_t in (
            (jax_optim.adamw_init, jax_optim.adamw_update,
             torch_optim.adamw_init, torch_optim.adamw_update),
            (jax_optim.adafactor_init, jax_optim.adafactor_update,
             torch_optim.adafactor_init, torch_optim.adafactor_update)):
        pj, sj = tree, init_j(tree)
        pt = {n: torch.from_numpy(a.copy()) for n, a in flat_p.items()}
        st = init_t(pt)
        for _ in range(2):
            pj, sj = upd_j(grads, sj, pj, 1e-2, weight_decay=0.1, pamm_lr_scale=0.25)
            _, st = upd_t({n: torch.from_numpy(a) for n, a in flat_g.items()}, st, pt, 1e-2,
                          weight_decay=0.1, pamm_lr_scale=0.25)
        for name, a in _flat(pj).items():
            assert _rel(pt[name].numpy(), a) < 1e-6, name
    # zero gradient: wq and wo decay alike (the scale is not on the decay)
    zeros = {n: torch.zeros_like(torch.from_numpy(a)) for n, a in flat_p.items()}
    pt = {n: torch.ones_like(torch.from_numpy(a)) for n, a in flat_p.items()}
    torch_optim.adamw_update(zeros, torch_optim.adamw_init(pt), pt, 0.5, weight_decay=0.1,
                             pamm_lr_scale=0.25)
    assert torch.equal(pt["attn.wq"], pt["attn.wo"])
    assert float(pt["attn.wq"][0, 0]) == pytest.approx(0.95)
    g, gn = torch_optim.clip_by_global_norm({"a": torch.full((4,), 3.0)}, 1.0)
    assert float(gn) == 6.0 and torch.allclose(g["a"], torch.full((4,), 0.5))


def test_prefill_with_a_plan_is_exact_and_compresses_nothing():
    cfg = get_config("internlm2-1.8b_smoke")
    rcfg = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
    from repro_torch.models import init_model

    model = init_model(cfg, rcfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12))
    plain, _ = prefill(cfg, rcfg, model, {"tokens": tokens}, 16)
    launches.reset()
    planned, _ = prefill(cfg, rcfg, model, {"tokens": tokens}, 16,
                         plan="attn.qkv=pamm(r=1/8);ffn.*=compact(r=1/4)")
    assert torch.equal(plain, planned)
    assert "csim_argmax_ref" not in launches.counts()


def test_later_slices_are_refused():
    """What the single-process step refuses: gradient compression, with the
    JAX text (only the mesh executor, ``train.distributed``, has per-rank
    gradients to compress). Remat and reversible
    blocks train now (tests/test_torch_remat.py, test_torch_revnet.py), moe
    blocks under both structures (tests/test_torch_moe.py), ssm blocks
    on the residual structure in every remat mode (tests/test_torch_ssm.py),
    rec / latt blocks under both structures (tests/test_torch_rglru.py),
    and xattn blocks on the residual structure in every remat mode
    (tests/test_torch_xattn.py), reversible refused with the JAX text."""
    cfg = get_config("internlm2-1.8b_smoke")
    for kw in ({"remat": "full"}, {"remat": "pamm"}, {"block_structure": "reversible"},
               {"block_structure": "reversible_ref"}):
        make_train_step(cfg, RunConfig(**kw))
    with pytest.raises(ValueError, match="only honored by the shard_map executor"):
        make_train_step(cfg, RunConfig(grad_compress="int8_ef"))
    for kw in ({}, {"block_structure": "reversible"}):
        make_train_step(get_config("granite-moe-3b-a800m_smoke"), RunConfig(**kw))
    for kw in ({}, {"remat": "full"}, {"remat": "pamm"}):
        make_train_step(get_config("mamba2-370m_smoke"), RunConfig(**kw))
    for kw in ({}, {"remat": "pamm"}, {"block_structure": "reversible"}):
        make_train_step(get_config("recurrentgemma-9b_smoke"), RunConfig(**kw))
    for kw in ({}, {"remat": "full"}, {"remat": "pamm"}):
        make_train_step(get_config("llama-3.2-vision-11b_smoke"), RunConfig(**kw))
    with pytest.raises(ValueError, match="xattn consumes cross-modal extras"):
        make_train_step(get_config("llama-3.2-vision-11b_smoke"),
                        RunConfig(block_structure="reversible"))


def test_train_cli_runs_on_the_cpu(capsys, tmp_path):
    """The CLI on the CPU: residual, reversible, and under the
    checkpoint/restart supervisor (a second run resumes from the last
    checkpoint); the mesh flags without the shard_map executor are
    refused, as by the JAX launcher, and so are a model degree above 1
    together with a context degree above 1 and a checkpoint directory
    under a mesh, each naming its later slice (the mesh runs themselves:
    tests/test_torch_distributed.py, tests/test_torch_tensor_parallel.py)."""
    from repro_torch.launch import train

    common = ["--arch", "internlm2-1.8b_smoke", "--device", "cpu", "--seq-len", "16",
              "--global-batch", "2", "--log-every", "1",
              "--compression", "attn.qkv=pamm(r=1/8);ffn.*=compact(r=1/4)"]
    train.main([*common, "--steps", "3"])
    out = capsys.readouterr().out
    assert out.count("step ") == 3 and "done: 3 steps" in out and "device cpu" in out
    train.main([*common, "--steps", "3", "--block-structure", "reversible"])
    out = capsys.readouterr().out
    assert out.count("step ") == 3 and "done: 3 steps" in out
    ck = str(tmp_path / "ck")
    train.main([*common, "--steps", "3", "--ckpt-dir", ck, "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "supervisor: SupervisorReport(restarts=0, completed_steps=3" in out
    assert sorted(os.listdir(ck)) == ["step_000000002", "step_000000003"]
    train.main([*common, "--steps", "5", "--ckpt-dir", ck, "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and "completed_steps=2" in out
    for flag, msg in ((["--mesh-context", "2"], "needs --executor shard_map"),
                      (["--grad-compress", "int8_ef"], "only honored by the shard_map"),
                      (["--data-model", "1", "1"], "needs --executor shard_map"),
                      (["--executor", "shard_map", "--data-model", "1", "2",
                        "--mesh-context", "2"], "ring inside tensor-parallel attention"),
                      (["--executor", "shard_map", "--ckpt-dir", ck],
                       "checkpoint-shardings slice")):
        with pytest.raises(SystemExit):
            train.main(["--arch", "internlm2-1.8b_smoke", "--device", "cpu", *flag])
        assert msg in capsys.readouterr().err
