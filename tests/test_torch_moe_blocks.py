"""MoE's blocked dispatch (``moe_token_blocks > 1``) in the port on the
CPU, against the JAX package (``repro/models/moe.py:66-122``).

* ``moe_ffn`` at 2 and 4 token blocks on granite smoke (capacity 1.25, so
  each block drops pairs at its own capacity): output, aux (the blocks'
  mean) and the gradients of x and of every parameter against JAX's; a
  token count the blocks do not divide falls back to one block, silently,
  as in JAX.
* One ``train_step`` of granite smoke with ``moe_token_blocks=2`` under
  ``attn.qkv`` and ``moe.expert`` PAMM against JAX's: both warn that the
  MoE sites train exact, the loss and every parameter after the step
  agree, and no batched K1 / K2 runs (the blocked path applies no
  ``moe.expert`` state).
* Two gloo ranks (data 2, ``tests/torch_rank_jobs.py``) at
  ``moe_token_blocks=2``: each rank dispatches its half of the tokens as
  one block, and the step equals the single process's blocks-2 step
  (tests/test_torch_distributed.py's rank tolerances: metrics 1e-5
  relative, parameters 5e-4); a block count the data degree does not
  divide is refused.

Tolerances: outputs and gradients 1e-5 relative (norm of the difference
over JAX's norm; f32 sums in another order), aux 1e-6 relative, as in
``tests/test_torch_moe.py``; the train step's loss 1e-5 and parameters
5e-4 absolute (``tests/test_torch_distributed.py``'s bounds after AdamW).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.data import SyntheticStream
from repro.models import moe as jax_moe
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train import TrainState as JaxTrainState
from repro.train import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config
from repro_torch.kernels import launches
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import init_model, moe
from repro_torch.optim import adamw_init
from repro_torch.train import TrainState, make_train_step
from repro_torch.train.distributed import make_shard_map_grads
from tests import torch_rank_jobs
from tests.test_torch_linear import JaxSampler
from tests.test_torch_moe import moe_setup, rel, to_torch

ARCH = "granite-moe-3b-a800m_smoke"
SPEC = "attn.qkv=pamm(r=1/8);moe.expert=pamm(r=1/4,backend=jnp)"
HOT = r"compression sites \['moe.expert'\] are not applied on the blocked"


def _ffn_grads(params, x, cfg, blocks):
    """JAX: (out, aux, d/dx, d/dparams) of sum(out * w) + aux."""
    w = jnp.asarray(np.random.default_rng(2).standard_normal(x.shape).astype(np.float32))

    def f(p, xx):
        out, aux = jax_moe.moe_ffn(p, xx, cfg, token_blocks=blocks)
        return jnp.sum(out * w) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    return out, aux, gx, gp, np.asarray(w)


@pytest.mark.parametrize("blocks", [2, 4])
def test_blocked_moe_ffn_matches_jax(blocks):
    jcfg, tcfg, params, x = moe_setup(ARCH)
    out_j, aux_j, gx_j, gp_j, w = _ffn_grads(params, x, jcfg, blocks)
    tp = {k: v.requires_grad_() for k, v in to_torch(params).items()}
    xt = torch.from_numpy(x).requires_grad_()
    out_t, aux_t = moe.moe_ffn(tp, xt, tcfg, token_blocks=blocks)
    (out_t * torch.tensor(w)).sum().add(aux_t).backward()
    assert rel(out_t.detach().numpy(), out_j) < 1e-5
    assert float(aux_t.detach()) == pytest.approx(float(aux_j), rel=1e-6)
    assert rel(xt.grad.numpy(), gx_j) < 1e-5
    for name, t in tp.items():
        assert rel(t.grad.numpy(), gp_j[name]) < 1e-5, name
    # each block drops at its own capacity: not the one-block result
    one, _ = moe.moe_ffn(to_torch(params), torch.from_numpy(x), tcfg)
    assert rel(out_t.detach().numpy(), one.numpy()) > 1e-3


def test_indivisible_token_count_falls_back_to_one_block():
    jcfg, tcfg, params, x = moe_setup(ARCH)                 # 32 tokens
    out_j, aux_j = jax_moe.moe_ffn(params, jnp.asarray(x), jcfg, token_blocks=3)
    tp, xt = to_torch(params), torch.from_numpy(x)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out_t, aux_t = moe.moe_ffn(tp, xt, tcfg, token_blocks=3)
    one, aux_one = moe.moe_ffn(tp, xt, tcfg)
    assert torch.equal(out_t, one) and torch.equal(aux_t, aux_one)
    assert rel(out_t.numpy(), out_j) < 1e-5
    assert float(aux_t) == pytest.approx(float(aux_j), rel=1e-6)


def _port_steps(params, rcfg, batches, sampler=None):
    cfg = get_config(ARCH)
    model = bridge.from_jax_params(params, cfg, device="cpu", trainable=True)
    state = TrainState(model, adamw_init(dict(model.named_parameters())))
    step = make_train_step(cfg, rcfg, total_steps=len(batches), sampler=sampler)
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, b, i)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {n: p.detach().numpy() for n, p in state.params.named_parameters()}


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_blocked_train_step_matches_jax():
    common = dict(compression=SPEC, policy_name="none", compute_dtype="float32",
                  param_dtype="float32", loss_chunk=16, moe_token_blocks=2, lr=5e-3)
    jr = JaxRunConfig(attn_kernel="jnp", **common)
    jcfg = jax_get_config(ARCH)
    params = bridge.to_jax_params(init_model(get_config(ARCH), RunConfig(), seed=0,
                                             device="cpu"))
    batch = SyntheticStream.for_arch(jcfg, 32, 4).get_batch(0)
    jp = jax.tree.map(jnp.asarray, params)
    with pytest.warns(UserWarning, match=HOT):
        fn = jax.jit(jax_make_train_step(jcfg, jr, total_steps=1))
        state_j, mj = fn(JaxTrainState(params=jp, opt=jax_make_optimizer("adamw")[0](jp)),
                         {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(0))
    launches.reset()
    with pytest.warns(UserWarning, match=HOT):
        (mt,), pt = _port_steps(params, RunConfig(**common), [batch], JaxSampler())
    counts = launches.counts()
    assert mt["loss"] == pytest.approx(float(mj["loss"]), abs=1e-5)
    want = _flat(state_j.params)
    assert set(want) == set(pt)
    assert max(np.abs(pt[k] - want[k]).max() for k in want) < 5e-4
    n = get_config(ARCH).n_layers
    assert counts["csim_argmax_ref"] == n                       # attn.qkv stays compressed
    assert not any("batched" in k for k in counts)


def test_data_ranks_dispatch_their_share_of_the_blocks():
    cfg = get_config(ARCH)
    rcfg = dict(compression="", policy_name="none", compute_dtype="float32",
                param_dtype="float32", loss_chunk=16, moe_token_blocks=2, lr=5e-3)
    params = bridge.to_jax_params(init_model(cfg, RunConfig(), seed=0, device="cpu"))
    batches = [SyntheticStream.for_arch(cfg, 32, 4, seed=0).get_batch(i) for i in range(2)]
    started = spawn_ranks(2, torch_rank_jobs.job, (2, 1), [],
                          [{"arch": ARCH, "rcfg": rcfg, "params": params,
                            "batches": batches, "collect": ("params",)}],
                          timeout=torch_rank_jobs.TIMEOUT)
    single, p_single = _port_steps(params, RunConfig(**rcfg), batches)
    ranks = [r["runs"][0] for r in started.results()]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for a, b in zip(single, ranks[0]["metrics"]):
        for k in ("loss", "nll", "grad_norm"):
            assert b[k] == pytest.approx(a[k], rel=1e-5), k
    assert max(np.abs(ranks[0]["params"][k] - p_single[k]).max() for k in p_single) < 5e-4
    # a rank needs whole blocks
    with pytest.raises(ValueError, match="must divide by the data degree"):
        make_shard_map_grads(cfg, RunConfig(**{**rcfg, "moe_token_blocks": 3}),
                             mesh=make_local_mesh(2))
