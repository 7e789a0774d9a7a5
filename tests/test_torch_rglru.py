"""The rec (RG-LRU, ``models/rglru.py``) and latt (local attention) block
kinds in the port on the CPU, against the JAX package: the linear scan
(values and gradients at ragged lengths, against ``lax.associative_scan``
under autodiff); the gates and the floored square root at a tie;
``rglru_train`` / ``rglru_decode`` and the rec and latt blocks;
recurrentgemma-smoke training, exact and under ``attn.qkv`` + ``rglru.in``
PAMM, in every remat mode and both reversible structures, with the site
telemetry. Serving (prefill, decode, the engine) is in
``test_torch_rglru_serve.py``. Inputs are seeded numpy, f32; the JAX draws
reach the port through ``JaxSampler``.

Tolerances (f32): the scan's values and gradients 1e-5 relative (norm of
the difference over the norm of JAX's; the same products and sums in
another tree, measured 1e-7 to 1e-6); the gates, the RG-LRU sublayer and
the blocks 1e-5 relative on values and 1e-4 on gradients; loss 1e-5
absolute, gradients 1e-4 relative and telemetry 1e-6 relative, as in
``test_torch_remat.py``; caches rtol 1e-4 / atol 1e-5, as in
``test_torch_serving.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.core.plan import exact_ctx as jax_exact_ctx
from repro.models import blocks as jax_blocks
from repro.models import init_model as jax_init_model
from repro.models import rglru as jax_rglru
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config
from repro_torch.core.plan import exact_ctx
from repro_torch.models import blocks as blk
from repro_torch.models import rglru
from tests.test_torch_moe import setup as training_setup
from tests.test_torch_remat import check_against_jax, port_loss_grads

ARCH = "recurrentgemma-9b_smoke"
SPEC = "attn.qkv=pamm(r=1/8);rglru.in=pamm(r=1/8)"
JR = JaxRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
TR = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=1e-4, atol=1e-5)


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def models(arch=ARCH):
    """(JAX cfg, JAX params, port cfg, port model) in f32."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    params, _ = jax_init_model(jcfg, JR, jax.random.key(0))
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


# ---------------------------------------------------------------------------
# the scan and the gates
# ---------------------------------------------------------------------------
def _jax_scan(a, b):
    def combine(lhs, rhs):
        a1, b1 = lhs
        a2, b2 = rhs
        return a1 * a2, a2 * b1 + b2

    return jax.lax.associative_scan(combine, (a, b), axis=1)[1]


@pytest.mark.parametrize("L", [1, 7, 33, 130])
def test_linear_scan_values_and_gradients_match_jax(L):
    """The doubling scan and its reverse-scan backward against JAX's
    autodiff through ``associative_scan``, at lengths that are no power of
    two (and one step)."""
    rng = np.random.default_rng(L)
    a = rng.uniform(0.5, 1.0, (2, L, 6)).astype(np.float32)
    b = rng.standard_normal((2, L, 6)).astype(np.float32)
    g = rng.standard_normal((2, L, 6)).astype(np.float32)
    hj, vjp = jax.vjp(_jax_scan, jnp.asarray(a), jnp.asarray(b))
    daj, dbj = vjp(jnp.asarray(g))
    at, bt = T(a).requires_grad_(), T(b).requires_grad_()
    ht = rglru.LinearScan.apply(at, bt)
    dat, dbt = torch.autograd.grad(ht, (at, bt), T(g))
    assert rel(ht.detach().numpy(), hj) < 1e-5
    assert rel(dat.numpy(), daj) < 1e-5 and rel(dbt.numpy(), dbj) < 1e-5
    seq = np.zeros((2, 6), np.float32)            # the recurrence, step by step
    for t in range(L):
        seq = a[:, t] * seq + b[:, t]
    assert rel(ht.detach().numpy()[:, -1], seq) < 1e-5


def test_sqrt_floor_gradient_at_the_tie_matches_jnp_maximum():
    """sqrt(max(t, 1e-12)) below, at and above the floor: the values, and
    the gradient JAX's maximum gives (half of it at an exact tie)."""
    t = np.array([0.0, 1e-13, 1e-12, 2e-12, 0.25], np.float32)
    assert t[2] == np.float32(1e-12)
    vj, vjp = jax.vjp(lambda t: jnp.sqrt(jnp.maximum(t, 1e-12)), jnp.asarray(t))
    gj, = vjp(jnp.ones_like(vj))
    tt = T(t).requires_grad_()
    vt = rglru._sqrt_floor(tt)
    gt, = torch.autograd.grad(vt.sum(), tt)
    np.testing.assert_allclose(vt.detach().numpy(), vj, rtol=1e-6)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-6)
    assert gt[0] == gt[1] == 0 and gt[2] > 0


def _rec_params(seed=0, d=16, w=12):
    """One rec layer's RG-LRU parameters (numpy f32) and its config."""
    cfg = dataclasses.replace(jax_get_config(ARCH), d_model=d, lru_width=w)
    p, _ = jax_rglru.init_rglru(jax.random.key(seed), cfg, jnp.float32)
    return cfg, {k: np.asarray(v) for k, v in p.items()}


def test_gates_match_jax():
    cfg, p = _rec_params()
    xb = np.random.default_rng(1).standard_normal((2, 5, cfg.lru_width)).astype(np.float32)
    aj, bj = jax_rglru._gates({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(xb))
    at, bt = rglru._gates({k: T(v) for k, v in p.items()}, T(xb))
    assert rel(at.numpy(), aj) < 1e-5 and rel(bt.numpy(), bj) < 1e-5
    assert float(at.min()) > 0 and float(at.max()) < 1


def test_init_draws_lambda_in_the_griffin_range():
    """a = exp(-8 softplus(Λ)) lies in (0.9, 0.999) at r = 1, for the JAX
    and the port's draws alike; shapes and dtypes follow the JAX tree."""
    cfg = get_config(ARCH)
    pt = rglru.init_rglru(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    pj, _ = jax_rglru.init_rglru(jax.random.key(0), jax_get_config(ARCH), jnp.bfloat16)
    assert list(pt) == list(pj)
    for k in pj:
        assert tuple(pt[k].shape) == pj[k].shape, k
        assert pt[k].dtype == (torch.float32 if k == "lambda" else torch.bfloat16), k
    a = torch.exp(-8.0 * torch.nn.functional.softplus(pt["lambda"]))
    assert float(a.min()) > 0.9 and float(a.max()) < 0.999


def test_rglru_train_and_decode_match_jax():
    """The sublayer over 9 tokens (values, the input and every parameter
    gradient, the cache it leaves), then three decode steps from that
    cache against JAX and against the sublayer over the longer sequence."""
    cfg, p = _rec_params()
    tcfg = dataclasses.replace(get_config(ARCH), d_model=cfg.d_model, lru_width=cfg.lru_width)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pj = {k: jnp.asarray(v) for k, v in p.items()}

    def f(pj, x):
        return jax_rglru.rglru_train(pj, x, cfg, jax_exact_ctx(), None, return_cache=True)

    (yj, cj), vjp = jax.vjp(f, pj, jnp.asarray(x[:, :9]))
    zero_cache = jax.tree.map(jnp.zeros_like, cj)
    gpj, gxj = vjp((jnp.asarray(gy), zero_cache))
    pt = {k: T(v).requires_grad_() for k, v in p.items()}
    xt = T(x[:, :9]).requires_grad_()
    yt, ct = rglru.rglru_train(pt, xt, tcfg, exact_ctx(), None, return_cache=True)
    grads = torch.autograd.grad(yt, [xt, *pt.values()], T(gy))
    assert rel(yt.detach().numpy(), yj) < 1e-5
    assert rel(grads[0].numpy(), gxj) < 1e-4
    for (k, _), g in zip(pt.items(), grads[1:]):
        assert rel(g.numpy(), gpj[k]) < 1e-4, k
    close(cj.h, ct.h.detach().numpy())
    close(cj.conv_state, ct.conv_state.detach().numpy())
    full = rglru.rglru_train({k: v.detach() for k, v in pt.items()}, T(x), tcfg, exact_ctx(),
                             None)
    ct = rglru.RGLRUCache(h=ct.h.detach().clone(), conv_state=ct.conv_state.detach().clone())
    for t in range(9, 12):
        oj, cj = jax_rglru.rglru_decode(pj, jnp.asarray(x[:, t:t + 1]), cj, cfg)
        with torch.no_grad():
            ot, ct = rglru.rglru_decode({k: v.detach() for k, v in pt.items()},
                                        T(x[:, t:t + 1]), ct, tcfg)
        close(oj, ot.numpy())
        close(full[:, t:t + 1].detach().numpy(), ot.numpy())
    close(cj.h, ct.h.numpy())


@pytest.mark.parametrize("kind", ["rec", "latt"])
def test_blocks_match_jax(kind):
    """One rec and one latt block of recurrentgemma smoke over 20 tokens
    (the latt window is 8): output, input gradient and every parameter
    gradient against JAX's ``block_train``; the latt block's prefill cache
    (a ring of 8 slots holding the last 8 positions) too."""
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    pj, _ = jax_blocks.init_block(kind, jcfg, jax.random.key(1), jnp.float32)
    pn = jax.tree.map(np.asarray, pj)
    rng = np.random.default_rng(3)
    L = 20
    x = rng.standard_normal((2, L, jcfg.d_model)).astype(np.float32)
    gy = rng.standard_normal((2, L, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (2, L))
    jrc = JaxRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none",
                       attn_kernel="jnp")

    def f(p, x):
        y, _, _ = jax_blocks.block_train(kind, jcfg, jrc, jax_exact_ctx(), p, x,
                                         jnp.asarray(pos), {}, None, jnp.float32(0))
        return y

    yj, vjp = jax.vjp(f, pj, jnp.asarray(x))
    gpj, gxj = vjp(jnp.asarray(gy))
    pt = jax.tree.map(lambda a: T(a).requires_grad_(), pn)
    leaves, names = [], []
    for path, leaf in jax.tree_util.tree_leaves_with_path(pt):
        names.append(jax.tree_util.keystr(path))
        leaves.append(leaf)
    xt = T(x).requires_grad_()
    yt, _ = blk.block_train(kind, tcfg, TR, exact_ctx(), pt, xt, torch.from_numpy(pos.copy()),
                            None, torch.zeros(()))
    grads = torch.autograd.grad(yt, [xt, *leaves], T(gy))
    assert rel(yt.detach().numpy(), yj) < 1e-5
    assert rel(grads[0].numpy(), gxj) < 1e-4
    gj = {jax.tree_util.keystr(p): np.asarray(v)
          for p, v in jax.tree_util.tree_leaves_with_path(gpj)}
    for name, g in zip(names, grads[1:]):
        assert rel(g.numpy(), gj[name]) < 1e-4, name
    if kind == "latt":
        cache = blk.init_block_cache(kind, tcfg, 2, 32, torch.float32, "cpu")
        assert cache.ring and cache.k.shape[1] == 8
        with torch.no_grad():
            blk.block_train(kind, tcfg, TR, exact_ctx(), jax.tree.map(lambda t: t.detach(), pt),
                            xt.detach(), torch.from_numpy(pos.copy()), None, torch.zeros(()),
                            cache=cache)
        assert sorted(cache.slot_pos[0].tolist()) == list(range(L - 8, L))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
N_REC, N_LATT = 4, 1     # recurrentgemma smoke: (rec, rec, latt) x 1, (rec, rec) x 1


@pytest.mark.parametrize("remat", ["none", "full", "pamm"])
@pytest.mark.parametrize("spec", ["", SPEC])
def test_training_matches_jax(spec, remat):
    """Loss, every gradient and the telemetry of both sites against JAX.
    Under the PAMM rules K1 runs once a site a layer (again in
    remat='full''s recompute): 4 rglru.in + 1 attn.qkv; K2 once a weight:
    4 w_x + wq, wk, wv; K3 once a latt layer (twice under remat), K4/K5
    once."""
    jr, tr, params, batch, model = training_setup(ARCH, spec=spec, remat=remat)
    _, _, sites, counts = check_against_jax(ARCH, tr, jr, params, batch, model)
    attn = {"flash_attention_fwd_ref": (1 if remat == "none" else 2) * N_LATT,
            "flash_attention_bwd_ref": N_LATT}
    if not spec:
        assert counts == attn and sites == {}
        return
    k1 = (N_REC + N_LATT) * (2 if remat == "full" else 1)
    assert counts == {"csim_argmax_ref": k1, "segment_matmul_ref": N_REC + 3 * N_LATT, **attn}
    rec_sites = sorted(p for p in sites if p.endswith("rglru.in"))
    assert rec_sites == ["stage0.rec.rglru.in", "stage1.rec.rglru.in"]
    assert [p for p in sites if p.endswith("attn.qkv")] == ["stage0.latt.attn.qkv"]
    stored, kept, total, beta, obs = sites["stage1.rec.rglru.in"].tolist()
    assert stored > 0 and 0 < kept <= total == 2 * batch["tokens"].size and obs == 2


@pytest.mark.parametrize("structure", ["reversible", "reversible_ref"])
def test_reversible_matches_jax(structure):
    """Both reversible structures under the PAMM rules against JAX; K1
    twice a site a layer under ``reversible`` (the forward compresses for
    the telemetry, the backward's recompute for the gradient), K3 twice;
    ``reversible`` also against ``reversible_ref``."""
    jr, tr, params, batch, model = training_setup(ARCH, spec=SPEC, block_structure=structure)
    loss, grads, sites, counts = check_against_jax(ARCH, tr, jr, params, batch, model)
    twice = 2 if structure == "reversible" else 1
    assert counts == {"csim_argmax_ref": twice * (N_REC + N_LATT),
                      "segment_matmul_ref": N_REC + 3 * N_LATT,
                      "flash_attention_fwd_ref": twice * N_LATT,
                      "flash_attention_bwd_ref": N_LATT}
    if structure == "reversible":
        loss_r, grads_r, _, _ = port_loss_grads(
            ARCH, dataclasses.replace(tr, block_structure="reversible_ref"), model, batch)
        assert float(loss) == pytest.approx(float(loss_r), rel=1e-6)
        for name, g in grads.items():
            ref = grads_r[name]
            assert float((g - ref).abs().max()) <= 1e-4 * float(ref.abs().max()) + 1e-30, name
