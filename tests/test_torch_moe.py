"""The MoE block kind in the port on the CPU, against the JAX package: the
MoE FFN (``models/moe.py``) in both dispatch modes, at a capacity that
drops pairs and one that does not; a JAX tree padded with dead experts;
loss, gradients and telemetry of training under ``attn.qkv`` and
``moe.expert`` PAMM (the residual stack under every remat mode, the
reversible stacks); prefill and decode; the serving engine; and the
batched K1 / K2 plain versions against the JAX kernels, vmapped over the
experts as the JAX package's ``apply_batched`` does. Inputs are seeded
numpy, f32; the JAX draws reach the port through ``JaxSampler``.

Tolerances: the routing (top-k ids, the pair sort and which pairs are
kept) and the greedy tokens equal exactly; aux 1e-6 relative (an f32 mean
over the tokens, summed in another order); MoE outputs 1e-5 relative (norm
of the difference over the norm of JAX's); loss 1e-5 absolute, gradients
1e-4 relative and telemetry 1e-6 relative, as in ``test_torch_remat.py``;
logits rtol 1e-4 / atol 1e-5, as in ``test_torch_serving.py``; the
batched plain kernels 1e-5 of their largest output (f32 sums in another
order), the indices exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.data import SyntheticStream
from repro.kernels.pamm_apply import segment_matmul as jax_segment_matmul
from repro.kernels.pamm_compress import csim_argmax as jax_csim_argmax
from repro.models import decode_step as jax_decode_step
from repro.models import init_model as jax_init_model
from repro.models import prefill as jax_prefill
from repro.models import moe as jax_moe
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config
from repro_torch.core.keys import Key, TorchSampler, choice_batched
from repro_torch.core.policies import PammPolicy
from repro_torch.kernels import ops
from repro_torch.models import decode_step, forward, moe, prefill
from repro_torch.serve import Request, ServeEngine
from tests.test_torch_linear import JaxSampler
from tests.test_torch_remat import check_against_jax, port_loss_grads
from tests.test_torch_revnet import worst_rel

ARCHS = ["granite-moe-3b-a800m_smoke", "kimi-k2-1t-a32b_smoke"]
SPEC = "attn.qkv=pamm(r=1/8);moe.expert=pamm(r=1/4,backend=jnp)"


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def moe_setup(arch, capacity_factor=1.25, e_pad=0):
    """(JAX cfg, port cfg, JAX MoE params, x (2, 16, d) f32)."""
    jcfg = dataclasses.replace(jax_get_config(arch), capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(get_config(arch), capacity_factor=capacity_factor)
    params, _ = jax_moe.init_moe(jax.random.key(0), jcfg, jnp.float32, e_pad=e_pad)
    x = np.random.default_rng(1).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, params, x


def jax_routing(params, x2d, cfg):
    """The routing lines of ``repro/models/moe.py:_moe_tokens``: (gate_i,
    perm, valid)."""
    t, k = x2d.shape[0], cfg.n_experts_per_tok
    cap = jax_moe.moe_capacity(t, cfg)
    probs = jax.nn.softmax(x2d.astype(jnp.float32) @ params["router"], axis=-1)
    _, gate_i = jax.lax.top_k(probs, k)
    flat_e = gate_i.reshape(-1)
    perm = jnp.argsort(flat_e)
    sorted_e = jnp.take(flat_e, perm)
    counts = jax.ops.segment_sum(jnp.ones((t * k,), jnp.int32), flat_e,
                                 num_segments=cfg.n_experts)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(t * k, dtype=jnp.int32) - jnp.take(starts, sorted_e)
    return np.asarray(gate_i), np.asarray(perm), np.asarray(rank < cap)


@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, gather, capacity_factor):
    """Routing ids, the pair sort and the keep mask equal JAX's exactly,
    aux and the output within tolerance; at capacity factor 1.25 pairs are
    dropped, at 16 none."""
    jcfg, tcfg, params, x = moe_setup(arch, capacity_factor)
    out_j, aux_j = jax_moe.moe_ffn(params, jnp.asarray(x), jcfg, gather_dispatch=gather)
    tp = to_torch(params)
    xt = torch.from_numpy(x)
    out_t, aux_t = moe.moe_ffn(tp, xt, tcfg, gather_dispatch=gather)
    assert out_t.shape == x.shape
    assert rel(out_t.numpy(), out_j) < 1e-5
    assert float(aux_t) == pytest.approx(float(aux_j), rel=1e-6)

    x2d = x.reshape(-1, jcfg.d_model)
    gate_i, perm, valid = jax_routing(params, jnp.asarray(x2d), jcfg)
    _, _, gi = moe.route(tp["router"], torch.from_numpy(x2d), tcfg.n_experts_per_tok)
    ep, cap = tp["w_gate"].shape[0], moe.moe_capacity(x2d.shape[0], tcfg)
    perm_t, dest, pair_slot, slot_pair = moe.dispatch_plan(gi, cap, ep)
    np.testing.assert_array_equal(gi.numpy(), gate_i)
    np.testing.assert_array_equal(perm_t.numpy(), perm)
    np.testing.assert_array_equal((dest < ep * cap).numpy(), valid)
    assert (not valid.all()) == (capacity_factor < 2)
    assert torch.equal(pair_slot.reshape(-1)[perm_t], dest)
    kept = dest < ep * cap
    assert torch.equal(slot_pair[dest[kept]], perm_t[kept])
    assert int((slot_pair >= 0).sum()) == int(kept.sum())


@pytest.mark.parametrize("gather", [True, False])
def test_padded_expert_tree_computes_the_same(gather):
    """A JAX tree padded with dead experts (``e_pad``, granite 8 -> 12)
    loads and computes the unpadded tree's output: the padding is never
    routed to."""
    arch = "granite-moe-3b-a800m_smoke"
    jcfg, tcfg, params, x = moe_setup(arch)
    _, _, padded, _ = moe_setup(arch, e_pad=12)
    assert padded["w_gate"].shape[0] == 12 and params["w_gate"].shape[0] == 8
    out_j, aux_j = jax_moe.moe_ffn(params, jnp.asarray(x), jcfg, gather_dispatch=gather)
    out_t, aux_t = moe.moe_ffn(to_torch(padded), torch.from_numpy(x), tcfg,
                               gather_dispatch=gather)
    assert rel(out_t.numpy(), out_j) < 1e-5
    assert float(aux_t) == pytest.approx(float(aux_j), rel=1e-6)


def setup(arch, seq=32, batch=4, spec=SPEC, **kw):
    """JAX and port run configs (f32, ``spec``), JAX parameters, one batch
    and the port model holding the same parameters."""
    common = dict(compression=spec, policy_name="none", compute_dtype="float32",
                  param_dtype="float32", loss_chunk=16, **kw)
    jr = JaxRunConfig(attn_kernel="jnp", **common)
    tr = RunConfig(**common)
    params, _ = jax_init_model(jax_get_config(arch), jr, jax.random.key(0))
    b = SyntheticStream.for_arch(jax_get_config(arch), seq, batch).get_batch(0)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), get_config(arch),
                                   device="cpu", trainable=True)
    return jr, tr, params, b, model


def _layers(arch):
    """(layers with attention, moe layers) of an arch."""
    cfg = get_config(arch)
    return cfg.n_layers, sum(rep for unit, rep in cfg.stages if "moe" in unit)


@pytest.mark.parametrize("remat", ["none", "full", "pamm"])
@pytest.mark.parametrize("arch", ARCHS)
def test_training_matches_jax(arch, remat):
    """Loss, every gradient and the site telemetry (``moe.expert``
    included) against JAX, with pairs dropped at capacity 1.25. The
    experts' K1 and K2 run once a site a layer for all experts
    (``*_batched``); under ``remat='full'`` K1 runs again in the
    recompute, under ``'pamm'`` the states cross the boundary and it runs
    once."""
    jr, tr, params, batch, model = setup(arch, remat=remat)
    _, _, sites, counts = check_against_jax(arch, tr, jr, params, batch, model)
    n, n_moe = _layers(arch)
    assert any(path.endswith("moe.expert") for path in sites)
    again = 2 if remat == "full" else 1
    assert counts == {"csim_argmax_ref": again * n, "segment_matmul_ref": 3 * n,
                      "csim_argmax_batched_ref": again * n_moe,
                      "segment_matmul_batched_ref": 2 * n_moe,
                      "flash_attention_fwd_ref": (1 if remat == "none" else 2) * n,
                      "flash_attention_bwd_ref": n}
    cfg = get_config(arch)
    t = batch["tokens"].size
    kept = sum(float(v[1]) for p, v in sites.items() if p.endswith("moe.expert"))
    # every routed pair kept at capacity is a nonzero row; padding is not
    assert 0 < kept <= n_moe * t * cfg.n_experts_per_tok


@pytest.mark.parametrize("policy", ["uniform_crs(r=1/4)", "compact(r=1/4)",
                                    "pamm(r=1/4,blocks=2,backend=jnp)"])
def test_expert_site_policies_match_jax(policy):
    """The moe.expert site under the other policies of the plan grammar
    (one state per expert: CRS and CompAct through the policies' loop over
    the experts, blocked PAMM through experts x blocks in one K1 launch):
    loss, every gradient and the telemetry against JAX."""
    arch = "granite-moe-3b-a800m_smoke"
    jr, tr, params, batch, model = setup(arch, spec=f"moe.expert={policy}")
    _, _, sites, _ = check_against_jax(arch, tr, jr, params, batch, model)
    assert list(sites) == ["stage0.moe.moe.expert"]


@pytest.mark.parametrize("structure", ["reversible", "reversible_ref"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reversible_moe_matches_jax(arch, structure):
    """The reversible stacks with moe blocks against the JAX package's
    (``tests/test_revnet.py``'s aux-loss case): loss, every gradient (the
    router's reaches it only through the gate weights and the balance
    loss, whose cotangent the stage's backward threads through G) and
    the telemetry; ``reversible`` also against ``reversible_ref``."""
    jr, tr, params, batch, model = setup(arch, block_structure=structure)
    loss, grads, _, _ = check_against_jax(arch, tr, jr, params, batch, model)
    if structure == "reversible":
        loss_r, grads_r, _, _ = port_loss_grads(
            arch, dataclasses.replace(tr, block_structure="reversible_ref"), model, batch)
        assert float(loss) == pytest.approx(float(loss_r), rel=1e-6)
        assert worst_rel(grads, grads_r) < 1e-4


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """At capacity factor 16 (no pair dropped: ``tests/test_models_smoke.py
    ::test_decode_matches_full_forward``): prefill logits and caches, then
    three decode steps, against JAX; and decode against the port's own
    teacher-forced forward."""
    jcfg = dataclasses.replace(jax_get_config(arch), capacity_factor=16.0)
    tcfg = dataclasses.replace(get_config(arch), capacity_factor=16.0)
    jr = JaxRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
    tr = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
    params, _ = jax_init_model(jcfg, jr, jax.random.key(0))
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rng = np.random.default_rng(3)
    seq = rng.integers(0, jcfg.vocab_size, size=(2, 19)).astype(np.int32)
    L = 16
    lj, cj = jax_prefill(jcfg, jr, params, {"tokens": jnp.asarray(seq[:, :L])}, 32)
    lt, ct = prefill(tcfg, tr, model, {"tokens": torch.from_numpy(seq[:, :L]).long()}, 32)
    _close(lj, lt.numpy())
    for stage_j, stage_t in zip(cj, ct):
        for node_j, node_t in zip(stage_j, stage_t):
            _close(node_j.k, node_t.k.numpy())
            _close(node_j.v, node_t.v.numpy())
    with torch.no_grad():
        h, _ = forward(tcfg, tr, None, model, {"tokens": torch.from_numpy(seq).long()},
                       Key(0))
        full = (h @ model.head).numpy()
    _close(full[:, L - 1], lt[:, 0].numpy())
    for step in range(3):
        tok = seq[:, L + step:L + step + 1]
        pos = np.full((2, 1), L + step, np.int32)
        lj, cj = jax_decode_step(jcfg, jr, params, jnp.asarray(tok), jnp.asarray(pos), cj)
        lt, ct = decode_step(tcfg, tr, model, torch.from_numpy(tok).long(),
                             torch.from_numpy(pos), ct)
        _close(lj, lt.numpy())
        _close(full[:, L + step], lt[:, 0].numpy())


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_greedy_streams_match_jax_engine(layout):
    """granite smoke at its own capacity factor (decode steps of 2 slots
    drop pairs): greedy tokens equal the JAX engine's exactly, the
    capacity coupling included, as both decode every slot with the token
    it carries and prefill each prompt at its own length (bucketing off)."""
    arch = "granite-moe-3b-a800m_smoke"
    jr = JaxRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
    tr = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
    params, _ = jax_init_model(jax_get_config(arch), jr, jax.random.key(0))
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), get_config(arch),
                                   device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (12, 7, 10)]
    gen = 10
    jeng = JaxServeEngine(jax_get_config(arch), jr, params, max_slots=2, max_len=40,
                          decode_block=4, prefill_buckets=True)
    jout = jeng.run([JaxRequest(uid=i, tokens=p, max_new_tokens=gen)
                     for i, p in enumerate(prompts)])
    teng = ServeEngine(get_config(arch), tr, model, max_slots=2, max_len=40, decode_block=4,
                       cache_layout=layout, page_size=8, prefill_buckets=True)
    tout = teng.run([Request(uid=i, tokens=p, max_new_tokens=gen)
                     for i, p in enumerate(prompts)])
    assert teng.stats()["buckets_enabled"] is False
    assert jeng.stats()["buckets_enabled"] is False
    assert teng.bucket_lens == {12, 7, 10}
    for i in range(len(prompts)):
        assert tout[i].tokens == jout[i].tokens, i


def _granite_engines(prompts, gen=8, **kw):
    """granite smoke (f32) through the JAX and the port engine with the same
    options: (JAX engine, its outputs, port engine, its outputs)."""
    arch = "granite-moe-3b-a800m_smoke"
    jr = JaxRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
    tr = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
    params, _ = jax_init_model(jax_get_config(arch), jr, jax.random.key(0))
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), get_config(arch),
                                   device="cpu")
    kw = dict(max_slots=2, max_len=48, decode_block=4, cache_layout="paged", page_size=8,
              **kw)
    jeng = JaxServeEngine(jax_get_config(arch), jr, params, **kw)
    jout = jeng.run([JaxRequest(uid=i, tokens=p, max_new_tokens=gen)
                     for i, p in enumerate(prompts)])
    teng = ServeEngine(get_config(arch), tr, model, **kw)
    tout = teng.run([Request(uid=i, tokens=p, max_new_tokens=gen)
                     for i, p in enumerate(prompts)])
    return jeng, jout, teng, tout


@pytest.mark.parametrize("pool", ["int8", "int4", "svd(r=1/2)"])
def test_engine_compressed_pools_match_jax_engine(pool):
    """granite on int8 / int4 / svd page pools (K8, K7 on coefficients):
    greedy tokens equal the JAX engine's on the same format, the capacity
    coupling of a step included."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (12, 7, 10)]
    jeng, jout, teng, tout = _granite_engines(prompts, cache_compress=pool)
    assert teng.stats()["cache_pools"] == jeng.stats()["cache_pools"]
    for i in range(len(prompts)):
        assert tout[i].tokens == jout[i].tokens, i


def test_engine_prefix_sharing_matches_jax_engine():
    """Three prompts on a 20-token head (8-token pages: two pages adopted
    and a copy-on-write split each): tokens and the sharing counters equal
    the JAX engine's."""
    rng = np.random.default_rng(6)
    head = rng.integers(1, 256, size=20).tolist()
    prompts = [head + rng.integers(1, 256, size=3 + i).tolist() for i in range(3)]
    jeng, jout, teng, tout = _granite_engines(prompts, gen=6, prefix_share=True)
    counters = ("prefix_hits", "prefix_pages_adopted", "cow_page_splits", "retired_prefixes")
    st, jst = teng.stats(), jeng.stats()
    assert {c: st[c] for c in counters} == {c: jst[c] for c in counters}
    assert st["prefix_hits"] >= 1 and st["prefix_pages_adopted"] > 0
    for i in range(len(prompts)):
        assert tout[i].tokens == jout[i].tokens, i


def test_speculative_k_is_refused_as_in_jax():
    """The JAX engine verifies drafts on attn blocks only
    (``repro/serve/engine.py:443-454``): granite's moe blocks get the same
    refusal, word for word."""
    arch = "granite-moe-3b-a800m_smoke"
    jr = JaxRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
    tr = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
    params, _ = jax_init_model(jax_get_config(arch), jr, jax.random.key(0))
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), get_config(arch),
                                   device="cpu")
    kw = dict(max_slots=2, max_len=48, cache_layout="paged", page_size=8, speculative_k=2)
    with pytest.raises(ValueError) as jexc:
        JaxServeEngine(jax_get_config(arch), jr, params, **kw)
    with pytest.raises(ValueError) as texc:
        ServeEngine(get_config(arch), tr, model, **kw)
    assert str(texc.value) == str(jexc.value)
    assert "moe blocks are sequential" in str(texc.value)


# ---------------------------------------------------------------------------
# the batched K1 / K2 plain versions and the batched PAMM operations
# ---------------------------------------------------------------------------
def _expert_inputs(E, b, n, m, k, seed):
    """x (E, b, n) with expert 0 all zero and the second half of expert 1's
    rows zero (capacity padding), its generator rows, dZ, alpha."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, b, n)).astype(np.float32)
    x[0] = 0
    if E > 1:
        x[1, b // 2:] = 0
    idx = np.stack([rng.permutation(b)[:k] for _ in range(E)]).astype(np.int64)
    gz = rng.standard_normal((E, b, m)).astype(np.float32)
    return x, idx, gz


@pytest.mark.parametrize("E", [1, 3, 8])
def test_batched_kernels_match_vmapped_jax_kernels(E):
    """The batched K1 and K2 plain versions against the JAX Pallas kernels
    vmapped over the experts (interpret mode): an all-zero row gives cs 0,
    index 0 and norm 0; ties are impossible here, so the indices equal."""
    b, n, m, k = 64, 48, 40, 4
    x, idx, gz = _expert_inputs(E, b, n, m, k, seed=E)
    xt = torch.from_numpy(x)
    c = xt[torch.arange(E)[:, None], torch.from_numpy(idx)]
    cs, f, na = ops.csim_argmax_batched(xt, c)
    cj, fj, nj = jax.vmap(lambda a, cc: jax_csim_argmax(a, cc, interpret=True))(
        jnp.asarray(x), jnp.asarray(c.numpy()))
    np.testing.assert_allclose(cs.numpy(), np.asarray(cj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(f.numpy(), np.asarray(fj))
    np.testing.assert_allclose(na.numpy(), np.asarray(nj), rtol=1e-5)
    assert float(cs[0].abs().max()) == 0 and int(f[0].abs().max()) == 0
    assert float(na[0].abs().max()) == 0
    alpha = np.random.default_rng(E).standard_normal((E, b)).astype(np.float32)
    bt = ops.segment_matmul_batched(f, torch.from_numpy(alpha), torch.from_numpy(gz), k)
    bj = jax.vmap(lambda ff, aa, gg: jax_segment_matmul(ff, aa, gg, k, interpret=True))(
        jnp.asarray(f.numpy()), jnp.asarray(alpha), jnp.asarray(gz))
    scale = float(np.abs(np.asarray(bj)).max())
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("blocks", [1, 2])
def test_batched_pamm_equals_each_expert_alone(blocks):
    """PAMM's batched compress / apply (one K1 and one K2 launch for all
    experts; blocked: experts x blocks problems in one launch) give each
    expert what the 2-D path gives it alone, from the same keys: the
    states bit for bit, the gradients within 1e-6 relative (the thin
    C^T Btilde product batched: f32 sums in another order), the telemetry
    summed over the experts."""
    E, b, n, m = 3, 64, 16, 12
    x, _, gz = _expert_inputs(E, b, n, m, 4, seed=7)
    pol = PammPolicy(ratio=1 / 16, n_blocks=blocks)
    keys = Key(5, sampler=JaxSampler()).split(E)
    xt, gzt = torch.from_numpy(x), torch.from_numpy(gz)
    state = pol.compress_batched(xt, keys)
    dw = pol.grad_w_batched(state, gzt, n)
    assert dw.shape == (E, n, m)
    kept = beta = stored = 0
    for e in range(E):
        alone = pol.compress(xt[e], keys[e])
        for leaf_b, leaf in zip(state, alone):
            assert torch.equal(leaf_b[e], leaf)
        assert rel(dw[e].numpy(), pol.grad_w(alone, gzt[e], n).numpy()) < 1e-6
        k_e, beta_e = pol.state_stats(alone, b)
        kept, beta, stored = kept + k_e, beta + beta_e, stored + pol.stored_bytes(alone)
    got = pol.batched_stats(state, b, E)
    assert float(got[0]) == float(kept) and got[2] == stored
    assert float(got[1]) == pytest.approx(float(beta), rel=1e-6)
    assert float(state.alpha[0].abs().max()) == 0            # the all-zero expert


@pytest.mark.parametrize("E,b,k", [(40, 2048, 4), (3, 6, 6)])
def test_batched_choice_draws_every_expert_at_once(monkeypatch, E, b, k):
    """The default sampler draws a MoE site's E experts' generator rows in
    one op, not key by key: k distinct rows of range(b) each (the whole
    permutation at k = b), the same on a second draw, and another set per
    expert. Any other sampler (here JAX's threefry) draws key by key, each
    key's own choice."""
    keys = Key(7).fold_in(2).split(E)
    monkeypatch.setattr(TorchSampler, "choice",
                        lambda *a: pytest.fail("the default sampler drew key by key"))
    idx = choice_batched(keys, b, k, "cpu")
    assert idx.shape == (E, k) and idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) < b
    assert all(len(set(row.tolist())) == k for row in idx)
    assert torch.equal(idx, choice_batched(keys, b, k, "cpu"))
    if k < b:
        assert len({tuple(row.tolist()) for row in idx}) == E
    jkeys = Key(7, sampler=JaxSampler()).fold_in(2).split(3)
    assert torch.equal(choice_batched(jkeys, b, k, "cpu"),
                       torch.stack([key.choice(b, k, "cpu") for key in jkeys]))
