"""The ssm block kind (Mamba-2, ``models/ssm.py``) in the port on the CPU,
against the JAX package: the causal depthwise conv; the chunked SSD scan
(values and gradients, ragged lengths, a carried state, a group shared by
several heads); the mamba2-smoke loss and every gradient, exact and under
``ssm.in=pamm`` in every remat mode, with the site telemetry; prefill and
decode (prompt lengths across chunk boundaries, against JAX and against a
token-by-token recurrence); the serving engine (dense, and paged with
prefix sharing) token for token against the JAX engine; the
``prefill_buckets`` option; and the slot splices of ``serve/cache.py``
on a recurrent state node. Inputs are seeded numpy, f32; the JAX draws
reach the port through ``JaxSampler``.

Tolerances (f32): the conv 1e-6 relative (a sum of W products in the
same order); SSD outputs and final states 1e-5 relative and their
gradients 1e-4 relative (norm of the difference over the norm of JAX's;
measured 1e-7 to 1e-6: the same sums in another order); loss 1e-5
absolute, gradients 1e-4 relative and telemetry 1e-6 relative, as in
``test_torch_remat.py``; logits and states rtol 1e-4 / atol 1e-5, as in
``test_torch_serving.py``; greedy tokens exactly.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_model as jax_init_model
from repro.models import prefill as jax_prefill
from repro.models import ssm as jax_ssm
from repro.models.layers import causal_depthwise_conv as jax_conv
from repro.serve import Request as JaxRequest
from repro.serve import Router as JaxRouter
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import engine as jax_engine_mod
from repro.train.serve_step import greedy_decode as jax_greedy_decode
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config
from repro_torch.core.keys import Key
from repro_torch.models import decode_step, forward, init_caches, prefill, ssm
from repro_torch.models.layers import causal_depthwise_conv
from repro_torch.serve import (Request, Router, ServeEngine, cache_bytes, read_slot,
                               slot_bytes, write_slot)
from repro_torch.serve import engine as engine_mod
from repro_torch.train import greedy_decode, greedy_decode_per_token
from tests.test_torch_moe import setup as training_setup
from tests.test_torch_remat import check_against_jax

ARCH = "mamba2-370m_smoke"
JR = JaxRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
TR = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=1e-4, atol=1e-5)


def models(arch=ARCH, chunk=None):
    """(JAX cfg, JAX params, port cfg, port model) in f32; ``chunk``
    overrides the SSD chunk of both configs."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if chunk is not None:
        jcfg = dataclasses.replace(jcfg, ssm_chunk=chunk)
        tcfg = dataclasses.replace(tcfg, ssm_chunk=chunk)
    params, _ = jax_init_model(jcfg, JR, jax.random.key(0))
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


# ---------------------------------------------------------------------------
# the conv and the SSD scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("L", [1, 2, 3, 17])
def test_causal_depthwise_conv_matches_jax(L, with_state):
    """Width 4: a segment shorter than W-1 = 3 still hands on the last 3
    rows of concat(state, x)."""
    rng = np.random.default_rng(L)
    x = rng.standard_normal((2, L, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    state = rng.standard_normal((2, 3, 6)).astype(np.float32) if with_state else None
    yj, sj = jax_conv(jnp.asarray(x), jnp.asarray(w),
                      None if state is None else jnp.asarray(state))
    yt, st = causal_depthwise_conv(torch.from_numpy(x), torch.from_numpy(w),
                                   None if state is None else torch.from_numpy(state))
    assert rel(yt.numpy(), yj) < 1e-6
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    hist = np.zeros((2, 3, 6), np.float32) if state is None else state
    np.testing.assert_array_equal(st.numpy(), np.concatenate([hist, x], axis=1)[:, -3:])


def ssd_inputs(L, *, H=4, G=2, P=3, N=5, dt_scale=1.0, seed=0):
    rng = np.random.default_rng(seed + L)
    x = rng.standard_normal((2, L, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((2, L, H)))) * dt_scale).astype(np.float32)
    a = -np.exp(rng.standard_normal(H)).astype(np.float32)
    b = rng.standard_normal((2, L, G, N)).astype(np.float32)
    c = rng.standard_normal((2, L, G, N)).astype(np.float32)
    d = rng.standard_normal(H).astype(np.float32)
    s0 = rng.standard_normal((2, H, P, N)).astype(np.float32)
    gy = rng.standard_normal((2, L, H, P)).astype(np.float32)
    gs = rng.standard_normal((2, H, P, N)).astype(np.float32)
    return x, dt, a, b, c, d, s0, gy, gs


def jax_ssd_vjp(x, dt, a, b, c, d, s0, gy, gs, chunk):
    """JAX's (y, final_state) and the gradients of <y, gy> + <state, gs>
    w.r.t. x, dt, b, c (and the initial state when given)."""
    def f(x, dt, b, c, s0):
        return jax_ssm._ssd_chunked(x, dt, jnp.asarray(a), b, c, jnp.asarray(d), chunk,
                                    init_state=s0)
    args = [jnp.asarray(v) for v in (x, dt, b, c)] + [None if s0 is None else jnp.asarray(s0)]
    (y, st), vjp = jax.vjp(f, *args)
    grads = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    return np.asarray(y), np.asarray(st), [None if g is None else np.asarray(g) for g in grads]


def port_ssd_vjp(x, dt, a, b, c, d, s0, gy, gs, chunk):
    ts = [torch.from_numpy(v).requires_grad_() for v in (x, dt, b, c)]
    ts.append(None if s0 is None else torch.from_numpy(s0).requires_grad_())
    y, st = ssm._ssd_chunked(ts[0], ts[1], torch.from_numpy(a), ts[2], ts[3],
                             torch.from_numpy(d), chunk, init_state=ts[4])
    leaves = [t for t in ts if t is not None]
    grads = torch.autograd.grad((y * torch.from_numpy(gy)).sum()
                                + (st * torch.from_numpy(gs)).sum(), leaves)
    return y.detach().numpy(), st.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("L", [1, 7, 8, 9, 23])
def test_ssd_chunked_values_and_gradients_match_jax(L, with_state):
    """Chunk 8: one partial chunk, exactly one, one plus a row, three with
    a ragged tail; 2 groups of 2 heads each; with and without a carried
    state (its gradient too)."""
    x, dt, a, b, c, d, s0, gy, gs = ssd_inputs(L)
    s0 = s0 if with_state else None
    yj, sj, gj = jax_ssd_vjp(x, dt, a, b, c, d, s0, gy, gs, 8)
    yt, st, gt = port_ssd_vjp(x, dt, a, b, c, d, s0, gy, gs, 8)
    assert rel(yt, yj) < 1e-5 and rel(st, sj) < 1e-5
    gj = [g for g in gj if g is not None]
    assert len(gt) == len(gj) == 4 + with_state
    for name, g_t, g_j in zip(("x", "dt", "b", "c", "init_state"), gt, gj):
        assert rel(g_t, g_j) < 1e-4, name


def test_padding_leaves_the_state_unchanged():
    """A ragged tail is padded with dt = 0: the final state of L rows
    equals the state after the same L rows run as whole chunks, and the
    scan over one chunk of L rows equals the scan over chunks of 1 (the
    token-by-token recurrence)."""
    x, dt, a, b, c, d, s0, gy, gs = ssd_inputs(13)
    T = lambda v: torch.from_numpy(v)
    y8, s8 = ssm._ssd_chunked(T(x), T(dt), T(a), T(b), T(c), T(d), 8, init_state=T(s0))
    y13, s13 = ssm._ssd_chunked(T(x), T(dt), T(a), T(b), T(c), T(d), 13, init_state=T(s0))
    y1, s1 = ssm._ssd_chunked(T(x), T(dt), T(a), T(b), T(c), T(d), 1, init_state=T(s0))
    for y, s in ((y13, s13), (y1, s1)):
        assert rel(y8.numpy(), y.numpy()) < 1e-5 and rel(s8.numpy(), s.numpy()) < 1e-5


def test_masked_decay_is_finite_where_jax_overflows():
    """Large dt·|A|: JAX's exp(cum_q - cum_s) above the diagonal overflows
    before its mask, and its backward reads 0 · inf. The port masks before
    the exp: the same values, finite gradients, equal to JAX's wherever
    JAX's are finite."""
    x, dt, a, b, c, d, s0, gy, gs = ssd_inputs(16, dt_scale=10.0)
    yj, sj, gj = jax_ssd_vjp(x, dt, a, b, c, d, None, gy, gs, 16)
    yt, st, gt = port_ssd_vjp(x, dt, a, b, c, d, None, gy, gs, 16)
    assert np.isfinite(yj).all() and rel(yt, yj) < 1e-5 and rel(st, sj) < 1e-5
    assert not np.isfinite(gj[1]).all()          # JAX's dt gradient: NaN in one sequence
    for g_t, g_j in zip(gt, gj[:4]):
        assert np.isfinite(g_t).all()
        ok = np.isfinite(g_j)
        assert ok.any()
        np.testing.assert_allclose(g_t[ok], g_j[ok], rtol=1e-4, atol=1e-4)


def test_deterministic_inits_match_jax():
    """a_log = log(linspace(1, 16, H)), d_skip = 1, dt_bias =
    log(expm1(0.01)), all f32 whatever the parameter dtype, and out_norm
    = 0. XLA's and torch's f32 linspace and log may round a value to the
    other neighbour: a_log is held to one f32 ulp, the rest exactly."""
    for arch in (ARCH, "mamba2-370m"):
        pj, _ = jax_ssm.init_ssm(jax.random.key(0), jax_get_config(arch), jnp.bfloat16)
        pt = ssm.init_ssm(torch.Generator().manual_seed(0), get_config(arch), torch.bfloat16)
        assert set(pt) == set(pj)
        for k in pj:
            assert pt[k].dtype == (torch.float32 if k in ("a_log", "d_skip", "dt_bias")
                                   else torch.bfloat16), k
            assert tuple(pt[k].shape) == pj[k].shape, k
        for k in ("d_skip", "dt_bias"):
            np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))
        assert not pt["out_norm"].any()
        np.testing.assert_allclose(pt["a_log"].numpy(), np.asarray(pj["a_log"]), rtol=2.4e-7)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", ["none", "full", "pamm"])
@pytest.mark.parametrize("spec", ["", "ssm.in=pamm(r=1/8)"])
def test_training_matches_jax(spec, remat):
    """Loss, every gradient and the ssm.in telemetry (stored bytes, kept
    rows, beta) against JAX. Under the PAMM rule K1 and K2 run once a
    layer on the in-projection (K1 again in remat='full''s recompute);
    exact, no kernel runs (mamba2 has no attention)."""
    jr, tr, params, batch, model = training_setup(ARCH, spec=spec, remat=remat)
    _, _, sites, counts = check_against_jax(ARCH, tr, jr, params, batch, model)
    n = get_config(ARCH).n_layers
    if not spec:
        assert counts == {} and sites == {}
        return
    assert counts == {"csim_argmax_ref": (2 if remat == "full" else 1) * n,
                      "segment_matmul_ref": n}
    assert list(sites) == ["stage0.ssm.ssm.in"]
    stored, kept, total, beta, obs = sites["stage0.ssm.ssm.in"].tolist()
    assert stored > 0 and 0 < kept <= total == n * batch["tokens"].size and obs == n


def test_legacy_flag_equals_the_ssm_in_rule():
    """RunConfig.pamm_on_ssm_inproj resolves to the same ssm.in rule."""
    jr, tr, params, batch, model = training_setup(ARCH, spec="ssm.in=pamm(r=1/512)")
    legacy = dataclasses.replace(tr, compression="", policy_name="pamm",
                                 pamm_ratio=1 / 512, pamm_on_ssm_inproj=True)
    from tests.test_torch_remat import port_loss_grads

    loss, grads, sites, counts = port_loss_grads(ARCH, tr, model, batch)
    loss2, grads2, sites2, counts2 = port_loss_grads(ARCH, legacy, model, batch)
    assert torch.equal(loss, loss2) and counts == counts2
    assert sorted(sites) == sorted(sites2) == ["stage0.ssm.ssm.in"]
    for name in grads:
        assert rel(grads[name].numpy(), grads2[name].numpy()) < 1e-6, name


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
def _cache_close(cj, ct):
    for stage_j, stage_t in zip(cj, ct):
        for node_j, node_t in zip(stage_j, stage_t):
            assert isinstance(node_t, ssm.SSMCache)
            close(node_j.state, node_t.state.numpy())
            close(node_j.conv_state, node_t.conv_state.numpy())


def test_prefill_and_decode_match_jax_and_the_forward():
    """Prefill of 16 tokens, then three decode steps: logits and every
    layer's state against JAX, and each step's logits against a full
    forward over the same tokens."""
    jcfg, params, tcfg, model = models()
    seq = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 19)).astype(np.int32)
    L = 16
    lj, cj = jax_prefill(jcfg, JR, params, {"tokens": jnp.asarray(seq[:, :L])}, 32)
    lt, ct = prefill(tcfg, TR, model, {"tokens": torch.from_numpy(seq[:, :L]).long()}, 32)
    close(lj, lt.numpy())
    _cache_close(cj, ct)
    with torch.no_grad():
        h, _ = forward(tcfg, TR, None, model, {"tokens": torch.from_numpy(seq).long()}, Key(0))
        full = (h @ model.head).numpy()
    close(full[:, L - 1], lt[:, 0].numpy())
    for step in range(3):
        tok = seq[:, L + step:L + step + 1]
        pos = np.full((2, 1), L + step, np.int32)
        lj, cj = jax_decode_step(jcfg, JR, params, jnp.asarray(tok), jnp.asarray(pos), cj)
        lt, ct = decode_step(tcfg, TR, model, torch.from_numpy(tok).long(),
                             torch.from_numpy(pos), ct)
        close(lj, lt.numpy())
        close(full[:, L + step], lt[:, 0].numpy())
    _cache_close(cj, ct)


@pytest.mark.parametrize("L", [1, 2, 3, 127, 129, 1021])
def test_prefill_at_ragged_lengths_matches_jax(L):
    """Chunk 128 (mamba2's): a prompt inside one chunk, shorter than the
    conv's history, one row short of a chunk, one row over, and eight
    chunks less three rows. Logits and states against JAX; a prompt of
    at most 3 tokens also against decoding it token by token from the
    zero state."""
    jcfg, params, tcfg, model = models(chunk=128)
    seq = np.random.default_rng(L).integers(0, jcfg.vocab_size, (1, L)).astype(np.int32)
    lj, cj = jax_prefill(jcfg, JR, params, {"tokens": jnp.asarray(seq)}, L + 1)
    lt, ct = prefill(tcfg, TR, model, {"tokens": torch.from_numpy(seq).long()}, L + 1)
    close(lj, lt.numpy())
    _cache_close(cj, ct)
    if L <= 3:
        caches = init_caches(tcfg, TR, 1, L + 1, "cpu")
        for t in range(L):
            ld, caches = decode_step(tcfg, TR, model, torch.from_numpy(seq[:, t:t + 1]).long(),
                                     torch.full((1, 1), t, dtype=torch.int32), caches)
        close(lt.numpy(), ld.numpy())
        for node_d, node_p in zip(caches[0], ct[0]):
            close(node_p.state.numpy(), node_d.state.numpy())
            close(node_p.conv_state.numpy(), node_d.conv_state.numpy())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
PROMPTS = (12, 7, 10, 2)


def _prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, 256, size=n).tolist() for n in PROMPTS]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_greedy_streams_match_jax_engine(layout):
    """Two slots, four requests (a slot is reused): greedy tokens equal the
    JAX engine's exactly; each prompt prefilled at its own length; a
    request alone gives the same tokens as batched. Paged: an ssm arch
    has no page pool, so admission is the free-slot check and prefix
    sharing adopts nothing, in both engines."""
    jcfg, params, tcfg, model = models()
    kw = dict(max_slots=2, max_len=40, decode_block=4)
    if layout == "paged":
        kw.update(cache_layout="paged", page_size=8, prefix_share=True)
    prompts = _prompts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jeng = JaxServeEngine(jcfg, JR, params, **kw)
        teng = ServeEngine(tcfg, TR, model, **kw)
    jout = jeng.run([JaxRequest(uid=i, tokens=p, max_new_tokens=10)
                     for i, p in enumerate(prompts)])
    tout = teng.run([Request(uid=i, tokens=p, max_new_tokens=10)
                     for i, p in enumerate(prompts)])
    st, jst = teng.stats(), jeng.stats()
    assert st["buckets_enabled"] is jst["buckets_enabled"] is False
    assert teng.bucket_lens == set(PROMPTS)
    assert teng.allocators == [] and jeng.allocators == []
    for c in ("prefix_hits", "prefix_pages_adopted", "cow_page_splits"):
        assert st[c] == jst[c] == 0, c
    for i in range(len(prompts)):
        assert tout[i].tokens == jout[i].tokens, i
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        solo = ServeEngine(tcfg, TR, model, **kw)
    for i, p in enumerate(prompts):
        assert solo.run([Request(uid=10 + i, tokens=p, max_new_tokens=10)])[10 + i].tokens \
            == tout[i].tokens, i


def test_speculative_k_is_refused_as_in_jax():
    jcfg, params, tcfg, model = models()
    kw = dict(max_slots=2, max_len=40, cache_layout="paged", page_size=8, speculative_k=2)
    msgs = []
    for make in (lambda: JaxServeEngine(jcfg, JR, params, **kw),
                 lambda: ServeEngine(tcfg, TR, model, **kw)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with pytest.raises(ValueError) as exc:
                make()
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert "speculative_k needs every block" in msgs[1] and "ssm blocks" in msgs[1]


def _built(make):
    """(the engine, the bucket warnings its construction gave)."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        eng = make()
    return eng, [str(w.message) for w in rec if "prefill buckets" in str(w.message)]


@pytest.mark.parametrize("arch,coupled", [(ARCH, "ssm"), ("internlm2-1.8b_smoke", None)])
def test_prefill_buckets_option_matches_jax(arch, coupled):
    """tests/test_disagg.py's contract, case for case against the JAX
    engine: None decides by the kinds and warns once per coupled arch,
    naming the kind; a second engine stays quiet; False gives no warning
    and no buckets (and does not use up the one warning); True cannot turn
    bucketing on for a coupled kind; False turns it off for an attention
    arch. buckets_enabled and the warnings equal the JAX engine's."""
    jcfg, params, tcfg, model = models(arch)
    kw = dict(max_slots=1, max_len=32)
    for mod in (engine_mod, jax_engine_mod):
        mod._BUCKET_WARNED.clear()
    n_warn = []
    for opt in (False, None, None, False, True):
        port, port_w = _built(lambda: ServeEngine(tcfg, TR, model, prefill_buckets=opt, **kw))
        ref, ref_w = _built(lambda: JaxServeEngine(jcfg, JR, params, prefill_buckets=opt,
                                                   **kw))
        want = False if coupled else opt is not False
        assert port.stats()["buckets_enabled"] is ref.stats()["buckets_enabled"] is want
        assert port_w == ref_w
        assert all(coupled in w and arch in w for w in port_w)
        n_warn.append(len(port_w))
    assert n_warn == ([0, 1, 0, 0, 0] if coupled else [0] * 5)


# ---------------------------------------------------------------------------
# serve/cache.py on a recurrent state node
# ---------------------------------------------------------------------------
def test_slot_splices_carry_the_state():
    """write_slot splices the state and conv_state into the slot (over a
    previous occupant's values, not skipped), read_slot gives them back,
    cache_bytes / slot_bytes count them; a Prefix moved to the host and
    admitted gives the same stream as one admitted on its device."""
    jcfg, params, tcfg, model = models()
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 256, size=9).tolist()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng = ServeEngine(tcfg, TR, model, max_slots=3, max_len=32, decode_block=4)
        host = ServeEngine(tcfg, TR, model, max_slots=3, max_len=32, decode_block=4)
    full = eng.caches
    for node in full[0]:
        for t in node.tensors():
            t.fill_(7.0)                       # a previous occupant's state
    prefix = eng.prefill(model, Request(uid=0, tokens=prompt, max_new_tokens=5))
    one = prefix.caches
    assert isinstance(one[0][0], ssm.SSMCache)
    assert one[0][0].state.abs().sum() > 0 and one[0][0].conv_state.abs().sum() > 0
    write_slot(full, one, 1)
    back = read_slot(full, 1)
    for a, b in zip(back[0][0].tensors(), one[0][0].tensors()):
        assert torch.equal(a, b)
    for s in (0, 2):                            # the other slots untouched
        assert (read_slot(full, s)[0][0].state == 7.0).all()
    node = full[0][0]
    want = node.state.numel() * 4 + node.conv_state.numel() * 4
    assert cache_bytes(full) == want and slot_bytes(full, 3) == want // 3
    assert eng.stats()["cache_slot_bytes"] == want // 3
    # the host hand-off: every leaf moves, and the stream is the same
    ref = eng.run([Request(uid=1, tokens=prompt, max_new_tokens=5)])[1].tokens
    moved = host.prefill(model, Request(uid=2, tokens=prompt, max_new_tokens=5)).to_host()
    assert all(t.device.type == "cpu" for n in moved.caches[0] for t in n.tensors())
    assert host.admit_prefix(moved, 0) is None
    done = {}
    while host.has_work:
        done.update({o.uid: o for o in host.step()})
    assert done[2].tokens == ref


# ---------------------------------------------------------------------------
# the serving front and the per-token loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_router_matches_jax_router(layout):
    """Five requests through Routers over 2 mamba2 replicas of 2 slots: the
    same placement and peak concurrency as the JAX Router, tokens equal to
    its and to one engine's; then 2 replicas behind a 1-slot prefill
    engine, each Prefix handed off in host form (the recurrent state
    included), the replicas running no prefill."""
    jcfg, params, tcfg, model = models()
    kw = dict(max_slots=2, max_len=40, decode_block=4)
    if layout == "paged":
        kw.update(cache_layout="paged", page_size=8)
    lengths = (10, 7, 9, 12, 5)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in lengths]
    reqs = lambda make: [make(uid=i, tokens=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jrouter = JaxRouter([JaxServeEngine(jcfg, JR, params, **kw) for _ in range(2)])
        trouter = Router([ServeEngine(tcfg, TR, model, **kw) for _ in range(2)])
        solo = ServeEngine(tcfg, TR, model, **kw).run(reqs(Request))
        pf = ServeEngine(tcfg, TR, model, **{**kw, "max_slots": 1})
        front = Router([ServeEngine(tcfg, TR, model, **kw) for _ in range(2)],
                       prefill_engine=pf)
    jout, tout, fout = jrouter.run(reqs(JaxRequest)), trouter.run(reqs(Request)), \
        front.run(reqs(Request))
    assert trouter.placement == jrouter.placement
    assert trouter.stats()["peak_active_aggregate"] == jrouter.stats()[
        "peak_active_aggregate"] == 4
    for i in range(len(prompts)):
        assert tout[i].tokens == jout[i].tokens == solo[i].tokens == fout[i].tokens, i
    assert pf.prefill_count == len(prompts)
    assert all(s["prefill_count"] == 0 for s in front.stats()["per_replica"])


def test_greedy_decode_equals_per_token_loop_and_jax():
    """serve_step's greedy_decode (the engine's blocks) equals the
    per-token loop over decode_step and JAX's greedy_decode."""
    jcfg, params, tcfg, model = models()
    toks = np.random.default_rng(8).integers(1, 256, (3, 11)).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        fused = greedy_decode(tcfg, TR, model, {"tokens": torch.from_numpy(toks)}, steps=6,
                              max_len=24)
    loop = greedy_decode_per_token(tcfg, TR, model, {"tokens": torch.from_numpy(toks)},
                                   steps=6, max_len=24)
    want = np.asarray(jax_greedy_decode(jcfg, JR, params, {"tokens": jnp.asarray(toks)},
                                        steps=6, max_len=24))
    assert torch.equal(fused, loop)
    np.testing.assert_array_equal(fused.numpy(), want)


def test_serve_and_train_clis_run_mamba2_on_the_cpu(capsys):
    """The CLIs on mamba2 smoke: serving dense and paged (the stats line
    says bucketing is off), training through the ssm.in rule."""
    from repro_torch.launch import serve, train

    for extra in ([], ["--cache-layout", "paged", "--page-size", "8", "--prefix-share"]):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--requests", "3",
                        "--prompt-len", "10", "--gen", "4", "--smoke", *extra])
        out = capsys.readouterr().out
        assert "SMOKE OK" in out and "bucketing off" in out
    train.main(["--arch", ARCH, "--device", "cpu", "--steps", "3", "--seq-len", "16",
                "--global-batch", "2", "--log-every", "1",
                "--compression", "ssm.in=pamm(r=1/8)"])
    out = capsys.readouterr().out
    assert out.count("step ") == 3 and "done: 3 steps" in out
