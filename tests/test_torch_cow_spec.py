"""The port's copy-on-write prefix sharing and speculative verify against
the JAX package, on the CPU.

* For fp, int8 and svd pools, a prefix-shared run's tokens equal an
  unshared run's and the JAX prefix-sharing engine's, and the sharing
  counters (``prefix_hits``, ``prefix_pages_adopted``,
  ``cow_page_splits``) equal the JAX engine's on the same requests; the
  divergence falls mid-page (a split) and on a page boundary (none).
* Refcounts conserve under eviction churn, and evicting every retired
  prefix frees the whole pool.
* ``cow_split_pages`` copies exactly the shared window, leaf for leaf
  with JAX.
* Speculative streams (fp and int8) equal sequential greedy decoding and
  the JAX speculative engine's, with equal ``spec_tokens_accepted``; a
  replayed prompt drafts from its retired donor; a sampling request drops
  the block to the sequential loop.
* The gating errors of the JAX engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, get_config
from repro.models import init_model
from repro.models.attention import PagedKVCache as JaxPagedKVCache
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.cache import cow_split_pages as jax_cow_split_pages
from repro_torch import bridge
from repro_torch.configs import RunConfig as TorchRunConfig
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models.attention import PagedKVCache
from repro_torch.serve import Request, SamplingParams, ServeEngine
from repro_torch.serve.cache import cow_split_pages

RCFG = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
TRCFG = TorchRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
POOL_VARIANTS = {
    "fp": dict(cache_layout="paged", page_size=8),
    "int8": dict(cache_layout="paged", page_size=8, cache_compress="int8"),
    "svd": dict(cache_layout="paged", page_size=8, cache_compress="svd(r=1/2)"),
}
COUNTERS = ("prefix_hits", "prefix_pages_adopted", "cow_page_splits", "spec_verify_calls",
            "spec_tokens_drafted", "spec_tokens_accepted")


def _setup(arch="internlm2-1.8b_smoke"):
    cfg = get_config(arch)
    params, _ = init_model(cfg, RCFG, jax.random.key(0))
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), torch_get_config(arch),
                                   device="cpu")
    return cfg, params, torch_get_config(arch), model


def _shared_prefix_prompts(cfg, n=4, prefix_len=20, seed=0):
    """n prompts sharing a head, with tails of growing length."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, cfg.vocab_size, size=prefix_len).tolist()
    return [head + rng.integers(1, cfg.vocab_size, size=3 + i).tolist() for i in range(n)]


def _run_both(cfg, params, tcfg, model, prompts, max_new, **kw):
    """The same greedy requests through the JAX and the port engine."""
    jeng = JaxServeEngine(cfg, RCFG, params, **kw)
    jout = jeng.run([JaxRequest(uid=i, tokens=p, max_new_tokens=max_new)
                     for i, p in enumerate(prompts)])
    eng = ServeEngine(tcfg, TRCFG, model, **kw)
    out = eng.run([Request(uid=i, tokens=p, max_new_tokens=max_new)
                   for i, p in enumerate(prompts)])
    return jeng, jout, eng, out


def _evict_all_and_check_free(eng):
    while eng._evict_one_retired():
        pass
    for alloc in eng.allocators:
        alloc.check_invariant()
        assert alloc.free_pages == alloc.spec.n_pages, "pages leaked"


# ---------------------------------------------------------------------------
# copy-on-write prefix sharing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant,prefix_len", [("fp", 20), ("fp", 16), ("int8", 20),
                                                ("svd", 20)])
def test_cow_shared_prefix_matches_unshared_and_jax(variant, prefix_len):
    """prefix_len 20 diverges mid-page (8-token pages: a copy-on-write
    split); 16 on a page boundary (pages adopted, nothing copied)."""
    cfg, params, tcfg, model = _setup()
    prompts = _shared_prefix_prompts(cfg, prefix_len=prefix_len)
    kw = dict(max_slots=4, max_len=64, decode_block=3, **POOL_VARIANTS[variant])
    base = ServeEngine(tcfg, TRCFG, model, **kw).run(
        [Request(uid=i, tokens=p, max_new_tokens=6) for i, p in enumerate(prompts)])
    jeng, jout, eng, out = _run_both(cfg, params, tcfg, model, prompts, 6,
                                     prefix_share=True, **kw)
    for i in base:
        assert out[i].tokens == base[i].tokens, f"request {i} diverged from unshared"
        assert out[i].tokens == jout[i].tokens, f"request {i} diverged from JAX"
    st, jst = eng.stats(), jeng.stats()
    assert {c: st[c] for c in COUNTERS} == {c: jst[c] for c in COUNTERS}
    assert st["prefix_hits"] >= 3 and st["prefix_pages_adopted"] > 0
    assert (st["cow_page_splits"] > 0) == (prefix_len % 8 != 0)
    assert st["retired_prefixes"] == jst["retired_prefixes"] == 4
    _evict_all_and_check_free(eng)


def test_cow_refcount_invariant_under_eviction_churn():
    """Waves of shared-prefix traffic through 12 pages with at most two
    retired prefixes kept: retired entries are evicted under pressure,
    refcounts conserve after every step, and tokens never change."""
    cfg, params, tcfg, model = _setup()
    rng = np.random.default_rng(4)
    heads = [rng.integers(1, cfg.vocab_size, size=16).tolist() for _ in range(3)]
    waves = [[Request(uid=100 * w + i, tokens=heads[(w + i) % 3] + rng.integers(
                 1, cfg.vocab_size, size=3 + i).tolist(), max_new_tokens=4)
              for i in range(3)] for w in range(4)]
    kw = dict(max_slots=2, max_len=48, decode_block=2, cache_layout="paged", page_size=8,
              pool_tokens=96)
    base = {}
    for w in waves:
        base.update(ServeEngine(tcfg, TRCFG, model, **kw).run(
            [Request(uid=r.uid, tokens=r.tokens, max_new_tokens=4) for r in w]))
    eng = ServeEngine(tcfg, TRCFG, model, prefix_share=True, prefix_cache=2, **kw)
    for w in waves:
        for r in w:
            eng.submit(r)
        while eng.has_work:
            for out in eng.step():
                assert out.tokens == base[out.uid].tokens, f"request {out.uid} diverged"
            for alloc in eng.allocators:
                alloc.check_invariant()
    assert eng.stats()["prefix_hits"] > 0
    _evict_all_and_check_free(eng)


def test_cow_capacity_multiplier_at_fixed_pool():
    """8 requests sharing a 48-token prompt at a pool of ~3 unshared
    reservations: sharing admits at least twice as many at once, with the
    unshared tokens."""
    cfg, params, tcfg, model = _setup()
    rng = np.random.default_rng(6)
    head = rng.integers(1, cfg.vocab_size, size=48).tolist()
    prompts = [head + rng.integers(1, cfg.vocab_size, size=1 + i % 3).tolist()
               for i in range(8)]
    mk = lambda: [Request(uid=i, tokens=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    kw = dict(max_slots=8, max_len=64, decode_block=2, cache_layout="paged", page_size=8,
              pool_tokens=168)
    base = ServeEngine(tcfg, TRCFG, model, **kw)
    out_b = base.run(mk())
    eng = ServeEngine(tcfg, TRCFG, model, prefix_share=True, **kw)
    out_s = eng.run(mk())
    assert all(out_s[i].tokens == out_b[i].tokens for i in out_b)
    assert eng.peak_active >= 2 * base.peak_active
    _evict_all_and_check_free(eng)


def test_cow_split_pages_copies_exact_window():
    """Only the rows of the source page whose positions lie in [lo, hi)
    move, with their page_pos; -1 is a no-op; leaf for leaf with JAX."""
    layers, n_pages, ps, KV, dh = 2, 6, 8, 2, 16
    rng = np.random.default_rng(5)
    kp = rng.standard_normal((layers, n_pages, ps, KV, dh)).astype(np.float32)
    vp = rng.standard_normal((layers, n_pages, ps, KV, dh)).astype(np.float32)
    pp = np.full((layers, n_pages, ps), -1, np.int32)
    pp[:, 2] = np.arange(16, 16 + ps)
    jnode = JaxPagedKVCache(k_pages=jnp.asarray(kp), v_pages=jnp.asarray(vp),
                            page_pos=jnp.asarray(pp),
                            block_table=jnp.full((layers, 1, 4), -1, jnp.int32),
                            ring=jnp.zeros((layers,), jnp.int32))
    mk = lambda: PagedKVCache(torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()),
                              torch.from_numpy(pp.copy()),
                              torch.full((layers, 1, 4), -1, dtype=torch.int32), False)
    node = mk()
    cow_split_pages([[node]], [[2]], [[4]], 16, 20)
    jout = jax_cow_split_pages(jnode, jnp.int32(2), jnp.int32(4), jnp.int32(16),
                               jnp.int32(20))
    for f in ("k_pages", "v_pages", "page_pos"):
        np.testing.assert_array_equal(getattr(node, f).numpy(), np.asarray(getattr(jout, f)))
    np.testing.assert_array_equal(node.page_pos[:, 4, :4].numpy(), pp[:, 2, :4])
    assert (node.page_pos[:, 4, 4:] == -1).all()
    np.testing.assert_array_equal(node.k_pages[:, 2].numpy(), kp[:, 2])
    noop = mk()
    cow_split_pages([[noop]], [[-1]], [[4]], 16, 20)
    np.testing.assert_array_equal(noop.page_pos.numpy(), pp)


# ---------------------------------------------------------------------------
# speculative verify
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["fp", "int8"])
def test_speculative_stream_matches_sequential_greedy_and_jax(variant):
    """k = 4 with n-gram drafts (mostly rejected, sometimes accepted): the
    exact sequential greedy stream, and the JAX engine's counters."""
    cfg, params, tcfg, model = _setup()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, size=8 + 3 * i).tolist() for i in range(3)]
    kw = dict(max_slots=3, max_len=64, decode_block=3, **POOL_VARIANTS[variant])
    base = ServeEngine(tcfg, TRCFG, model, **kw).run(
        [Request(uid=i, tokens=p, max_new_tokens=10) for i, p in enumerate(prompts)])
    jeng, jout, eng, out = _run_both(cfg, params, tcfg, model, prompts, 10,
                                     speculative_k=4, **kw)
    for i in base:
        assert out[i].tokens == base[i].tokens, f"request {i} diverged from sequential"
        assert out[i].tokens == jout[i].tokens, f"request {i} diverged from JAX"
    st, jst = eng.stats(), jeng.stats()
    assert {c: st[c] for c in COUNTERS} == {c: jst[c] for c in COUNTERS}
    assert st["spec_verify_calls"] > 0 and st["spec_tokens_drafted"] > 0
    assert st["nonfinite_logits"] == 0


def test_speculative_replay_accepts_from_donor():
    """A replayed prompt drafts from the retired donor's stream: well above
    the cold acceptance, the sequential tokens, and JAX's counts."""
    cfg, params, tcfg, model = _setup()
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab_size, size=10 + i).tolist() for i in range(4)]
    kw = dict(max_slots=4, max_len=64, decode_block=3, cache_layout="paged", page_size=8)
    mk = lambda R, off: [R(uid=off + i, tokens=p, max_new_tokens=8)
                         for i, p in enumerate(prompts)]
    base = ServeEngine(tcfg, TRCFG, model, **kw).run(mk(Request, 0))
    eng = ServeEngine(tcfg, TRCFG, model, prefix_share=True, speculative_k=4, **kw)
    jeng = JaxServeEngine(cfg, RCFG, params, prefix_share=True, speculative_k=4, **kw)
    r1 = eng.run(mk(Request, 0))
    jeng.run(mk(JaxRequest, 0))
    d0, a0 = eng.spec_tokens_drafted, eng.spec_tokens_accepted
    r2 = eng.run(mk(Request, 100))
    jeng.run(mk(JaxRequest, 100))
    for i in range(4):
        assert r1[i].tokens == base[i].tokens
        assert r2[100 + i].tokens == base[i].tokens, f"replay {i} diverged"
    replay = (eng.spec_tokens_accepted - a0) / max(1, eng.spec_tokens_drafted - d0)
    assert replay > 0.7 and replay > a0 / max(1, d0)
    assert {c: eng.stats()[c] for c in COUNTERS} == {c: jeng.stats()[c] for c in COUNTERS}


def test_speculative_falls_back_when_batch_samples():
    cfg, params, tcfg, model = _setup()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, cfg.vocab_size, size=7 + i).tolist() for i in range(2)]
    mk = lambda: [Request(uid=i, tokens=p, max_new_tokens=6, sampling=SamplingParams(
                      temperature=0.8 if i == 1 else 0.0, top_k=8 if i == 1 else 0,
                      seed=11 + i)) for i, p in enumerate(prompts)]
    kw = dict(max_slots=2, max_len=48, decode_block=3, cache_layout="paged", page_size=8)
    base = ServeEngine(tcfg, TRCFG, model, **kw).run(mk())
    eng = ServeEngine(tcfg, TRCFG, model, speculative_k=4, **kw)
    out = eng.run(mk())
    assert all(out[i].tokens == base[i].tokens for i in base)
    assert eng.stats()["spec_verify_calls"] == 0


# ---------------------------------------------------------------------------
# gating
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kwargs,match", [
    ("internlm2-1.8b_smoke", {"prefix_share": True}, "cache_layout='paged'"),
    ("internlm2-1.8b_smoke", {"speculative_k": 2}, "cache_layout='paged'"),
    ("h2o-danube-3-4b_smoke", {"prefix_share": True, "cache_layout": "paged"},
     "append-only"),
    ("h2o-danube-3-4b_smoke", {"speculative_k": 2, "cache_layout": "paged"}, "swa"),
    ("internlm2-1.8b_smoke", {"speculative_k": -1}, ">= 0"),
])
def test_gating_errors_match_jax(arch, kwargs, match):
    """The port refuses what the JAX engine refuses, with a ValueError of
    the same meaning."""
    cfg = get_config(arch)
    params, _ = init_model(cfg, RCFG, jax.random.key(0))
    tcfg = torch_get_config(arch)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    kw = dict(max_slots=2, max_len=32, page_size=8, **kwargs)
    with pytest.raises(ValueError, match=match):
        JaxServeEngine(cfg, RCFG, params, **kw)
    with pytest.raises(ValueError, match=match):
        ServeEngine(tcfg, TRCFG, model, **kw)
