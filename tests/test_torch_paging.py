"""The port's paged serving against the JAX package, on the CPU.

* K7's plain version (``flash_paged_decode_ref``) against the JAX Pallas
  kernel ``flash_paged_decode_kernel`` in interpret mode and against the
  JAX oracle, with shuffled page ids, an unmapped page in the middle of a
  table, a ring whose positions wrap, and Lq up to 5 (the speculative
  verify shape). Tolerances: f32 atol 1e-5 (the same math summed in
  another order), bf16 atol 2e-2 (both round the output to bf16; one ulp
  of an output below 4 is at most 2^-6). Only rows that see at least one
  key are compared: on a fully masked row the kernels average V over the
  mapped pages and the plain versions over every gathered page (both
  finite, and the engine discards such a row), so those rows are only
  required to be finite.
* ``paged_insert`` against the JAX one, leaf for leaf.
* The page allocator's invariants.
* The paged engine: tokens equal to the dense engine and to solo runs,
  greedy streams equal to the JAX paged engine's (a stream may diverge
  only at a near tie, JAX top-2 logit margin < 1e-4), churn through a
  small pool with no page leaked, admission waiting for pages, and the
  ``submit`` rejection naming the pool and the deficit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, get_config
from repro.core.plan import cache_plan_from_spec as jax_cache_plan
from repro.kernels.flash_decode import flash_paged_decode_kernel
from repro.kernels.flash_decode import flash_paged_decode_ref as jax_paged_ref
from repro.models import decode_step as jax_decode_step
from repro.models import forward, init_model
from repro.models import init_caches as jax_init_caches
from repro.models.attention import init_paged_kv_cache as jax_init_paged
from repro.models.attention import paged_insert as jax_paged_insert
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import RunConfig as TorchRunConfig
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.plan import cache_plan_from_spec as t_cache_plan
from repro_torch.kernels import flash_decode, launches, ops
from repro_torch.kernels.flash_decode import flash_paged_decode_ref
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import init_caches as t_init_caches
from repro_torch.models import init_model as t_init_model
from repro_torch.models.attention import init_paged_kv_cache, paged_insert
from repro_torch.serve import (PageAllocator, PoolSpec, Request, SamplingParams,
                               ServeEngine)

RCFG = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
TRCFG = TorchRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfgs(name):
    """(JAX config, port config); ``mqa`` is internlm2's smoke sibling with
    one KV head, built as tests/test_paging.py builds it."""
    if name == "mqa":
        base = "internlm2-1.8b_smoke"
        return (dataclasses.replace(get_config(base), name="mqa_smoke", n_kv_heads=1),
                dataclasses.replace(torch_get_config(base), name="mqa_smoke", n_kv_heads=1))
    return get_config(name), torch_get_config(name)


def _models(name):
    cfg, tcfg = _cfgs(name)
    params, _ = init_model(cfg, RCFG, jax.random.key(0))
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


def _drained(engine):
    for alloc in engine.allocators:
        alloc.check_invariant()
        assert alloc.free_pages == alloc.spec.n_pages, "pages leaked"


# ---------------------------------------------------------------------------
# K7: plain version against the JAX kernel (interpret) and oracle
# ---------------------------------------------------------------------------
def _paging(rng, B, nb, ps, KV, dh, fill, *, hole: bool = False, ring: int = 0):
    """Random pool with each row's pages at shuffled ids; ``fill[b]``
    tokens per row (positions 0..fill-1, or the last ``ring`` of them
    wrapped into a ring of nb*ps slots); ``hole`` unmaps one middle block
    of row 0. Stale rows of unused pages carry random positions."""
    n_pages = B * nb + 3
    k = rng.standard_normal((n_pages, ps, KV, dh)).astype(np.float32)
    v = rng.standard_normal((n_pages, ps, KV, dh)).astype(np.float32)
    ppos = rng.integers(0, nb * ps, size=(n_pages, ps)).astype(np.int32)
    bt = np.full((B, nb), -1, np.int32)
    free = list(rng.permutation(n_pages))
    logical = nb * ps
    for b in range(B):
        n = int(fill[b])
        for j in range(min(nb, -(-n // ps)) if not ring else nb):
            p = int(free.pop())
            bt[b, j] = p
            slots = np.arange(j * ps, (j + 1) * ps)
            if ring:
                last = n - 1 - ((n - 1 - slots) % logical)
                ppos[p] = np.where(last >= 0, last, -1)
            else:
                ppos[p] = np.where(slots < n, slots, -1)
    if hole and nb > 2:
        bt[0, 1] = -1
    return k, v, ppos, bt


PAGED_CASES = [
    # B, nb, ps, H, KV, dh, Lq, window, hole, ring
    (2, 4, 16, 4, 2, 64, 1, 0, False, 0),     # GQA (test_paging.py shapes)
    (1, 12, 8, 4, 1, 32, 1, 0, True, 0),      # MQA, a hole
    (2, 4, 8, 8, 2, 80, 1, 0, False, 0),      # head dim 80
    (1, 2, 8, 2, 2, 128, 1, 8, False, 40),    # ring of 16, window 8, wrapped
    (2, 4, 12, 4, 2, 64, 1, 0, True, 0),      # page size 12, a hole
    (2, 4, 16, 4, 2, 64, 4, 0, False, 0),     # verify rows (test_cow_spec.py)
    (1, 12, 8, 4, 1, 32, 5, 0, True, 0),      # Lq 5, MQA, a hole
    (2, 4, 8, 8, 2, 120, 2, 0, False, 0),     # head dim 120, Lq 2
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nb,ps,H,KV,dh,Lq,window,hole,ring", PAGED_CASES)
def test_k7_plain_matches_jax_kernel_and_ref(B, nb, ps, H, KV, dh, Lq, window, hole,
                                             ring, dtype):
    rng = np.random.default_rng(nb * ps + dh + Lq)
    S = nb * ps
    fill = np.array([S - 3, S // 2, S][:B]) if not ring else np.full(B, ring)
    k, v, ppos, bt = _paging(rng, B, nb, ps, KV, dh, fill, hole=hole, ring=ring)
    q = rng.standard_normal((B, Lq, H, dh)).astype(np.float32)
    qpos = (fill[:, None] - Lq + np.arange(Lq)[None]).astype(np.int32)
    qpos[-1, 0] = -1 if B > 1 else qpos[-1, 0]          # a parked row
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = (jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
             jnp.asarray(qpos), jnp.asarray(bt), jnp.asarray(ppos))
    o_kern = np.asarray(flash_paged_decode_kernel(*jargs, causal=True, window=window,
                                                  interpret=True), np.float32)
    o_jref = np.asarray(jax_paged_ref(*jargs, causal=True, window=window), np.float32)
    o = flash_paged_decode_ref(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
                               torch.from_numpy(v).to(td), torch.from_numpy(qpos),
                               torch.from_numpy(bt), torch.from_numpy(ppos),
                               causal=True, window=window).float().numpy()
    assert np.isfinite(o).all()
    # rows that see a key: a mapped page row at a position the query may see
    spos = np.where(bt[..., None] >= 0, ppos[np.maximum(bt, 0)], -1).reshape(B, -1)
    qp = qpos[:, :, None]
    vis = (spos[:, None, :] >= 0) & (spos[:, None, :] <= qp)
    if window:
        vis &= qp - spos[:, None, :] < window
    seen = vis.any(-1)                                  # (B, Lq)
    assert seen.sum() >= B * Lq - 1
    for ref in (o_kern, o_jref):
        np.testing.assert_allclose(o[seen], ref[seen], atol=TOL[dtype])


def test_k7_dispatch_counts_and_scale_override():
    """``ops.flash_paged_decode`` on CPU tensors runs the plain version and
    counts it; ``scale`` overrides dh^-1/2 as the JAX oracle does."""
    rng = np.random.default_rng(3)
    k, v, ppos, bt = _paging(rng, 2, 3, 8, 2, 16, np.array([20, 9]))
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    qpos = np.array([19, 8], np.int32)
    launches.reset()
    t = [torch.from_numpy(a) for a in (q, k, v, qpos, bt, ppos)]
    o = ops.flash_paged_decode(*t, scale=0.3)
    assert launches.counts() == {"flash_paged_decode_ref": 1}
    want = jax_paged_ref(*(jnp.asarray(a) for a in (q, k, v, qpos, bt, ppos)), scale=0.3)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("B,KV,nb,want", [
    (8, 8, 18, (5, 4)),      # the serving shape: 320 blocks on 132 SMs
    (1, 8, 18, (18, 1)),     # few slots: a page a split
    (12, 8, 18, (3, 6)),
    (33, 8, 18, (1, 18)),    # enough blocks already: one split
    (2, 2, 7, (7, 1)),
])
def test_k7_split_count_comes_from_the_shapes(monkeypatch, B, KV, nb, want):
    """K7's split count from (B, KV, nb, SMs) alone: two blocks per SM on
    a 132-SM card, at most one split per table entry, every entry in one
    split."""
    monkeypatch.setattr(flash_decode, "_sm_count", lambda index: 132)
    nsplit, per = flash_decode._splits(B, KV, nb, torch.device("cpu"))
    assert (nsplit, per) == want
    assert (nsplit - 1) * per < nb <= nsplit * per


# ---------------------------------------------------------------------------
# paged_insert, leaf for leaf
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ring", [False, True])
def test_paged_insert_matches_jax(ring):
    """A decode step (a parked row, positions past the table) and a
    verify block of L = 3 land the same pages, rows and positions in both
    packages; a ring wraps its positions."""
    B, S, KV, dh, ps = 3, 32, 2, 16, 8
    nb = S // ps
    rng = np.random.default_rng(2)
    bt = rng.permutation(B * nb + 2)[:B * nb].reshape(B, nb).astype(np.int32)
    bt[1, 3] = -1                                           # an unmapped block
    jc = jax_init_paged(B, S, ps, B * nb + 2, KV, dh, jnp.float32, ring)
    jc = jc._replace(block_table=jnp.asarray(bt))
    tc = init_paged_kv_cache(B, S, ps, B * nb + 2, KV, dh, torch.float32, ring, "cpu")
    tc.block_table.copy_(torch.from_numpy(bt))
    for L, pos in ((1, [[5], [-1], [17]]), (3, [[6, 7, 8], [26, 27, 28], [30, 31, 32]]),
                   (1, [[40], [2], [33]])):
        pos = np.asarray(pos, np.int32)
        kn = rng.standard_normal((B, L, KV, dh)).astype(np.float32)
        vn = rng.standard_normal((B, L, KV, dh)).astype(np.float32)
        jc = jax_paged_insert(jc, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos))
        paged_insert(tc, torch.from_numpy(kn), torch.from_numpy(vn), torch.from_numpy(pos))
        for name in ("k_pages", "v_pages", "page_pos", "block_table"):
            np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                          np.asarray(getattr(jc, name)), err_msg=name)


@pytest.mark.parametrize("spec", ["", "int8"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b_smoke", "h2o-danube-3-4b_smoke"])
def test_decode_step_with_distinct_layer_tables_matches_jax(arch, spec):
    """Every layer of a stacked node gets its own shuffled block table
    (the engine writes one row into all of them; this does not): decode
    steps and a verify block of L = 3 insert through each layer's own
    table in both packages, so the logits of every step (f32, atol 1e-4)
    and every pool leaf agree."""
    cfg, params, tcfg, model = _models(arch)
    B, max_len, ps = 2, 32, 8
    jfull = jax_init_caches(cfg, RCFG, B, max_len, layout="paged", page_size=ps,
                            cache_plan=jax_cache_plan(spec).resolve(cfg))
    tfull = t_init_caches(tcfg, TRCFG, B, max_len, "cpu", layout="paged", page_size=ps,
                          cache_plan=t_cache_plan(spec).resolve(tcfg))
    rng = np.random.default_rng(7)
    tables = []
    for jst, tst in zip(jfull, tfull):
        tables.append([])
        for jn, tn in zip(jst, tst):
            layers, _, nb = tn.block_table.shape
            n_pages = tn.page_pos.shape[1]
            perm = rng.permutation(n_pages)
            bt = np.stack([np.roll(perm, r)[:B * nb].reshape(B, nb)
                           for r in range(layers)]).astype(np.int32)
            assert (bt[0] != bt[1:]).any(), "tables must differ across layers"
            tn.block_table.copy_(torch.from_numpy(bt))
            tables[-1].append(jn._replace(block_table=jnp.asarray(bt)))
    jfull = tables
    steps = [[[i], [i - 2 if i >= 2 else -1]] for i in range(6)]
    steps.append([[6, 7, 8], [4, 5, 6]])                     # a verify block
    for pos in steps:
        pos = np.asarray(pos, np.int32)
        toks = rng.integers(0, cfg.vocab_size, size=pos.shape).astype(np.int32)
        jl, jfull = jax_decode_step(cfg, RCFG, params, jnp.asarray(toks), jnp.asarray(pos),
                                    jfull)
        tl, tfull = t_decode_step(tcfg, TRCFG, model, torch.from_numpy(toks).long(),
                                  torch.from_numpy(pos), tfull)
        live = pos >= 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], atol=1e-4)
    for jst, tst in zip(jfull, tfull):
        for jn, tn in zip(jst, tst):
            for f in tn.LEAVES:
                a, b = getattr(tn, f).numpy(), np.asarray(getattr(jn, f))
                if a.dtype == np.float32:
                    np.testing.assert_allclose(a, b, atol=1e-5, err_msg=f)
                else:
                    np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# the allocator
# ---------------------------------------------------------------------------
def test_allocator_alloc_release_append_invariant():
    spec = PoolSpec(page_size=8, n_pages=6, blocks_per_slot=4, ring=False, token_bytes=4)
    a = PageAllocator(spec)
    assert a.blocks_for(1) == 1 and a.blocks_for(8) == 1
    assert a.blocks_for(9) == 2 and a.blocks_for(32) == 4
    with pytest.raises(ValueError, match="non-ring slot table holds"):
        a.blocks_for(33)
    ring = PageAllocator(dataclasses.replace(spec, ring=True))
    assert ring.blocks_for(33) == 4 and ring.blocks_for(10_000) == 4
    row0 = a.allocate(0, 3)
    assert (row0 >= 0).sum() == 3 and a.free_pages == 3
    with pytest.raises(RuntimeError, match="already owns"):
        a.allocate(0, 1)
    a.allocate(1, 3)
    assert not a.can_allocate(1)
    with pytest.raises(RuntimeError, match="exhausted"):
        a.allocate(2, 1)
    a.check_invariant()
    assert a.release(0) == 3 and a.free_pages == 3
    assert (a.append(1, 1) >= 0).sum() == 4
    with pytest.raises(RuntimeError, match="table full"):
        a.append(1, 1)
    a.check_invariant()
    assert a.release(1) == 4 and a.free_pages == 6 and a.release(1) == 0
    assert a.reserved_bytes == 0 and a.used_tokens(1000) == spec.logical_size


def test_allocator_shared_pages_are_refcounted():
    """Adopted pages bump a refcount instead of the free list; a retained
    owner keeps them live after the slot releases; the invariant holds
    throughout and every page returns at the end."""
    a = PageAllocator(PoolSpec(page_size=4, n_pages=8, blocks_per_slot=4, ring=False,
                               token_bytes=2))
    row0 = a.allocate(0, 3)
    row1 = a.allocate(1, 4, shared=row0[:2])
    assert list(row1[:2]) == list(row0[:2]) and a.free_pages == 3
    assert a.shared_pages == 2 and a.page_ref(int(row0[0])) == 2
    a.retain(("prefix", 0), row0[:2])
    assert a.page_ref(int(row0[0])) == 3
    a.check_invariant()
    assert a.release(0) == 1                     # only its unshared third page
    assert a.release(1) == 2                     # its two fresh pages
    a.check_invariant()
    assert a.free_pages == 6 and a.page_ref(int(row0[1])) == 1
    assert a.release(("prefix", 0)) == 2 and a.free_pages == 8
    with pytest.raises(RuntimeError, match="not live"):
        a.allocate(2, 2, shared=[int(row0[0])])
    a.check_invariant()


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------
def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lengths]


@pytest.mark.parametrize("arch", ["internlm2-1.8b_smoke", "mqa", "h2o-danube-3-4b_smoke",
                                  "qwen3-32b_smoke"])
def test_paged_engine_matches_dense_and_jax_paged_engine(arch):
    """Same requests and parameters: the port's paged engine gives the
    port's dense engine's tokens (greedy and sampled), and its greedy
    streams equal the JAX paged engine's up to a near tie."""
    cfg, params, tcfg, model = _models(arch)
    prompts = _prompts(cfg, [12, 7, 9], seed=3)
    sampled = lambda i: SamplingParams(temperature=0.7 if i == 1 else 0.0,
                                       top_k=8 if i == 1 else 0, seed=40 + i)
    reqs = lambda: [Request(uid=i, tokens=prompts[i], max_new_tokens=6 + 2 * i,
                            sampling=sampled(i)) for i in range(3)]
    dense = ServeEngine(tcfg, TRCFG, model, max_slots=2, max_len=48, decode_block=4)
    out_d = dense.run(reqs())
    paged = ServeEngine(tcfg, TRCFG, model, max_slots=2, max_len=48, decode_block=4,
                        cache_layout="paged", page_size=8)
    out_p = paged.run(reqs())
    assert paged.allocators
    for i in range(3):
        assert out_p[i].tokens == out_d[i].tokens, f"request {i} diverged"
    _drained(paged)
    greedy = [0, 2]
    jeng = JaxServeEngine(cfg, RCFG, params, max_slots=2, max_len=48, decode_block=4,
                          cache_layout="paged", page_size=8)
    jout = jeng.run([JaxRequest(uid=i, tokens=prompts[i], max_new_tokens=6 + 2 * i)
                     for i in greedy])
    for i in greedy:
        _same_or_near_tie(cfg, params, prompts[i], jout[i].tokens, out_p[i].tokens)


def _same_or_near_tie(cfg, params, prompt, want, got):
    assert len(got) == len(want)
    diff = [t for t in range(len(want)) if want[t] != got[t]]
    if diff:
        t = diff[0]
        seq = prompt + want[:t]
        batch = {"tokens": jnp.asarray(seq, jnp.int32)[None],
                 "labels": jnp.zeros((1, len(seq)), jnp.int32)}
        h, _ = forward(cfg, RCFG, None, params, batch, jax.random.key(2))
        row = np.asarray(h[0, -1] @ params["head"], np.float32)[: cfg.vocab_size]
        top2 = np.sort(row)[-2:]
        assert top2[1] - top2[0] < 1e-4, (
            f"diverged at token {t} with JAX margin {top2[1] - top2[0]:.3e}")


def test_paged_engine_matches_solo_runs():
    """Continuous batching through a paged cache: each request's tokens
    (greedy and sampled) equal its run alone."""
    tcfg = torch_get_config("internlm2-1.8b_smoke")
    model = t_init_model(tcfg, TRCFG, seed=0, device="cpu")
    prompts = _prompts(tcfg, [8, 11, 6, 14], seed=5)
    reqs = [Request(uid=i, tokens=prompts[i], max_new_tokens=4 + 3 * i,
                    sampling=SamplingParams(temperature=0.8 if i % 2 else 0.0,
                                            top_k=8 if i % 2 else 0, seed=100 + i))
            for i in range(4)]
    kw = dict(max_len=64, decode_block=3, cache_layout="paged", page_size=8)
    eng = ServeEngine(tcfg, TRCFG, model, max_slots=2, **kw)
    batched = eng.run(reqs)
    for i, req in enumerate(reqs):
        solo = ServeEngine(tcfg, TRCFG, model, max_slots=1, **kw).run([req])[i]
        assert solo.tokens == batched[i].tokens, f"request {i} diverged"
    _drained(eng)


def test_paged_churn_reuses_pages_and_never_leaks():
    """Admit / evict / readmit through a pool of 6 pages (the dense worst
    case is 24): every page cycles through owners, the invariant holds
    after every step, and the tokens equal the dense engine's."""
    tcfg = torch_get_config("internlm2-1.8b_smoke")
    model = t_init_model(tcfg, TRCFG, seed=0, device="cpu")
    prompts = _prompts(tcfg, [6, 9, 7, 10, 6, 8, 11, 6, 9, 7], seed=6)
    mk = lambda: [Request(uid=i, tokens=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    out_d = ServeEngine(tcfg, TRCFG, model, max_slots=3, max_len=64,
                        decode_block=3).run(mk())
    eng = ServeEngine(tcfg, TRCFG, model, max_slots=3, max_len=64, decode_block=3,
                      cache_layout="paged", page_size=8, pool_tokens=48)
    for r in mk():
        eng.submit(r)
    done = {}
    while eng.has_work:
        for out in eng.step():
            done[out.uid] = out
        for alloc in eng.allocators:
            alloc.check_invariant()
    for i in range(len(prompts)):
        assert done[i].tokens == out_d[i].tokens, f"request {i} diverged"
    _drained(eng)
    for alloc in eng.allocators:
        assert alloc.total_page_allocations > alloc.spec.n_pages


def test_paged_admission_waits_for_pages_and_submit_rejects():
    """Pages for one request in flight: requests run one at a time and all
    finish with the dense tokens; a request larger than the pool is
    rejected at submit, naming the pool, its size and the deficit."""
    tcfg = torch_get_config("internlm2-1.8b_smoke")
    model = t_init_model(tcfg, TRCFG, seed=0, device="cpu")
    prompts = _prompts(tcfg, [10, 9, 8], seed=7)
    mk = lambda: [Request(uid=i, tokens=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    out_d = ServeEngine(tcfg, TRCFG, model, max_slots=3, max_len=64,
                        decode_block=4).run(mk())
    eng = ServeEngine(tcfg, TRCFG, model, max_slots=3, max_len=64, decode_block=4,
                      cache_layout="paged", page_size=8, pool_tokens=16)
    assert eng.pool_load() == 0.0
    out_p = eng.run(mk())
    assert all(out_p[i].tokens == out_d[i].tokens for i in range(3))
    assert eng.peak_active == 1, "a pool for one request admitted several"
    _drained(eng)
    with pytest.raises(ValueError) as ei:
        eng.submit(Request(uid=7, tokens=list(range(30)), max_new_tokens=20))
    msg = str(ei.value)
    for part in ("request 7", "50 tokens", "stage0.attn", "2 pages (16 tokens)",
                 "34 tokens over capacity", "raise pool_tokens"):
        assert part in msg, (part, msg)


def test_paged_stats_and_refusals():
    """Telemetry of a paged run (reserved against used bytes, pages) and
    the layout errors."""
    tcfg = torch_get_config("internlm2-1.8b_smoke")
    model = t_init_model(tcfg, TRCFG, seed=0, device="cpu")
    eng = ServeEngine(tcfg, TRCFG, model, max_slots=2, max_len=64, decode_block=2,
                      cache_layout="paged", page_size=8)
    eng.submit(Request(uid=0, tokens=list(range(2, 12)), max_new_tokens=6))
    eng.step()
    st = eng.stats()
    [alloc] = eng.allocators
    assert st["cache/kv_pages_total"] == alloc.spec.n_pages == 16
    assert st["cache/kv_pages_free"] == 14           # 16 tokens -> 2 pages
    assert st["cache/kv_reserved_mb"] * 2**20 == 2 * 8 * alloc.spec.token_bytes
    assert 0 < st["cache/kv_used_mb"] <= st["cache/kv_reserved_mb"]
    assert st["cache_pools"]["stage0.attn"] == {
        "format": "float32", "token_bytes": alloc.spec.token_bytes, "pages": 16}
    with pytest.raises(ValueError, match="cache_layout"):
        ServeEngine(tcfg, TRCFG, model, max_slots=1, max_len=16, pool_tokens=16)
    with pytest.raises(ValueError, match="dense\\|paged"):
        ServeEngine(tcfg, TRCFG, model, max_slots=1, max_len=16, cache_layout="ring")
