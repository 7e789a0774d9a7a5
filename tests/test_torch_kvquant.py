"""The port's quantised and low-rank paged pools against the JAX package,
on the CPU.

* ``quantize_kv`` / ``dequantize_kv`` / ``pack_int4`` / ``unpack_int4``
  bit for bit against JAX, ``unpack_int4`` on all 256 byte values (the
  int8 shifts ``(b << 4) >> 4`` and ``b >> 4``).
* K8's plain version (``flash_paged_decode_quant_ref``) against the JAX
  Pallas kernel in interpret mode and its oracle (the shapes of
  tests/test_kvquant.py, plus verify rows and an unmapped page): f32 atol
  1e-5, bf16 2e-2; rows that see no key only finite (see
  tests/test_torch_paging.py).
* ``paged_insert_quant`` and the engine's int8 / int4 / svd splice, leaf
  for leaf.
* One spliced decode step per format: the port's logits against JAX's
  for the same format (atol 1e-4: f32 math in another order, and the same
  quantiser), and against fp paged within the per-format bounds of
  tests/test_kvquant.py::test_compressed_decode_logits_within_tolerance.
  int8 is held to fp by these logit bounds, not by token identity: on
  random weights a token can flip at a near tie (ROADMAP Queue 3).
* Pool page counts by compression ratio, equal to the JAX engine's; the
  cap at the dense worst case.
* svd: at r = dh the tokens equal fp paged; the projectors B B^T equal
  JAX's (eigenvectors may differ in sign, the projector may not).
* Engines: greedy streams of int8 / int4 / svd engines equal the JAX
  engines' of the same format, and int8 churn is batched == solo with no
  page leaked.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, get_config
from repro.core.plan import cache_plan_from_spec
from repro.kernels import flash_decode as jfd
from repro.models import decode_step, init_caches, init_model, prefill
from repro.models.attention import init_quant_paged_kv_cache as jax_init_quant
from repro.models.attention import paged_insert_quant as jax_insert_quant
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import cache as jax_cache
from repro_torch import bridge
from repro_torch.configs import RunConfig as TorchRunConfig
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.plan import cache_plan_from_spec as t_cache_plan
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import launches, ops
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import init_caches as t_init_caches
from repro_torch.models import prefill as t_prefill
from repro_torch.models.attention import (SVDPagedKVCache, init_quant_paged_kv_cache,
                                          paged_insert_quant)
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import cache as t_cache

RCFG = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
TRCFG = TorchRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _models(arch):
    cfg = get_config(arch)
    params, _ = init_model(cfg, RCFG, jax.random.key(0))
    tcfg = torch_get_config(arch)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


def _drained(engine):
    for alloc in engine.allocators:
        alloc.check_invariant()
        assert alloc.free_pages == alloc.spec.n_pages, "pages leaked"


# ---------------------------------------------------------------------------
# quantisation helpers, bit for bit
# ---------------------------------------------------------------------------
def test_unpack_int4_all_bytes_and_pack_match_jax():
    every = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    np.testing.assert_array_equal(tfd.unpack_int4(torch.from_numpy(every)).numpy(),
                                  np.asarray(jfd.unpack_int4(jnp.asarray(every))))
    vals = np.random.default_rng(0).integers(-7, 8, size=(5, 3, 32)).astype(np.int8)
    packed = tfd.pack_int4(torch.from_numpy(vals))
    assert packed.dtype == torch.int8 and packed.shape == (5, 3, 16)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jfd.pack_int4(jnp.asarray(vals))))
    np.testing.assert_array_equal(tfd.unpack_int4(packed).numpy(), vals)


@pytest.mark.parametrize("bits,ngr", [(8, 1), (8, 4), (4, 1), (4, 2), (4, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_dequantize_bit_exact(bits, ngr, dtype):
    rng = np.random.default_rng(bits * 10 + ngr)
    x = (rng.standard_normal((3, 7, 2, 32)) * 3.0).astype(np.float32)
    x[0, 0, 0] = 0.0                                   # an all-zero row: the 1e-12 floor
    x[1, 1, 1, :4] = [0.5, -0.5, 1.5, 2.5]             # exact halves after scaling
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qj, sj = jfd.quantize_kv(xj, bits, ngr)
    qt, st = tfd.quantize_kv(xt, bits, ngr)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(tfd.dequantize_kv(qt, st, 32).numpy(),
                                  np.asarray(jfd.dequantize_kv(qj, sj, 32)))


# ---------------------------------------------------------------------------
# K8: plain version against the JAX kernel (interpret) and oracle
# ---------------------------------------------------------------------------
QUANT_CASES = [
    # B, S, H, KV, dh, ps, window, bits, ngr, Lq, hole, dtype
    (2, 64, 4, 2, 64, 16, 0, 8, 1, 1, False, "float32"),   # GQA int8, per token
    (1, 96, 4, 1, 32, 8, 0, 8, 4, 1, True, "float32"),     # MQA int8 grouped, hole
    (2, 32, 8, 2, 80, 8, 0, 8, 5, 1, False, "float32"),    # head dim 80, 5 groups
    (1, 16, 2, 2, 128, 8, 8, 4, 8, 1, False, "float32"),   # window, int4 grouped
    (2, 48, 4, 2, 64, 12, 0, 4, 1, 1, False, "float32"),   # int4 per token, ps 12
    (2, 64, 4, 2, 64, 16, 0, 4, 4, 5, True, "float32"),    # verify rows, int4, hole
    (2, 64, 4, 2, 128, 16, 0, 8, 1, 3, False, "bfloat16"),  # bf16 q, int8
]


@pytest.mark.parametrize("B,S,H,KV,dh,ps,window,bits,ngr,Lq,hole,dtype", QUANT_CASES)
def test_k8_plain_matches_jax_kernel_and_ref(B, S, H, KV, dh, ps, window, bits, ngr, Lq,
                                             hole, dtype):
    rng = np.random.default_rng(21 + dh + Lq)
    nb = S // ps
    n_pages = B * nb + 2
    dhq = dh if bits == 8 else dh // 2
    kp = rng.integers(-7, 8, size=(n_pages, ps, KV, dhq)).astype(np.int8)
    vp = rng.integers(-7, 8, size=(n_pages, ps, KV, dhq)).astype(np.int8)
    if bits == 8:
        kp = rng.integers(-127, 128, size=kp.shape).astype(np.int8)
    else:                                             # any byte is a valid nibble pair
        vp = rng.integers(-128, 128, size=vp.shape).astype(np.int8)
    ks = (rng.random((n_pages, ps, KV, ngr)) * 0.05).astype(np.float32)
    vs = (rng.random((n_pages, ps, KV, ngr)) * 0.05).astype(np.float32)
    fill = np.array([S - 3, S // 2][:B])
    bt = rng.permutation(n_pages)[:B * nb].reshape(B, nb).astype(np.int32)
    j = np.arange(S).reshape(nb, ps)
    ppos = rng.integers(0, S, size=(n_pages, ps)).astype(np.int32)
    for b in range(B):
        ppos[bt[b]] = np.where(j < fill[b], j, -1)
    if hole:
        bt[0, 1] = -1
    q = rng.standard_normal((B, Lq, H, dh)).astype(np.float32)
    qpos = (fill[:, None] - Lq + np.arange(Lq)[None]).astype(np.int32)
    jd = getattr(jnp, dtype)
    jargs = (jnp.asarray(q, jd), *(jnp.asarray(a) for a in (kp, vp, ks, vs, qpos, bt, ppos)))
    o_kern = np.asarray(jfd.flash_paged_decode_quant_kernel(
        *jargs, causal=True, window=window, interpret=True), np.float32)
    o_jref = np.asarray(jfd.flash_paged_decode_quant_ref(*jargs, causal=True, window=window),
                        np.float32)
    launches.reset()
    targs = (torch.from_numpy(q).to(getattr(torch, dtype)),
             *(torch.from_numpy(a) for a in (kp, vp, ks, vs, qpos, bt, ppos)))
    o = ops.flash_paged_decode_quant(*targs, causal=True, window=window).float().numpy()
    assert launches.counts() == {"flash_paged_decode_quant_ref": 1}
    assert np.isfinite(o).all()
    for ref in (o_kern, o_jref):
        np.testing.assert_allclose(o, ref, atol=TOL[dtype])


# ---------------------------------------------------------------------------
# quantise-on-insert and the splices, leaf for leaf
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits,ngr", [(8, 1), (8, 2), (4, 1), (4, 2)])
def test_paged_insert_quant_matches_jax(bits, ngr):
    B, S, KV, dh, ps = 3, 32, 2, 16, 8
    nb = S // ps
    rng = np.random.default_rng(22)
    bt = rng.permutation(B * nb).reshape(B, nb).astype(np.int32)
    jc = jax_init_quant(B, S, ps, B * nb, KV, dh, bits, ngr, False)._replace(
        block_table=jnp.asarray(bt))
    tc = init_quant_paged_kv_cache(B, S, ps, B * nb, KV, dh, bits, ngr, False, "cpu")
    tc.block_table.copy_(torch.from_numpy(bt))
    for pos in ([[5], [-1], [17]], [[6, 7], [0, 1], [40, 18]]):
        pos = np.asarray(pos, np.int32)
        kn = rng.standard_normal((B, pos.shape[1], KV, dh)).astype(np.float32)
        vn = rng.standard_normal((B, pos.shape[1], KV, dh)).astype(np.float32)
        jc = jax_insert_quant(jc, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos), dh)
        paged_insert_quant(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                           torch.from_numpy(pos), dh)
        for name in ("k_pages", "v_pages", "k_scale", "v_scale", "page_pos", "block_table"):
            np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                          np.asarray(getattr(jc, name)), err_msg=name)


def _torch_prefill_cache(pc):
    """A JAX batch-1 prefill cache tree as the port's (numpy in between)."""
    from repro_torch.models.attention import KVCache

    return [[KVCache(*(torch.from_numpy(np.array(getattr(n, f)))
                       for f in ("k", "v", "slot_pos")), ring=bool(np.asarray(n.ring)[0]))
             for n in stage] for stage in pc]


@pytest.mark.parametrize("spec", ["int8", "int4(group=8)", "svd(r=1/2)", ""])
def test_splice_matches_jax_leaf_for_leaf(spec):
    """The same prefill cache spliced into slot 1 of a paged pool through
    shuffled pages, with a copy-on-write start of 8 tokens: every pool leaf
    equal to JAX's (svd: on the JAX bases, so the coefficients compare)."""
    cfg, params, tcfg, model = _models("internlm2-1.8b_smoke")
    lp = 13
    toks = jnp.arange(3, 3 + lp)[None]
    _, pc = prefill(cfg, RCFG, params, {"tokens": toks}, 48, None,
                    prompt_len=jnp.asarray([lp], jnp.int32))
    jfull = init_caches(cfg, RCFG, 2, 48, layout="paged", page_size=8,
                        cache_plan=cache_plan_from_spec(spec).resolve(cfg))
    jfull = jax_cache.install_svd_bases(jfull, params, cfg) if "svd" in spec else jfull
    tfull = t_init_caches(tcfg, TRCFG, 2, 48, "cpu", layout="paged", page_size=8,
                          cache_plan=t_cache_plan(spec).resolve(tcfg))
    for jn, tn in zip(jax_cache.kv_cache_nodes(jfull), t_cache.kv_cache_nodes(tfull)):
        for f in tn.LEAVES:                       # start from JAX's leaves (bases too)
            getattr(tn, f).copy_(torch.from_numpy(np.array(getattr(jn, f))))
    row = np.array([9, 2, 5, 11, 0, 7], np.int32)
    jfull = jax_cache.write_slot_paged(jfull, pc, [[jnp.asarray(row)]], jnp.int32(1),
                                       jnp.int32(lp), [[jnp.int32(8)]])
    t_cache.write_slot_paged(tfull, _torch_prefill_cache(pc), [[row]], 1, lp, [[8]])
    for jn, tn in zip(jax_cache.kv_cache_nodes(jfull), t_cache.kv_cache_nodes(tfull)):
        for f in tn.LEAVES:
            a, b = getattr(tn, f).numpy(), np.asarray(getattr(jn, f))
            if f.endswith("pages") and a.dtype == np.float32:
                np.testing.assert_allclose(a, b, atol=1e-6, err_msg=f)  # einsum order (svd)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# one spliced decode step per format
# ---------------------------------------------------------------------------
FORMAT_TOL = [("int8", 0.15), ("int4", 1.5), ("int4(group=8)", 1.0), ("svd(r=0.5)", 8.0),
              ("svd(r=1.0)", 1e-4)]


def _jax_spliced_logits(cfg, params, pc, lp, spec):
    full = init_caches(cfg, RCFG, 2, 48, layout="paged", page_size=8,
                       cache_plan=cache_plan_from_spec(spec).resolve(cfg))
    if "svd" in spec:
        full = jax_cache.install_svd_bases(full, params, cfg)
    rows = [[jnp.arange(n.block_table.shape[2], dtype=jnp.int32) for n in st] for st in full]
    full = jax_cache.write_slot_paged(full, pc, rows, jnp.int32(0), jnp.int32(lp))
    lg, _ = decode_step(cfg, RCFG, params, jnp.asarray([[5], [0]], jnp.int32),
                        jnp.asarray([[lp], [-1]], jnp.int32), full)
    return np.asarray(lg[0, 0, :cfg.vocab_size])


def _torch_spliced_logits(tcfg, model, pc, lp, spec):
    full = t_init_caches(tcfg, TRCFG, 2, 48, "cpu", layout="paged", page_size=8,
                         cache_plan=t_cache_plan(spec).resolve(tcfg))
    if "svd" in spec:
        t_cache.install_svd_bases(full, model, tcfg)
    rows = [[np.arange(n.block_table.shape[2], dtype=np.int32) for n in st] for st in full]
    t_cache.write_slot_paged(full, pc, rows, 0, lp)
    lg, _ = t_decode_step(tcfg, TRCFG, model, torch.tensor([[5], [0]]),
                          torch.tensor([[lp], [-1]], dtype=torch.int32), full)
    return lg[0, 0, :tcfg.vocab_size].numpy()


@pytest.mark.parametrize("arch", ["internlm2-1.8b_smoke", "h2o-danube-3-4b_smoke",
                                  "qwen3-32b_smoke"])
def test_compressed_decode_logits_match_jax_and_fp_bounds(arch):
    cfg, params, tcfg, model = _models(arch)
    lp = 8
    _, pc = prefill(cfg, RCFG, params, {"tokens": jnp.arange(2, 2 + lp)[None]}, 48, None,
                    prompt_len=jnp.asarray([lp], jnp.int32))
    _, tpc = t_prefill(tcfg, TRCFG, model, {"tokens": torch.arange(2, 2 + lp)[None]}, 48,
                       prompt_len=torch.tensor([lp]))
    fp = _torch_spliced_logits(tcfg, model, tpc, lp, "")
    np.testing.assert_allclose(fp, _jax_spliced_logits(cfg, params, pc, lp, ""), atol=1e-4)
    for spec, tol in FORMAT_TOL:
        got = _torch_spliced_logits(tcfg, model, tpc, lp, spec)
        np.testing.assert_allclose(got, _jax_spliced_logits(cfg, params, pc, lp, spec),
                                   atol=1e-4, err_msg=spec)
        err = float(np.abs(got - fp).max())
        assert err < tol, f"{arch} {spec}: logit err {err} >= {tol}"


# ---------------------------------------------------------------------------
# pools and byte accounting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec,ratio", [("int8", 3.2), ("int4", 16 / 3), ("svd(r=1/4)", 4.0)])
def test_pool_pages_grow_with_compression_ratio_as_in_jax(spec, ratio):
    cfg, params, tcfg, model = _models("internlm2-1.8b_smoke")
    kw = dict(max_slots=8, max_len=128, cache_layout="paged", page_size=8, pool_tokens=128)
    for s in ("", spec):
        teng = ServeEngine(tcfg, TRCFG, model, cache_compress=s, **kw)
        jeng = JaxServeEngine(cfg, RCFG, params, cache_compress=s, **kw)
        [ta], [ja] = teng.allocators, jeng.allocators
        assert dataclasses.astuple(ta.spec) == dataclasses.astuple(ja.spec)
        assert teng.kv_compression_x == pytest.approx(jeng.kv_compression_x)
        assert teng.stats()["cache_pools"] == jeng.stats()["cache_pools"]
    assert teng.kv_compression_x == pytest.approx(ratio)
    assert teng.cache_telemetry()["cache/kv_compression_x"] == pytest.approx(ratio)
    capped = ServeEngine(tcfg, TRCFG, model, max_slots=2, max_len=32, cache_layout="paged",
                         page_size=8, pool_tokens=10_000, cache_compress="int8")
    assert capped.allocators[0].spec.n_pages == 2 * (32 // 8)


def test_compressed_reserved_bytes_are_true_compressed_bytes():
    tcfg = torch_get_config("internlm2-1.8b_smoke")
    model = bridge.from_jax_params(jax.tree.map(np.asarray, init_model(
        get_config("internlm2-1.8b_smoke"), RCFG, jax.random.key(0))[0]), tcfg, device="cpu")
    kw = dict(max_slots=2, max_len=64, decode_block=2, cache_layout="paged", page_size=8)
    tel = {}
    for s in ("", "int8"):
        eng = ServeEngine(tcfg, TRCFG, model, cache_compress=s, **kw)
        eng.submit(Request(uid=0, tokens=list(range(2, 12)), max_new_tokens=6))
        eng.step()
        tel[s] = eng.cache_telemetry()
    assert tel["int8"]["cache/kv_reserved_mb"] == pytest.approx(
        tel[""]["cache/kv_reserved_mb"] / 3.2)
    assert 0 < tel["int8"]["cache/kv_used_mb"] < tel[""]["cache/kv_used_mb"]


# ---------------------------------------------------------------------------
# svd pools
# ---------------------------------------------------------------------------
def test_svd_full_rank_matches_fp_paged_and_projectors_match_jax():
    cfg, params, tcfg, model = _models("internlm2-1.8b_smoke")
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (9, 12, 7)]
    mk = lambda: [Request(uid=i, tokens=p, max_new_tokens=8) for i, p in enumerate(prompts)]
    kw = dict(max_slots=2, max_len=48, decode_block=4, cache_layout="paged", page_size=8)
    base = ServeEngine(tcfg, TRCFG, model, **kw).run(mk())
    svd = ServeEngine(tcfg, TRCFG, model, cache_compress="svd(r=1.0)", **kw)
    out = svd.run(mk())
    assert all(out[i].tokens == base[i].tokens for i in range(3))
    _drained(svd)
    teng = ServeEngine(tcfg, TRCFG, model, max_slots=1, max_len=32, cache_layout="paged",
                       page_size=8, cache_compress="svd(r=0.5)")
    jeng = JaxServeEngine(cfg, RCFG, params, max_slots=1, max_len=32, cache_layout="paged",
                          page_size=8, cache_compress="svd(r=0.5)")
    [tn] = [n for n in t_cache.kv_cache_nodes(teng.caches) if isinstance(n, SVDPagedKVCache)]
    [jn] = list(jax_cache.kv_cache_nodes(jeng.caches))
    assert tn.k_pages.shape[-1] == cfg.head_dim // 2
    for tb, jb in ((tn.k_basis, jn.k_basis), (tn.v_basis, jn.v_basis)):
        tb, jb = tb.numpy().astype(np.float64), np.asarray(jb, np.float64)
        eye = np.eye(tb.shape[-1])
        np.testing.assert_allclose(np.swapaxes(tb, -1, -2) @ tb, np.broadcast_to(
            eye, tb.shape[:-2] + eye.shape), atol=1e-5)
        np.testing.assert_allclose(tb @ np.swapaxes(tb, -1, -2),
                                   jb @ np.swapaxes(jb, -1, -2), atol=1e-5)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["int8", "int4", "svd(r=1/2)"])
def test_compressed_engine_greedy_streams_match_jax(spec):
    """The port's compressed engine against the JAX engine of the same
    format on the same requests (the deterministic scenario of
    tests/test_kvquant.py's int8 parity test): identical greedy tokens."""
    cfg, params, tcfg, model = _models("internlm2-1.8b_smoke")
    prompts = [list(range(5, 13 + i)) for i in range(3)]
    kw = dict(max_slots=2, max_len=48, decode_block=4, cache_layout="paged", page_size=8,
              cache_compress=spec)
    jout = JaxServeEngine(cfg, RCFG, params, **kw).run(
        [JaxRequest(uid=i, tokens=p, max_new_tokens=8) for i, p in enumerate(prompts)])
    eng = ServeEngine(tcfg, TRCFG, model, **kw)
    out = eng.run([Request(uid=i, tokens=p, max_new_tokens=8) for i, p in enumerate(prompts)])
    for i in range(3):
        assert out[i].tokens == jout[i].tokens, f"request {i} diverged"
    _drained(eng)


def test_quant_churn_batched_matches_solo_and_never_leaks():
    tcfg = torch_get_config("internlm2-1.8b_smoke")
    model = bridge.from_jax_params(jax.tree.map(np.asarray, init_model(
        get_config("internlm2-1.8b_smoke"), RCFG, jax.random.key(0))[0]), tcfg, device="cpu")
    rng = np.random.default_rng(26)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).tolist()
               for n in (6, 9, 7, 10, 6, 8, 11, 6, 9, 7)]
    mk = lambda: [Request(uid=i, tokens=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    kw = dict(max_len=64, decode_block=3, cache_layout="paged", page_size=8,
              cache_compress="int8")
    eng = ServeEngine(tcfg, TRCFG, model, max_slots=3, pool_tokens=48, **kw)
    for r in mk():
        eng.submit(r)
    done = {}
    while eng.has_work:
        for out in eng.step():
            done[out.uid] = out
        for alloc in eng.allocators:
            alloc.check_invariant()
    for i, req in enumerate(mk()):
        solo = ServeEngine(tcfg, TRCFG, model, max_slots=1, **kw).run([req])[i]
        assert done[i].tokens == solo.tokens, f"request {i} diverged"
    _drained(eng)
    assert eng.allocators[0].total_page_allocations > eng.allocators[0].spec.n_pages


def test_compressed_layout_errors():
    tcfg = torch_get_config("internlm2-1.8b_smoke")
    model = bridge.from_jax_params(jax.tree.map(np.asarray, init_model(
        get_config("internlm2-1.8b_smoke"), RCFG, jax.random.key(0))[0]), tcfg, device="cpu")
    with pytest.raises(ValueError, match="cache_layout='paged'"):
        ServeEngine(tcfg, TRCFG, model, max_slots=1, max_len=32, cache_compress="int8")
    with pytest.raises(ValueError):
        ServeEngine(tcfg, TRCFG, model, max_slots=1, max_len=32, cache_layout="paged",
                    page_size=8, cache_compress="int3")
