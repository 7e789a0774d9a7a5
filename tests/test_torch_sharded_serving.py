"""The port's per-replica sharded page pools on the CPU, against the JAX
package (after ``tests/test_multidevice.py:362-500`` and
``tests/test_kvquant.py:525-545``, whose meshes need several JAX devices
or pass one; the JAX sharded functions ``vmap`` over the shard axis, so
the parity cases below need none).

* ``flash_sharded_paged_decode`` / ``_quant``: the port's plain versions
  against JAX's ``use_pallas=False`` (vmapped reference) and
  ``use_pallas=True`` (fold + offset around the Pallas kernel, interpret
  mode), within 1e-6 in f32 on the rows that see a key (a fully masked
  row averages V over other pages in each: finite, discarded), at dp 2
  and 4, Lq 1 and 3, with -1 holes in the tables, an svd ``scale``, int8
  and int4 pages. The port's kernel route (the fold, the offset table,
  one launch) is run on the CPU with K7 / K8's plain versions in place of
  the kernels and must equal the per-shard plain route bitwise.
* ``sharded_paged_insert`` / ``_quant`` and ``attn_decode`` over a
  sharded cache (fp, int8, int4, svd; Lq 1 with a parked slot, and Lq 3)
  against JAX's, every pool leaf compared.
* ``write_slot_paged`` into a sharded stacked node against JAX's, and
  ``spec_from_cache`` of a sharded node (one shard's spec).
* The engine on ``_paged_serve_tokens``'s requests (internlm2 smoke, f32,
  4 slots, pages of 8, 6 requests): at dp 2 (fp and int8) and dp 4 the
  port's sharded engine gives exactly the JAX single-host engine's tokens,
  with ``n_replicas``, one allocator per pool and replica, the
  ``replica0/`` labels and every allocator drained; a dense engine at dp
  2, the int8 engine on a dp-1 mesh and recurrentgemma's ring pools at dp
  2 give the single-host engine's tokens; the refusals carry the JAX
  texts, and a mesh of ranks stays refused.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.kernels import flash_decode as jfd
from repro.models import attention as jattn
from repro.models import init_model as jax_init_model
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import cache as jcache
from repro.serve import paging as jpaging
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import launches
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.models import attention as tattn
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import cache as tcache
from repro_torch.serve import paging as tpaging

ARCH = "internlm2-1.8b_smoke"
JRCFG = JaxRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
TRCFG = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
TOL = 1e-6
PS, NB, KV, H, DH = 8, 4, 2, 4, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _pools(rng, dp, bs, Lq, *, width=DH, quant=None, hole=True):
    """Per-shard pools of ``bs`` slots each: every slot maps 3 of NB blocks
    at shuffled shard-local pages (one more unmapped with ``hole``), a
    written prefix of 9-20 tokens, stale positions on the spare pages.
    Returns numpy (q, q_pos, k, v, k_scale, v_scale, block_table,
    page_pos); the scales are None without ``quant`` = (bits, ngr)."""
    npl = bs * NB + 2
    bt = np.full((dp, bs, NB), -1, np.int32)
    ppos = rng.integers(0, NB * PS, size=(dp, npl, PS)).astype(np.int32)
    fill = rng.integers(9, 21, size=(dp, bs))
    for s in range(dp):
        perm = rng.permutation(npl)
        for b in range(bs):
            bt[s, b, :3] = perm[3 * b:3 * b + 3]
            slots = np.arange(3 * PS).reshape(3, PS)
            ppos[s, bt[s, b, :3]] = np.where(slots < fill[s, b], slots, -1)
    if hole:
        bt[0, 0, 1] = -1
    B = dp * bs
    q = rng.standard_normal((B, Lq, H, width)).astype(np.float32)
    last = fill.reshape(B)
    q_pos = (last[:, None] - Lq + np.arange(Lq)[None]).astype(np.int32)
    q_pos = q_pos[:, 0] if Lq == 1 else q_pos
    shape = (dp, npl, PS, KV, DH)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if quant is None:
        return q, q_pos, k[..., :width], v[..., :width], None, None, bt, ppos
    bits, ngr = quant
    (kq, ks), (vq, vs) = (tfd.quantize_kv(torch.from_numpy(x), bits, ngr) for x in (k, v))
    return q, q_pos, kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy(), bt, ppos


def _seen(bt, ppos, q_pos, Lq):
    """(B, Lq) rows that see at least one key (causal, mapped)."""
    dp, bs, nb = bt.shape
    rows = []
    for s in range(dp):
        for b in range(bs):
            pos = np.concatenate([ppos[s, p] if p >= 0 else np.full(PS, -1)
                                  for p in bt[s, b]])
            qp = np.asarray(q_pos).reshape(dp * bs, -1)[s * bs + b]
            rows.append([bool(((pos >= 0) & (pos <= x)).any()) for x in np.broadcast_to(qp, Lq)])
    return np.array(rows)


def _decode_cases():
    cases = []
    for dp in (2, 4):
        for Lq in (1, 3):
            cases.append((dp, Lq, None, None))
    cases += [(2, 1, None, 16 ** -0.5), (4, 3, (8, 1), None), (2, 1, (8, 2), None),
              (2, 3, (4, 2), None), (4, 1, (4, 1), None)]
    return cases


@pytest.mark.parametrize("dp,Lq,quant,scale", _decode_cases())
def test_sharded_wrappers_match_jax(dp, Lq, quant, scale):
    rng = np.random.default_rng(dp * 10 + Lq)
    width = 8 if scale else DH                        # svd: rank-8 coefficients
    q, q_pos, k, v, ks, vs, bt, ppos = _pools(rng, dp, 2, Lq, width=width, quant=quant)
    seen = _seen(bt, ppos, q_pos, Lq)
    assert seen.sum() > seen.size // 2
    if quant is None:
        got = tfd.flash_sharded_paged_decode_ref(*map(_t, (q, k, v, q_pos, bt, ppos)),
                                                 scale=scale)
        want = [jfd.flash_sharded_paged_decode(*map(jnp.asarray, (q, k, v, q_pos, bt, ppos)),
                                               use_pallas=p, scale=scale)
                for p in (False, True)]
    else:
        args = (q, k, v, ks, vs, q_pos, bt, ppos)
        got = tfd.flash_sharded_paged_decode_quant_ref(*map(_t, args))
        want = [jfd.flash_sharded_paged_decode_quant(*map(jnp.asarray, args), use_pallas=p)
                for p in (False, True)]
    assert bool(torch.isfinite(got).all())
    for w in want:
        diff = np.abs(got.numpy() - np.asarray(w))[seen]
        assert diff.max() < TOL


@pytest.mark.parametrize("quant", [None, (8, 2), (4, 1)])
def test_kernel_route_folds_and_offsets_as_the_plain_route(monkeypatch, quant):
    """The sharded wrappers' kernel route (pools folded as views, ids
    offset, one K7 / K8 call for the whole batch), run on the CPU with the
    plain K7 / K8 in place of the kernels, equals the per-shard plain
    route bitwise, with the offset table made inside and with the one a
    step's write plan carries; -1 stays -1."""
    monkeypatch.setattr(tfd, "flash_paged_decode_cuda", tfd.flash_paged_decode_ref)
    monkeypatch.setattr(tfd, "flash_paged_decode_quant_cuda",
                        tfd.flash_paged_decode_quant_ref)
    dp, bs, Lq = 4, 2, 3
    q, q_pos, k, v, ks, vs, bt, ppos = _pools(np.random.default_rng(5), dp, bs, Lq,
                                              quant=quant)
    q, q_pos, k, v, bt, ppos = map(_t, (q, q_pos, k, v, bt, ppos))
    node = tattn.PagedKVCache(k, v, ppos, bt, ring=False, sharded=True)
    table = tattn.paged_write(node, q_pos).table
    npl = k.shape[1]
    assert torch.equal(table, torch.where(bt >= 0, bt + npl * torch.arange(dp)[:, None, None],
                                          -1).reshape(dp * bs, NB))
    launches.reset()
    for tab in (None, table):
        if quant is None:
            got = tfd.flash_sharded_paged_decode_cuda(q, k, v, q_pos, bt, ppos, table=tab)
            want = tfd.flash_sharded_paged_decode_ref(q, k, v, q_pos, bt, ppos)
        else:
            ks_t, vs_t = _t(ks), _t(vs)
            got = tfd.flash_sharded_paged_decode_quant_cuda(q, k, v, ks_t, vs_t, q_pos, bt,
                                                            ppos, table=tab)
            want = tfd.flash_sharded_paged_decode_quant_ref(q, k, v, ks_t, vs_t, q_pos, bt,
                                                            ppos)
        assert torch.equal(got, want)
    name = "flash_sharded_paged_decode" + ("" if quant is None else "_quant")
    assert launches.counts()[name] == 2


# ---------------------------------------------------------------------------
# sharded inserts and decode attention
# ---------------------------------------------------------------------------
def _attn_setup(fmt, dp, bs, Lq, seed=0):
    """(JAX cfg, JAX attention params, port params, x (B, Lq, d),
    positions (B, Lq) with slot 1 parked, JAX sharded node, port sharded
    node) of one layer; the pools are filled from a seeded generator."""
    jcfg = jax_get_config(ARCH)
    rng = np.random.default_rng(seed)
    params = jattn.init_attention(jax.random.key(seed), jcfg, jnp.float32)[0]
    tparams = {k: _t(np.asarray(v)) for k, v in params.items()}
    B, kv, dh = dp * bs, jcfg.n_kv_heads, jcfg.head_dim
    npl = bs * NB + 2
    bt = np.full((dp, bs, NB), -1, np.int32)
    for s in range(dp):
        perm = rng.permutation(npl)
        bt[s, :, :3] = perm[:3 * bs].reshape(bs, 3)
    ppos = np.full((dp, npl, PS), -1, np.int32)
    fill = rng.integers(4, 12, size=B)
    for i in range(B):
        s, b = divmod(i, bs)
        slots = np.arange(3 * PS).reshape(3, PS)
        ppos[s, bt[s, b, :3]] = np.where(slots < fill[i], slots, -1)
    pos = (fill[:, None] + np.arange(Lq)[None]).astype(np.int32)
    pos[1] = -1                                        # a parked slot
    x = rng.standard_normal((B, Lq, jcfg.d_model)).astype(np.float32)
    ring = jnp.array(0, jnp.int32)
    if fmt == "fp":
        k, v = (rng.standard_normal((dp, npl, PS, kv, dh)).astype(np.float32)
                for _ in range(2))
        jnode = jattn.PagedKVCache(*map(jnp.asarray, (k, v, ppos, bt)), ring)
        tnode = tattn.PagedKVCache(*map(_t, (k, v, ppos, bt)), ring=False, sharded=True)
    elif fmt == "svd":
        r = dh // 2
        k, v = (rng.standard_normal((dp, npl, PS, kv, r)).astype(np.float32)
                for _ in range(2))
        basis = [np.linalg.qr(rng.standard_normal((kv, dh, dh)))[0][..., :r].astype(np.float32)
                 for _ in range(2)]
        jnode = jattn.SVDPagedKVCache(*map(jnp.asarray, (k, v, *basis, ppos, bt)), ring)
        tnode = tattn.SVDPagedKVCache(*map(_t, (k, v, *basis, ppos, bt)), ring=False,
                                      sharded=True)
    else:
        bits = 8 if fmt == "int8" else 4
        (kq, ks), (vq, vs) = (tfd.quantize_kv(torch.from_numpy(
            rng.standard_normal((dp, npl, PS, kv, dh)).astype(np.float32)), bits, 2)
            for _ in range(2))
        leaves = [a.numpy() for a in (kq, vq, ks, vs)] + [ppos, bt]
        jnode = jattn.QuantPagedKVCache(*map(jnp.asarray, leaves), ring)
        tnode = tattn.QuantPagedKVCache(*map(_t, leaves), ring=False, sharded=True)
    return jcfg, params, tparams, x, pos, jnode, tnode


def _leaves_equal(jnode, tnode, tol=0.0):
    for f in tnode.LEAVES:
        a, b = np.asarray(getattr(jnode, f)), getattr(tnode, f).numpy()
        if tol:
            np.testing.assert_allclose(b, a, atol=tol, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("fmt", ["fp", "int8", "int4"])
@pytest.mark.parametrize("dp,Lq", [(2, 1), (4, 3)])
def test_sharded_inserts_match_jax(fmt, dp, Lq):
    """The rows land through each shard's own table, the parked slot's
    nowhere: every pool leaf equals JAX's vmapped insert's."""
    _, _, _, _, pos, jnode, tnode = _attn_setup(fmt, dp, 2, Lq, seed=dp + Lq)
    rng = np.random.default_rng(7)
    kn, vn = (rng.standard_normal((dp * 2, Lq, KV, DH)).astype(np.float32) for _ in range(2))
    if fmt == "fp":
        jnode = jattn.sharded_paged_insert(jnode, jnp.asarray(kn), jnp.asarray(vn),
                                           jnp.asarray(pos))
        tattn.sharded_paged_insert(tnode, _t(kn), _t(vn), _t(pos))
    else:
        jnode = jattn.sharded_paged_insert_quant(jnode, jnp.asarray(kn), jnp.asarray(vn),
                                                 jnp.asarray(pos), DH)
        tattn.sharded_paged_insert_quant(tnode, _t(kn), _t(vn), _t(pos), DH)
    _leaves_equal(jnode, tnode, tol=1e-6 if fmt == "fp" else 0.0)


@pytest.mark.parametrize("fmt", ["fp", "int8", "int4", "svd"])
@pytest.mark.parametrize("dp,Lq", [(2, 1), (4, 3)])
def test_attn_decode_over_sharded_cache_matches_jax(fmt, dp, Lq):
    """``attn_decode`` over a sharded cache (insert, then the sharded
    wrapper; svd with the head dim's scale) against JAX's: the output of
    every live row within 1e-6 (f32), every pool leaf after the insert."""
    jcfg, params, tparams, x, pos, jnode, tnode = _attn_setup(fmt, dp, 2, Lq, seed=dp * Lq)
    tcfg = get_config(ARCH)
    out_j, jnode = jattn.attn_decode(params, jnp.asarray(x), jnp.asarray(pos), jnode,
                                     jcfg, window=0)
    write = tattn.paged_write(tnode, _t(pos))
    out_t, _ = tattn.attn_decode(tparams, _t(x), _t(pos), tnode, tcfg, window=0, write=write)
    live = pos[:, 0] >= 0
    assert np.abs(out_t.numpy()[live] - np.asarray(out_j)[live]).max() < TOL
    _leaves_equal(jnode, tnode, tol=1e-6)


# ---------------------------------------------------------------------------
# splices and the pool spec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["fp", "int8"])
def test_write_slot_paged_into_a_sharded_node_matches_jax(fmt):
    """A batch-1 prefill cache spliced into global slot 3 of a dp-2 stacked
    node (shard 1, local slot 1) through a shard-local row: every leaf
    equals JAX's ``write_slot_paged``, and shard 0 is untouched."""
    dp, bs, layers, S = 2, 2, 2, 24
    rng = np.random.default_rng(11)
    npl = bs * NB
    kv, dh = KV, DH
    ppos = rng.integers(0, 30, size=(layers, dp, npl, PS)).astype(np.int32)
    bt = np.full((layers, dp, bs, NB), -1, np.int32)
    ring = jnp.zeros((layers,), jnp.int32)
    if fmt == "fp":
        k, v = (rng.standard_normal((layers, dp, npl, PS, kv, dh)).astype(np.float32)
                for _ in range(2))
        leaves = [k, v, ppos, bt]
        jnode = jattn.PagedKVCache(*map(jnp.asarray, leaves), ring)
        tnode = tattn.PagedKVCache(*map(_t, leaves), ring=False, sharded=True)
    else:
        kq, vq = (rng.integers(-127, 128, size=(layers, dp, npl, PS, kv, dh)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.random((layers, dp, npl, PS, kv, 1)).astype(np.float32) for _ in range(2))
        leaves = [kq, vq, ks, vs, ppos, bt]
        jnode = jattn.QuantPagedKVCache(*map(jnp.asarray, leaves), ring)
        tnode = tattn.QuantPagedKVCache(*map(_t, leaves), ring=False, sharded=True)
    before = {f: getattr(tnode, f)[:, 0].clone() for f in tnode.LEAVES}
    ok, ov = (rng.standard_normal((layers, 1, S, kv, dh)).astype(np.float32) for _ in range(2))
    spos = np.tile(np.arange(S, dtype=np.int32), (layers, 1, 1))
    one_j = jattn.KVCache(*map(jnp.asarray, (ok, ov, spos)), jnp.zeros((layers,), jnp.int32))
    one_t = tattn.KVCache(*map(_t, (ok, ov, spos)), ring=False)
    row = np.array([5, 2, 7, -1], np.int32)
    jnode = jcache.write_slot_paged(jnode, one_j, jnp.asarray(row), 3, 20)
    tcache.write_slot_paged([[tnode]], [[one_t]], [[row]], 3, 20)
    _leaves_equal(jnode, tnode, tol=0.0)
    for f, t in before.items():
        assert torch.equal(getattr(tnode, f)[:, 0], t), f


def test_spec_from_cache_of_a_sharded_node_is_one_shard():
    sharded = tcache.shard_slots([[tattn.init_paged_kv_cache(
        4, 32, PS, 16, KV, DH, torch.float32, False, "cpu", layers=2)]], make_local_mesh(2))[0][0]
    assert sharded.sharded and sharded.k_pages.shape == (2, 2, 8, PS, KV, DH)
    assert sharded.block_table.shape == (2, 2, 2, 4)
    jnode = jattn.PagedKVCache(
        jnp.zeros((2, 2, 8, PS, KV, DH)), jnp.zeros((2, 2, 8, PS, KV, DH)),
        jnp.full((2, 2, 8, PS), -1, jnp.int32), jnp.full((2, 2, 2, 4), -1, jnp.int32),
        jnp.zeros((2,), jnp.int32))
    tb = tcache.kv_token_bytes(sharded)
    assert tb == jcache.kv_token_bytes(jnode)
    want = jpaging.spec_from_cache(jnode, tb)
    assert dataclasses.asdict(tpaging.spec_from_cache(sharded, tb)) == dataclasses.asdict(want)
    assert want.n_pages == 8
    assert tcache.pool_geometry(sharded) == jcache.pool_geometry(jnode) == (16, PS)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _models():
    cfg = jax_get_config(ARCH)
    params, _ = jax_init_model(cfg, JRCFG, jax.random.key(0))
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), get_config(ARCH),
                                   device="cpu")
    return params, model


def _serve_requests(req_cls):
    cfg = get_config(ARCH)
    return [req_cls(uid=i, tokens=[int(t) for t in np.random.default_rng(i).integers(
        1, cfg.vocab_size, size=10)], max_new_tokens=6) for i in range(6)]


PAGED = dict(max_len=32, decode_block=4, cache_layout="paged", page_size=8)


@functools.lru_cache(maxsize=None)
def _jax_tokens(compress):
    """``tests/test_multidevice.py::_paged_serve_tokens(None, ...)``: the
    JAX single-host engine's tokens."""
    params, _ = _models()
    eng = JaxServeEngine(jax_get_config(ARCH), JRCFG, params, max_slots=4,
                         cache_compress=compress, **PAGED)
    return {u: o.tokens for u, o in eng.run(_serve_requests(JaxRequest)).items()}


def _drained(eng):
    for alloc in eng.allocators:
        alloc.check_invariant()
        assert alloc.free_pages == alloc.spec.n_pages


@pytest.mark.parametrize("dp,compress", [(2, None), (2, "int8"), (4, None)])
def test_sharded_engine_tokens_equal_the_jax_single_host_engine(dp, compress):
    _, model = _models()
    launches.reset()
    eng = ServeEngine(get_config(ARCH), TRCFG, model, max_slots=4, mesh=make_local_mesh(dp),
                      cache_compress=compress, **PAGED)
    out = {u: o.tokens for u, o in eng.run(_serve_requests(Request)).items()}
    assert out == _jax_tokens(compress)
    n_pools = len(eng.pool_labels) // eng.n_replicas
    assert eng.n_replicas == dp and eng.stats()["replica_shards"] == dp
    assert len(eng.allocators) == dp * n_pools
    assert eng.pool_labels[0].startswith("replica0/")
    assert eng.allocators[0].spec.n_pages == 16 // dp
    node = next(n for n in tcache.kv_cache_nodes(eng.caches))
    assert node.sharded and node.k_pages.shape[1] == dp
    _drained(eng)
    plain = "flash_sharded_paged_decode" + ("" if compress is None else "_quant") + "_ref"
    counts = launches.counts()
    assert counts[plain] == get_config(ARCH).n_layers * eng.stats()["decode_steps"]
    assert not counts.get("flash_paged_decode_ref") and not counts.get("flash_decode_ref")


def test_dp4_placement_spreads_requests_over_every_replica():
    """At dp 4 (one slot a replica) admission puts a request on every
    replica; placement prefers the replica with the most headroom."""
    _, model = _models()
    eng = ServeEngine(get_config(ARCH), TRCFG, model, max_slots=4, mesh=make_local_mesh(4),
                      **PAGED)
    reqs = _serve_requests(Request)
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert eng.max_slots // eng.n_replicas == 1
    assert sorted(int(u) for u in eng.slot_uid) == [0, 1, 2, 3]
    assert [eng._slot_replica(s) for s in range(4)] == [0, 1, 2, 3]
    assert all(a.reserved_pages == 2 for a in eng.allocators)


def test_dense_engine_on_a_mesh_serves_as_without_one():
    """``tests/test_multidevice.py::test_serving_decode_parity_dp2``: the
    dense layout under a dp-2 mesh gives the single-host tokens, with one
    replica."""
    _, model = _models()
    cfg = get_config(ARCH)
    reqs = lambda: [Request(uid=i, tokens=[int(t) for t in np.random.default_rng(i).integers(
        1, cfg.vocab_size, size=12)], max_new_tokens=8) for i in range(4)]
    run = lambda mesh: ServeEngine(cfg, TRCFG, model, max_slots=2, max_len=32, mesh=mesh)
    eng = run(make_local_mesh(2))
    assert eng.n_replicas == 1
    assert ({u: o.tokens for u, o in eng.run(reqs()).items()}
            == {u: o.tokens for u, o in run(None).run(reqs()).items()})


def test_int8_engine_on_a_dp1_mesh_matches_single_host():
    """``tests/test_kvquant.py::test_quant_paged_on_mesh_matches_single_host``."""
    _, model = _models()
    cfg = get_config(ARCH)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (9, 6)]
    mk = lambda: [Request(uid=i, tokens=prompts[i], max_new_tokens=5) for i in range(2)]
    kw = dict(max_slots=2, max_len=64, decode_block=4, cache_layout="paged", page_size=8,
              cache_compress="int8")
    solo = ServeEngine(cfg, TRCFG, model, **kw).run(mk())
    eng = ServeEngine(cfg, TRCFG, model, mesh=make_local_mesh(1), **kw)
    out = eng.run(mk())
    assert eng.n_replicas == 1 and next(tcache.kv_cache_nodes(eng.caches)).sharded
    for i in range(2):
        assert out[i].tokens == solo[i].tokens


def test_recurrentgemma_ring_pools_at_dp2():
    """recurrentgemma smoke (rec + latt blocks, the latt pool a ring of
    window 8 at pages of 4): dp 2 gives the single-host paged engine's
    tokens, its streams passing the window."""
    cfg = get_config("recurrentgemma-9b_smoke")
    from repro_torch.models import init_model

    model = init_model(cfg, TRCFG, seed=0, device="cpu")
    reqs = lambda: [Request(uid=i, tokens=[int(t) for t in np.random.default_rng(i).integers(
        1, cfg.vocab_size, size=7 + i)], max_new_tokens=6) for i in range(4)]
    kw = dict(max_slots=2, max_len=24, decode_block=4, cache_layout="paged", page_size=4)
    base = ServeEngine(cfg, TRCFG, model, **kw).run(reqs())
    eng = ServeEngine(cfg, TRCFG, model, mesh=make_local_mesh(2), **kw)
    out = eng.run(reqs())
    assert all(a.spec.ring for a in eng.allocators) and eng.n_replicas == 2
    assert {u: o.tokens for u, o in out.items()} == {u: o.tokens for u, o in base.items()}
    _drained(eng)


def test_refusals_carry_the_jax_texts():
    _, model = _models()
    cfg = get_config(ARCH)
    with pytest.raises(ValueError, match="max_slots divisible by the DP degree 2"):
        ServeEngine(cfg, TRCFG, model, max_slots=3, max_len=32, mesh=make_local_mesh(2))
    with pytest.raises(ValueError, match="pages must divide by the DP degree 2"):
        ServeEngine(cfg, TRCFG, model, max_slots=2, max_len=32, cache_layout="paged",
                    page_size=8, pool_tokens=24, mesh=make_local_mesh(2))
    with pytest.raises(ValueError, match="prefix_share is single-replica"):
        ServeEngine(cfg, TRCFG, model, max_slots=2, max_len=32, cache_layout="paged",
                    page_size=8, prefix_share=True, mesh=make_local_mesh(2))
    ranks = Mesh(("data", "model"), (2, 1), groups={"data": object()}, sync_group=object())
    with pytest.raises(NotImplementedError, match="later multi-GPU serving slice"):
        ServeEngine(cfg, TRCFG, model, max_slots=2, max_len=32, mesh=ranks)
