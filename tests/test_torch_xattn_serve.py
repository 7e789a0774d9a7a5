"""llama-3.2-vision smoke served by the port on the CPU, against the JAX
package: prefill (logits and every xattn layer's image K/V) and eight
decode steps, also against a teacher-forced forward; the serving engine
dense, on fp page pools (the xattn cache stays a dense slot cache) and on
int8 pools, token for token against the JAX engine, with bucketing on;
int8's spliced decode logits against fp at the JAX bound; a request
without images, ``prefix_share`` and ``speculative_k`` refused with the
JAX texts; a Router over 2 replicas behind a dedicated prefill engine;
``greedy_decode`` against ``greedy_decode_per_token`` and JAX's; the CLIs.
The block, K6 non-causal and training are in ``test_torch_xattn.py``,
which holds the shared helpers (every test sets both gates nonzero).

Tolerances (f32): logits and caches rtol 1e-4 / atol 1e-5, as in
``test_torch_serving.py``; greedy tokens exactly; int8 pool logits within
0.15 of the fp pool's, the bound of the JAX package's
``test_compressed_decode_logits_within_tolerance``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode_step as jax_decode_step
from repro.models import prefill as jax_prefill
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.train.serve_step import greedy_decode as jax_greedy_decode
from repro_torch.core.keys import Key
from repro_torch.models import attention as attn_lib
from repro_torch.models import decode_step, forward, prefill
from repro_torch.serve import Request, Router, ServeEngine, read_slot
from repro_torch.serve import cache as cache_lib
from repro_torch.train.serve_step import greedy_decode, greedy_decode_per_token
from tests.test_torch_xattn import ARCH, JR, TR, images, models


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=1e-4, atol=1e-5)


def _teacher_forced(tcfg, model, seq, img):
    """Logits (L, V) of a forward over ``seq`` with one image."""
    with torch.no_grad():
        h, _ = forward(tcfg, TR, None, model,
                       {"tokens": torch.tensor([seq]), "image_embeds": torch.from_numpy(img)[None]},
                       Key(0))
        return (h[0] @ model.head).numpy()


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L", [1, 7, 12])
def test_prefill_and_decode_match_jax(L):
    """Prefill logits and each layer's cache (the xattn layer's image K/V
    and the self-attention K/V) against JAX; then eight decode steps
    against JAX and against a teacher-forced forward; the image K/V are
    not written by decode."""
    jcfg, params, tcfg, model = models()
    seq = np.random.default_rng(L).integers(0, jcfg.vocab_size, (2, L + 8)).astype(np.int32)
    img = images(2, jcfg, seed=L)
    lj, cj = jax_prefill(jcfg, JR, params, {"tokens": jnp.asarray(seq[:, :L]),
                                            "image_embeds": jnp.asarray(img)}, 32)
    lt, ct = prefill(tcfg, TR, model, {"tokens": torch.from_numpy(seq[:, :L]).long(),
                                       "image_embeds": torch.from_numpy(img)}, 32)
    close(lj, lt.numpy())
    xnode = ct[0][4]
    assert isinstance(xnode, attn_lib.XAttnCache) and xnode.k.shape == (1, 2, 16, 2, 16)
    close(cj[0][4][0], xnode.k.numpy())
    close(cj[0][4][1], xnode.v.numpy())
    for node_j, node_t in zip(cj[0][:4], ct[0][:4]):
        np.testing.assert_array_equal(np.asarray(node_j.slot_pos), node_t.slot_pos.numpy())
        close(node_j.k, node_t.k.numpy())
    k_img = xnode.k.clone()
    full = np.stack([_teacher_forced(tcfg, model, seq[b].tolist(), img[b]) for b in range(2)])
    close(full[:, L - 1], lt[:, 0].numpy())
    for step in range(8):
        tok = seq[:, L + step:L + step + 1]
        pos = np.full((2, 1), L + step, np.int32)
        lj, cj = jax_decode_step(jcfg, JR, params, jnp.asarray(tok), jnp.asarray(pos), cj,
                                 {"image_embeds": jnp.asarray(img)})
        lt, ct = decode_step(tcfg, TR, model, torch.from_numpy(tok).long(),
                             torch.from_numpy(pos), ct)
        close(lj, lt.numpy())
        close(full[:, L + step], lt[:, 0].numpy())
    assert torch.equal(ct[0][4].k, k_img)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
PROMPTS = (12, 7, 20, 3)


def _requests(make, cfg, max_new=8, seed=2):
    rng = np.random.default_rng(seed)
    imgs = images(len(PROMPTS), cfg, seed=seed + 1)
    return [make(uid=i, tokens=rng.integers(0, 256, size=n).tolist(),
                 max_new_tokens=max_new, image_embeds=imgs[i])
            for i, n in enumerate(PROMPTS)]


LAYOUTS = {"dense": {}, "paged": dict(cache_layout="paged", page_size=4),
           "int8": dict(cache_layout="paged", page_size=4, cache_compress="int8")}


@pytest.mark.parametrize("pools", sorted(LAYOUTS))
def test_engine_greedy_streams_match_jax_engine(pools):
    """Two slots, four requests each with its own image (a slot is
    reused): greedy tokens equal the JAX engine's exactly, dense, on fp
    page pools and on int8 pools; bucketing is on (prompts padded to
    powers of two, the same buckets as JAX); the xattn cache is a dense
    slot cache in every layout, with no pool of its own; a request alone
    gives the same tokens as batched."""
    jcfg, params, tcfg, model = models()
    kw = dict(max_slots=2, max_len=40, decode_block=4, **LAYOUTS[pools])
    jeng = JaxServeEngine(jcfg, JR, params, **kw)
    teng = ServeEngine(tcfg, TR, model, **kw)
    jout = jeng.run(_requests(JaxRequest, jcfg))
    tout = teng.run(_requests(Request, tcfg))
    st, jst = teng.stats(), jeng.stats()
    assert st["buckets_enabled"] is jst["buckets_enabled"] is True
    assert teng.bucket_lens == jeng.bucket_lens == {16, 32}
    assert isinstance(teng.caches[0][4], attn_lib.XAttnCache)
    if pools != "dense":
        assert teng.pool_labels == ["stage0.attn"] * 4
        assert st["cache_pools"] == jst["cache_pools"]
    for i in range(len(PROMPTS)):
        assert tout[i].tokens == jout[i].tokens, i
    solo = ServeEngine(tcfg, TR, model, **kw)
    for req in _requests(Request, tcfg)[:2]:
        assert solo.run([req])[req.uid].tokens == tout[req.uid].tokens, req.uid


def test_int8_decode_logits_within_the_jax_bound():
    """One decode step after a bucketed prefill spliced into int8 pools:
    its logits within 0.15 of the fp pools' (the JAX bound for int8), the
    image K/V spliced unquantised."""
    jcfg, params, tcfg, model = models()
    logits = {}
    for fmt in ("fp", "int8"):
        kw = dict(max_slots=2, max_len=40, cache_layout="paged", page_size=4)
        if fmt == "int8":
            kw.update(cache_compress="int8")
        eng = ServeEngine(tcfg, TR, model, **kw)
        req = _requests(Request, tcfg)[0]
        eng.insert(eng.prefill(model, req), eng.decode_state, 0)
        assert torch.equal(read_slot(eng.caches, 0)[0][4].k, eng.caches[0][4].k[:, :1])
        pos = torch.tensor([[len(req.tokens)], [-1]], dtype=torch.int32)
        tok = torch.tensor([[int(eng.tok[0])], [0]])
        lg, _ = decode_step(tcfg, TR, model, tok, pos, eng.caches)
        logits[fmt] = lg[0, 0].numpy()
    err = float(np.abs(logits["int8"] - logits["fp"]).max())
    assert 0 < err < 0.15


def test_request_without_images_and_options_refused_as_jax():
    """A vision request without image_embeds is refused at submit;
    prefix_share and speculative_k at construction; each with the JAX
    engine's text."""
    jcfg, params, tcfg, model = models()
    msgs = []
    for make_eng, make_req in ((lambda **kw: JaxServeEngine(jcfg, JR, params, **kw),
                                JaxRequest),
                               (lambda **kw: ServeEngine(tcfg, TR, model, **kw), Request)):
        eng = make_eng(max_slots=1, max_len=16)
        with pytest.raises(ValueError) as exc:
            eng.submit(make_req(uid=3, tokens=[1, 2], max_new_tokens=2))
        got = [str(exc.value)]
        for opt in (dict(prefix_share=True), dict(speculative_k=2)):
            with pytest.raises(ValueError) as exc:
                make_eng(max_slots=2, max_len=16, cache_layout="paged", page_size=4, **opt)
            got.append(str(exc.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]
    assert msgs[1][0] == "request 3: arch needs image_embeds"
    assert "vision archs carry per-request image state" in msgs[1][1]
    assert "xattn blocks are sequential" in msgs[1][2]


def test_router_with_dedicated_prefill_gives_the_one_replica_tokens():
    """A Router over 2 paged replicas behind a dedicated prefill engine:
    each Prefix (its image K/V included) crosses in host form, the
    replicas run no prefill, and the tokens equal one engine's."""
    _, _, tcfg, model = models()
    kw = dict(max_len=40, decode_block=4, cache_layout="paged", page_size=4)
    one = ServeEngine(tcfg, TR, model, max_slots=2, **kw).run(_requests(Request, tcfg))
    replicas = [ServeEngine(tcfg, TR, model, max_slots=2, **kw) for _ in range(2)]
    router = Router(replicas, prefill_engine=ServeEngine(tcfg, TR, model, max_slots=1, **kw))
    routed = router.run(_requests(Request, tcfg))
    assert all(r.prefill_count == 0 for r in replicas)
    assert sum(r.insert_count for r in replicas) == len(PROMPTS)
    for i in range(len(PROMPTS)):
        assert routed[i].tokens == one[i].tokens, i


def test_greedy_decode_matches_per_token_and_jax():
    """greedy_decode (the engine) equals the per-token loop and the JAX
    package's greedy_decode, images carried per row."""
    jcfg, params, tcfg, model = models()
    toks = np.random.default_rng(6).integers(0, 256, (2, 9)).astype(np.int64)
    img = images(2, jcfg, seed=6)
    batch = {"tokens": torch.from_numpy(toks), "image_embeds": torch.from_numpy(img)}
    a = greedy_decode(tcfg, TR, model, batch, steps=6, max_len=24)
    b = greedy_decode_per_token(tcfg, TR, model, batch, steps=6, max_len=24)
    j = jax_greedy_decode(jcfg, JR, params, {"tokens": jnp.asarray(toks, jnp.int32),
                                             "image_embeds": jnp.asarray(img)},
                          steps=6, max_len=24)
    assert torch.equal(a, b)
    np.testing.assert_array_equal(a.numpy(), np.asarray(j))


def test_cache_bytes_count_the_image_kv():
    """slot_bytes counts the xattn node: 2 x 16 image tokens x KV 2 x dh
    16 x 4 bytes a slot beside the self-attention slabs."""
    _, _, tcfg, model = models()
    eng = ServeEngine(tcfg, TR, model, max_slots=2, max_len=16)
    xnode = eng.caches[0][4]
    kv = sum(t.numel() * t.element_size()
             for node in eng.caches[0][:4] for t in node.tensors())
    assert cache_lib.cache_bytes(eng.caches) == kv + 2 * 2 * 16 * 2 * 16 * 4
    assert [t.shape for t in xnode.tensors()] == [(1, 2, 16, 2, 16)] * 2
    assert list(cache_lib.kv_cache_nodes(eng.caches)) == eng.caches[0][:4]


def test_serve_and_train_clis_run_vision_on_the_cpu(capsys):
    """The CLIs on vision smoke: serving dense and paged (bucketing on),
    training through both attention rules."""
    from repro_torch.launch import serve, train

    for extra in ([], ["--cache-layout", "paged", "--page-size", "4"]):
        serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--requests", "3",
                    "--prompt-len", "10", "--gen", "4", "--smoke", *extra])
        out = capsys.readouterr().out
        assert "SMOKE OK" in out and "bucketing off" not in out
    train.main(["--arch", ARCH, "--device", "cpu", "--steps", "3", "--seq-len", "16",
                "--global-batch", "2", "--log-every", "1",
                "--compression", "attn.qkv=pamm(r=1/8);attn.cross_kv=pamm(r=1/8)"])
    out = capsys.readouterr().out
    assert out.count("step ") == 3 and "done: 3 steps" in out
