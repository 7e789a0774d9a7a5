"""recurrentgemma smoke served by the port on the CPU, against the JAX
package: prefill and decode at prompt lengths across ``local_window`` 8
(the latt blocks' ring wraps), decoding from the zero state; the serving
engine dense, on fp ring page pools and on int8 ones, token for token
against the JAX engine; the ``prefix_share`` / ``speculative_k`` refusals,
word for word; the ``prefill_buckets`` option (``tests/test_disagg.py``'s
contract); the slot splices of a recurrent state; the CLIs. The rec and
latt blocks and training are in ``test_torch_rglru.py``, which holds the
shared helpers.

Tolerances (f32): logits and states rtol 1e-4 / atol 1e-5, as in
``test_torch_serving.py``; ring positions and greedy tokens exactly.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode_step as jax_decode_step
from repro.models import prefill as jax_prefill
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import engine as jax_engine_mod
from repro_torch.core.keys import Key
from repro_torch.models import attention as attn_lib
from repro_torch.models import decode_step, forward, init_caches, prefill, rglru
from repro_torch.serve import Request, ServeEngine, read_slot, write_slot
from repro_torch.serve import engine as engine_mod
from tests.test_torch_rglru import ARCH, JR, TR, close, models


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
def _cache_close(cj, ct):
    for stage_j, stage_t in zip(cj, ct):
        for node_j, node_t in zip(stage_j, stage_t):
            if isinstance(node_t, rglru.RGLRUCache):
                close(node_j.h, node_t.h.numpy())
                close(node_j.conv_state, node_t.conv_state.numpy())
            else:
                assert isinstance(node_t, attn_lib.KVCache) and node_t.ring
                np.testing.assert_array_equal(np.asarray(node_j.slot_pos),
                                              node_t.slot_pos.numpy())
                close(node_j.k, node_t.k.numpy())
                close(node_j.v, node_t.v.numpy())


@pytest.mark.parametrize("L", [1, 5, 8, 9, 20])
def test_prefill_and_decode_match_jax_across_the_ring(L):
    """Prompts shorter than the window of 8, filling it, one past it and
    2.5 windows long (the ring wrapped): logits and every layer's cache
    against JAX; then four decode steps (the ring wraps on) against JAX
    and against a full forward over the same tokens."""
    jcfg, params, tcfg, model = models()
    seq = np.random.default_rng(L).integers(0, jcfg.vocab_size, (2, L + 4)).astype(np.int32)
    lj, cj = jax_prefill(jcfg, JR, params, {"tokens": jnp.asarray(seq[:, :L])}, 32)
    lt, ct = prefill(tcfg, TR, model, {"tokens": torch.from_numpy(seq[:, :L]).long()}, 32)
    close(lj, lt.numpy())
    _cache_close(cj, ct)
    with torch.no_grad():
        h, _ = forward(tcfg, TR, None, model, {"tokens": torch.from_numpy(seq).long()}, Key(0))
        full = (h @ model.head).numpy()
    close(full[:, L - 1], lt[:, 0].numpy())
    for step in range(4):
        tok = seq[:, L + step:L + step + 1]
        pos = np.full((2, 1), L + step, np.int32)
        lj, cj = jax_decode_step(jcfg, JR, params, jnp.asarray(tok), jnp.asarray(pos), cj)
        lt, ct = decode_step(tcfg, TR, model, torch.from_numpy(tok).long(),
                             torch.from_numpy(pos), ct)
        close(lj, lt.numpy())
        close(full[:, L + step], lt[:, 0].numpy())
    _cache_close(cj, ct)


def test_decode_from_the_zero_state_equals_prefill():
    """Three tokens decoded one by one from zero caches give prefill's
    logits and recurrent states."""
    jcfg, params, tcfg, model = models()
    seq = np.random.default_rng(9).integers(0, 256, (1, 3)).astype(np.int64)
    lt, ct = prefill(tcfg, TR, model, {"tokens": torch.from_numpy(seq)}, 8)
    caches = init_caches(tcfg, TR, 1, 8, "cpu")
    for t in range(3):
        ld, caches = decode_step(tcfg, TR, model, torch.from_numpy(seq[:, t:t + 1]),
                                 torch.full((1, 1), t, dtype=torch.int32), caches)
    close(lt.numpy(), ld.numpy())
    for node_d, node_p in zip(caches[1], ct[1]):
        close(node_p.h.numpy(), node_d.h.numpy())
        close(node_p.conv_state.numpy(), node_d.conv_state.numpy())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
PROMPTS = (12, 7, 20, 3)


def _prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, 256, size=n).tolist() for n in PROMPTS]


@pytest.mark.parametrize("pools", ["dense", "paged", "int8"])
def test_engine_greedy_streams_match_jax_engine(pools):
    """Two slots, four requests (a slot is reused; prompts and streams
    cross the window of 8): greedy tokens equal the JAX engine's exactly,
    on the dense slot cache, on fp ring page pools and on int8 ones (K8's
    plain version); each prompt prefilled at its own length; a request
    alone gives the same tokens as batched."""
    jcfg, params, tcfg, model = models()
    kw = dict(max_slots=2, max_len=48, decode_block=4)
    if pools != "dense":
        kw.update(cache_layout="paged", page_size=4)
    if pools == "int8":
        kw.update(cache_compress="int8")
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
    if pools != "dense":
        assert len(teng.allocators) == len(jeng.allocators) == 1
        assert teng.allocators[0].spec.ring and teng.pool_labels == ["stage0.latt"]
        assert st["cache_pools"] == jst["cache_pools"]
    for i in range(len(prompts)):
        assert tout[i].tokens == jout[i].tokens, i
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        solo = ServeEngine(tcfg, TR, model, **kw)
    for i, p in enumerate(prompts):
        assert solo.run([Request(uid=10 + i, tokens=p, max_new_tokens=10)])[10 + i].tokens \
            == tout[i].tokens, i


@pytest.mark.parametrize("option", ["prefix_share", "speculative_k"])
def test_refusals_match_jax(option):
    """prefix_share on ring pools and speculative_k on rec / latt blocks:
    refused by both engines, word for word."""
    jcfg, params, tcfg, model = models()
    kw = dict(max_slots=2, max_len=40, cache_layout="paged", page_size=8)
    kw.update(prefix_share=True) if option == "prefix_share" else kw.update(speculative_k=2)
    msgs = []
    for make in (lambda: JaxServeEngine(jcfg, JR, params, **kw),
                 lambda: ServeEngine(tcfg, TR, model, **kw)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with pytest.raises(ValueError) as exc:
                make()
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    want = ("ring (sliding-window) pools" if option == "prefix_share"
            else "latt/rec blocks are sequential")
    assert want in msgs[1]


def _built(make):
    """(the engine, the bucket warnings its construction gave)."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        eng = make()
    return eng, [str(w.message) for w in rec if "prefill buckets" in str(w.message)]


def test_prefill_buckets_option_matches_jax():
    """tests/test_disagg.py's contract on recurrentgemma smoke, case for
    case against the JAX engine: None warns once, naming the rec blocks; a
    second engine stays quiet; False gives no warning and no buckets; True
    cannot turn bucketing on for the rec kind."""
    jcfg, params, tcfg, model = models()
    kw = dict(max_slots=1, max_len=32)
    for mod in (engine_mod, jax_engine_mod):
        mod._BUCKET_WARNED.clear()
    n_warn = []
    for opt in (False, None, None, False, True):
        port, port_w = _built(lambda: ServeEngine(tcfg, TR, model, prefill_buckets=opt, **kw))
        ref, ref_w = _built(lambda: JaxServeEngine(jcfg, JR, params, prefill_buckets=opt,
                                                   **kw))
        assert port.stats()["buckets_enabled"] is ref.stats()["buckets_enabled"] is False
        assert port_w == ref_w
        assert all("rec" in w and ARCH in w for w in port_w)
        n_warn.append(len(port_w))
    assert n_warn == [0, 1, 0, 0, 0]


def test_slot_splices_carry_the_recurrent_state():
    """write_slot splices h and conv_state (and the latt ring) into a slot
    over a previous occupant's values; read_slot gives them back; the
    other slots keep theirs."""
    jcfg, params, tcfg, model = models()
    prompt = np.random.default_rng(5).integers(0, 256, size=11).tolist()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng = ServeEngine(tcfg, TR, model, max_slots=3, max_len=32, decode_block=4)
    full = eng.caches
    for node in full[1]:
        for t in node.tensors():
            t.fill_(7.0)                       # a previous occupant's state
    one = eng.prefill(model, Request(uid=0, tokens=prompt, max_new_tokens=5)).caches
    assert isinstance(one[1][0], rglru.RGLRUCache) and one[1][0].h.abs().sum() > 0
    write_slot(full, one, 1)
    back = read_slot(full, 1)
    for si in range(2):
        for a_node, b_node in zip(back[si], one[si]):
            for a, b in zip(a_node.tensors(), b_node.tensors()):
                assert torch.equal(a, b)
    for s in (0, 2):
        assert (read_slot(full, s)[1][0].h == 7.0).all()


def test_serve_and_train_clis_run_recurrentgemma_on_the_cpu(capsys):
    """The CLIs on recurrentgemma smoke: serving dense and on int8 ring
    pools (the stats line says bucketing is off), training through both
    PAMM rules and reversible."""
    from repro_torch.launch import serve, train

    for extra in ([], ["--cache-layout", "paged", "--page-size", "4", "--cache-compress",
                       "int8"]):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--requests", "3",
                        "--prompt-len", "10", "--gen", "4", "--smoke", *extra])
        out = capsys.readouterr().out
        assert "SMOKE OK" in out and "bucketing off" in out
    for extra in ([], ["--block-structure", "reversible"]):
        train.main(["--arch", ARCH, "--device", "cpu", "--steps", "3", "--seq-len", "16",
                    "--global-batch", "2", "--log-every", "1",
                    "--compression", "attn.qkv=pamm(r=1/8);rglru.in=pamm(r=1/8)", *extra])
        out = capsys.readouterr().out
        assert out.count("step ") == 3 and "done: 3 steps" in out
