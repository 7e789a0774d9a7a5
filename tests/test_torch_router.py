"""The port's serving front (``repro_torch.serve.router.Router`` and
``ServeEngine.admit_prefix``) against the JAX package's, on the CPU, in
f32 with bridged parameters on internlm2-1.8b_smoke:

* the same requests through both Routers over 2 replicas, dense and
  paged: the same placement and peak aggregate concurrency, and tokens
  equal up to a near tie (a stream may diverge only where the JAX top-2
  logit margin is below 1e-4, the rule of tests/test_torch_serving.py);
  routed tokens equal the port's solo engine exactly;
* a dedicated prefill engine handing Prefixes off in host form, the
  decode replicas running no prefill of their own;
* page-aware spread, pinned rejections word for word against the JAX
  Router, the constructor's and the pin's checks, and the stage API.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import RunConfig, get_config
from repro.models import forward, init_model
from repro.serve import Request as JaxRequest
from repro.serve import Router as JaxRouter
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import RunConfig as TorchRunConfig
from repro_torch.configs import get_config as torch_get_config
from repro_torch.serve import Prefix, Request, Router, ServeEngine

ARCH = "internlm2-1.8b_smoke"
RCFG = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
TRCFG = TorchRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
# the layouts of tests/test_disagg.py the Router runs over
LAYOUTS = {
    "dense": dict(),
    "paged": dict(cache_layout="paged", page_size=8),
}
NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def models():
    cfg = get_config(ARCH)
    params, _ = init_model(cfg, RCFG, jax.random.key(0))
    tcfg = torch_get_config(ARCH)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, cfg.vocab_size, size=n)] for n in lengths]


def _requests(cfg, make, lengths=(10, 7, 9, 12, 5), max_new=6):
    return [make(uid=i, tokens=p, max_new_tokens=max_new)
            for i, p in enumerate(_prompts(cfg, lengths))]


def _jax_margin(cfg, params, seq) -> float:
    """Top-2 margin of the JAX forward's last logits row over ``seq``."""
    batch = {"tokens": jnp.asarray(seq, jnp.int32)[None],
             "labels": jnp.zeros((1, len(seq)), jnp.int32)}
    h, _ = forward(cfg, RCFG, None, params, batch, jax.random.key(2))
    row = np.asarray((h[0, -1] @ params["head"]).astype(jnp.float32))[: cfg.vocab_size]
    top2 = np.sort(row)[-2:]
    return float(top2[1] - top2[0])


def _same_or_near_tie(cfg, params, prompt, want, got):
    assert len(got) == len(want)
    diff = [t for t in range(len(want)) if want[t] != got[t]]
    if diff:
        t = diff[0]
        margin = _jax_margin(cfg, params, list(prompt) + list(want[:t]))
        assert margin < NEAR_TIE, f"diverged at token {t}, JAX margin {margin:.3e}"


def _drained(eng):
    for alloc in eng.allocators:
        alloc.check_invariant()
        assert alloc.free_pages == alloc.spec.n_pages


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_router_matches_jax_router_and_solo(models, layout):
    """Five requests through 2 replicas of 2 slots in both packages: the
    same placement and peak aggregate concurrency, tokens equal up to a
    near tie, and the port's routed tokens equal its solo engine's."""
    cfg, params, tcfg, model = models
    kw = dict(max_slots=2, max_len=64, decode_block=4, **LAYOUTS[layout])
    jrouter = JaxRouter([JaxServeEngine(cfg, RCFG, params, **kw) for _ in range(2)])
    jout = jrouter.run(_requests(cfg, JaxRequest))
    trouter = Router([ServeEngine(tcfg, TRCFG, model, **kw) for _ in range(2)])
    tout = trouter.run(_requests(tcfg, Request))
    solo = ServeEngine(tcfg, TRCFG, model, **kw).run(_requests(tcfg, Request))
    assert trouter.placement == jrouter.placement
    assert set(trouter.placement.values()) == {0, 1}
    tst, jst = trouter.stats(), jrouter.stats()
    assert tst["peak_active_aggregate"] == jst["peak_active_aggregate"] == 4
    assert tst["replicas"] == 2 and not tst["dedicated_prefill"]
    assert tst["decode_tokens"] == jst["decode_tokens"] > 0
    assert tst["prefill_tokens"] == jst["prefill_tokens"]
    assert len(tst["per_replica"]) == 2
    for req in _requests(tcfg, Request):
        assert tout[req.uid].tokens == solo[req.uid].tokens, f"uid {req.uid}"
        _same_or_near_tie(cfg, params, req.tokens, jout[req.uid].tokens,
                          tout[req.uid].tokens)
    for eng in trouter.replicas:
        _drained(eng)


def test_router_dedicated_prefill_host_handoff(models, monkeypatch):
    """A 1-slot prefill engine hands every Prefix to the decode replicas
    through ``to_host``; tokens equal the solo engine's and the replicas
    run no prefill of their own."""
    cfg, params, tcfg, model = models
    kw = dict(max_slots=2, max_len=64, decode_block=4, cache_layout="paged", page_size=8)
    handed = []
    to_host = Prefix.to_host

    def counted(self):
        handed.append(self.uid)
        return to_host(self)

    monkeypatch.setattr(Prefix, "to_host", counted)
    solo = ServeEngine(tcfg, TRCFG, model, **kw).run(_requests(tcfg, Request))
    pf = ServeEngine(tcfg, TRCFG, model, max_slots=1, max_len=64, cache_layout="paged",
                     page_size=8)
    router = Router([ServeEngine(tcfg, TRCFG, model, **kw) for _ in range(2)],
                    prefill_engine=pf)
    routed = router.run(_requests(tcfg, Request))
    for uid, o in solo.items():
        assert routed[uid].tokens == o.tokens
    assert sorted(handed) == sorted(solo)
    st = router.stats()
    assert st["dedicated_prefill"]
    assert st["prefill_tokens"] == sum(len(r.tokens) for r in _requests(tcfg, Request))
    assert pf.prefill_count == len(solo)
    assert all(s["prefill_count"] == 0 and s["prefill_tokens"] == 0
               for s in st["per_replica"])
    assert st["insert_count"] == len(solo)


def test_router_page_aware_admission_spreads_load(models):
    """Per-replica pools of one request each: the solo engine serves one
    at a time, 2 replicas serve 2 at once, as the JAX Router does."""
    cfg, params, tcfg, model = models
    kw = dict(max_slots=2, max_len=64, decode_block=4, cache_layout="paged",
              page_size=8, pool_tokens=16)   # 2 pages = one 10 + 6 request
    lengths = (10, 7, 9)
    solo_eng = ServeEngine(tcfg, TRCFG, model, **kw)
    solo = solo_eng.run(_requests(tcfg, Request, lengths))
    assert solo_eng.peak_active == 1
    router = Router([ServeEngine(tcfg, TRCFG, model, **kw) for _ in range(2)])
    routed = router.run(_requests(tcfg, Request, lengths))
    jrouter = JaxRouter([JaxServeEngine(cfg, RCFG, params, **kw) for _ in range(2)])
    jrouter.run(_requests(cfg, JaxRequest, lengths))
    for uid, o in solo.items():
        assert routed[uid].tokens == o.tokens
    assert router.peak_active == jrouter.peak_active == 2
    assert router.placement == jrouter.placement
    assert len(set(router.placement.values())) == 2


def _pinned_error(router, req):
    with pytest.raises(ValueError) as ei:
        router.submit(req, replica=0)
    return str(ei.value)


def test_router_pinned_rejections_match_jax_text(models):
    """A pin that can never fit names its pool deficit and the least
    loaded alternative (or that none exists), word for word as the JAX
    Router; the alternative then serves the request."""
    cfg, params, tcfg, model = models
    kw = dict(max_slots=2, max_len=64, cache_layout="paged", page_size=8)
    tok = list(range(1, 21))
    jax_small = JaxServeEngine(cfg, RCFG, params, pool_tokens=16, **kw)
    jax_big = JaxServeEngine(cfg, RCFG, params, pool_tokens=64, **kw)
    small = ServeEngine(tcfg, TRCFG, model, pool_tokens=16, **kw)
    big = ServeEngine(tcfg, TRCFG, model, pool_tokens=64, **kw)
    two = _pinned_error(Router([small, big]), Request(uid=9, tokens=tok, max_new_tokens=10))
    assert two == _pinned_error(JaxRouter([jax_small, jax_big]),
                                JaxRequest(uid=9, tokens=tok, max_new_tokens=10))
    assert "pages short" in two and "replica 1 (least loaded" in two
    one = _pinned_error(Router([small]), Request(uid=9, tokens=tok, max_new_tokens=10))
    assert one == _pinned_error(JaxRouter([jax_small]),
                                JaxRequest(uid=9, tokens=tok, max_new_tokens=10))
    assert "no other replica exists" in one
    router = Router([small, big])
    router.submit(Request(uid=9, tokens=tok, max_new_tokens=10), replica=1)
    out = router.run([])
    assert len(out[9].tokens) == 10 and router.placement == {9: 1}


def test_router_rejects_bad_pins_and_replica_sets(models):
    cfg, params, tcfg, model = models
    eng = lambda max_len=32: ServeEngine(tcfg, TRCFG, model, max_slots=1, max_len=max_len)
    with pytest.raises(ValueError, match="out of range"):
        Router([eng()]).submit(Request(uid=0, tokens=[1, 2], max_new_tokens=2), replica=1)
    with pytest.raises(ValueError, match="at least one decode replica"):
        Router([])
    with pytest.raises(ValueError, match="disagree on max_len"):
        Router([eng(32), eng(48)])
    with pytest.raises(ValueError, match="prefill engine max_len=48"):
        Router([eng(32)], prefill_engine=eng(48))
    with pytest.raises(ValueError, match="exceeds max_len"):
        Router([eng()]).submit(Request(uid=1, tokens=[1] * 30, max_new_tokens=8))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_admit_prefix_equals_submit_step(models, layout):
    """prefill + admit_prefix (of a host-form Prefix), then the engine's
    own steps, give the tokens of submit / step."""
    _, _, tcfg, model = models
    kw = dict(max_slots=2, max_len=64, decode_block=4, **LAYOUTS[layout])
    reqs = _requests(tcfg, Request, (10, 7))
    base = ServeEngine(tcfg, TRCFG, model, **kw).run(reqs)
    eng = ServeEngine(tcfg, TRCFG, model, **kw)
    for slot, req in enumerate(reqs):
        assert eng.admit_prefix(eng.prefill(eng.model, req).to_host(), slot) is None
    done = {}
    while eng.has_work:
        done.update((o.uid, o) for o in eng.step())
    assert {u: o.tokens for u, o in done.items()} == {u: o.tokens for u, o in base.items()}
    _drained(eng)


def test_admit_prefix_returns_the_output_when_the_first_token_stops(models):
    """A request whose first token already stops it (max_new_tokens 1)
    finishes inside admit_prefix and leaves its slot free."""
    _, _, tcfg, model = models
    eng = ServeEngine(tcfg, TRCFG, model, max_slots=1, max_len=32, cache_layout="paged",
                      page_size=8)
    [req] = _requests(tcfg, Request, (9,), max_new=1)
    out = eng.admit_prefix(eng.prefill(eng.model, req), 0)
    assert out is not None and out.uid == req.uid and len(out.tokens) == 1
    assert out.finish_reason == "length"
    assert not eng.has_work and int(eng.slot_uid[0]) == -1
    _drained(eng)
