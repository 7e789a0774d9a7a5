"""The port's dense serving slice against the JAX package, on the CPU.

* prefill logits and every layer's cache, then teacher-forced decode
  logits, with bridged parameters in f32 (rtol 1e-4, atol 1e-5: the same
  math on two CPU backends, summed in other orders), on four smoke archs
  -- h2o-danube's ring cache included;
* the engine's greedy streams against the JAX engine's, where a stream
  may only diverge at a near tie (JAX top-2 logit margin < 1e-4);
* continuous batching: a request's tokens are the same alone as batched;
* the sampling contract (the two packages' random draws differ by
  design: threefry against a counter hash).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, get_config
from repro.models import decode_step, forward, init_model, prefill
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import RunConfig as TorchRunConfig
from repro_torch.configs import get_config as torch_get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import init_model as t_init_model
from repro_torch.models import prefill as t_prefill
from repro_torch.serve import (Request, SamplingParams, ServeEngine, read_slot,
                               sample_tokens)
from repro_torch.serve.sampling import uniform_bits

RCFG = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
TRCFG = TorchRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
ARCHS = ["internlm2-1.8b_smoke", "qwen2-72b_smoke", "qwen3-32b_smoke",
         "h2o-danube-3-4b_smoke"]
RTOL, ATOL = 1e-4, 1e-5


def _models(arch):
    cfg = get_config(arch)
    params, _ = init_model(cfg, RCFG, jax.random.key(0))
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params),
                                   torch_get_config(arch), device="cpu")
    return cfg, params, torch_get_config(arch), model


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=RTOL, atol=ATOL)


def _caches_close(c_jax, c_torch):
    for stage_j, stage_t in zip(c_jax, c_torch):
        for node_j, node_t in zip(stage_j, stage_t):
            _close(node_j.k, node_t.k.numpy())
            _close(node_j.v, node_t.v.numpy())
            np.testing.assert_array_equal(np.asarray(node_j.slot_pos),
                                          node_t.slot_pos.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Two right-padded prompts (a length bucket) through prefill, then
    six teacher-forced decode steps -- past danube's window of 8, so the
    ring wraps -- with one row parked (position -1) for a step."""
    cfg, params, tcfg, model = _models(arch)
    rng = np.random.default_rng(1)
    lens = np.array([12, 9], np.int32)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    lj, cj = prefill(cfg, RCFG, params, {"tokens": jnp.asarray(toks)}, 32,
                     prompt_len=jnp.asarray(lens))
    lt, ct = t_prefill(tcfg, TRCFG, model, {"tokens": torch.from_numpy(toks).long()},
                       32, prompt_len=torch.from_numpy(lens))
    _close(lj, lt.numpy())
    _caches_close(cj, ct)
    pos = lens.copy()
    for step in range(6):
        tok = rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        p = pos.copy()
        if step == 2:
            p[1] = -1                       # a parked slot
        lj, cj = decode_step(cfg, RCFG, params, jnp.asarray(tok),
                             jnp.asarray(p[:, None]), cj)
        lt, ct = t_decode_step(tcfg, TRCFG, model, torch.from_numpy(tok).long(),
                               torch.from_numpy(p[:, None]), ct)
        _close(lj, lt.numpy())
        pos += (p >= 0)
    _caches_close(cj, ct)


def _jax_logits(cfg, params, seq):
    batch = {"tokens": jnp.asarray(seq, jnp.int32)[None],
             "labels": jnp.zeros((1, len(seq)), jnp.int32)}
    h, _ = forward(cfg, RCFG, None, params, batch, jax.random.key(2))
    return np.asarray((h[0] @ params["head"]).astype(jnp.float32))[:, : cfg.vocab_size]


@pytest.mark.parametrize("arch", ["internlm2-1.8b_smoke", "h2o-danube-3-4b_smoke"])
def test_engine_greedy_streams_match_jax_engine(arch):
    cfg, params, tcfg, model = _models(arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (12, 7, 10)]
    gen = 10
    jeng = JaxServeEngine(cfg, RCFG, params, max_slots=2, max_len=40, decode_block=4)
    jout = jeng.run([JaxRequest(uid=i, tokens=p, max_new_tokens=gen)
                     for i, p in enumerate(prompts)])
    teng = ServeEngine(tcfg, TRCFG, model, max_slots=2, max_len=40, decode_block=4)
    tout = teng.run([Request(uid=i, tokens=p, max_new_tokens=gen)
                     for i, p in enumerate(prompts)])
    for i, prompt in enumerate(prompts):
        a, b = jout[i].tokens, tout[i].tokens
        assert len(b) == gen
        diff = [t for t in range(gen) if a[t] != b[t]]
        if diff:
            t = diff[0]
            row = _jax_logits(cfg, params, prompt + a[:t])[-1]
            top2 = np.sort(row)[-2:]
            assert top2[1] - top2[0] < 1e-4, (
                f"request {i} diverged at token {t} with JAX margin "
                f"{top2[1] - top2[0]:.3e}: not a near tie")


def _requests(cfg, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (8, 11, 6, 14)]
    return [Request(uid=i, tokens=prompts[i], max_new_tokens=4 + 3 * i,
                    sampling=SamplingParams(temperature=0.8 if i % 2 else 0.0,
                                            top_k=8 if i % 2 else 0, seed=100 + i))
            for i in range(4)]


def test_engine_batched_equals_solo():
    """4 requests of different prompt/generation lengths through 2 slots:
    admissions and evictions interleave mid-stream, and every stream --
    greedy and sampled -- equals the same request served alone."""
    tcfg = torch_get_config("internlm2-1.8b_smoke")
    model = t_init_model(tcfg, TRCFG, seed=0, device="cpu")
    reqs = _requests(tcfg)
    eng = ServeEngine(tcfg, TRCFG, model, max_slots=2, max_len=64, decode_block=3)
    batched = eng.run(reqs)
    assert sorted(batched) == [0, 1, 2, 3]
    stats = eng.stats()
    assert stats["prefill_count"] == 4 and stats["nonfinite_logits"] == 0
    for req in reqs:
        assert len(batched[req.uid].tokens) == req.max_new_tokens
        solo = ServeEngine(tcfg, TRCFG, model, max_slots=2, max_len=64,
                           decode_block=3).run([req])[req.uid]
        assert solo.tokens == batched[req.uid].tokens, f"request {req.uid} diverged"


def test_engine_eos_and_stage_api_errors():
    tcfg = torch_get_config("internlm2-1.8b_smoke")
    model = t_init_model(tcfg, TRCFG, seed=0, device="cpu")
    prompt = list(range(5, 14))
    free = ServeEngine(tcfg, TRCFG, model, max_slots=1, max_len=32).run(
        [Request(uid=0, tokens=prompt, max_new_tokens=8)])[0]
    eos = free.tokens[2]
    eng = ServeEngine(tcfg, TRCFG, model, max_slots=1, max_len=32, decode_block=4)
    out = eng.run([Request(uid=0, tokens=prompt, max_new_tokens=8, eos_id=eos)])[0]
    assert out.finish_reason == "eos"
    assert out.tokens == free.tokens[: free.tokens.index(eos) + 1]
    prefix = eng.prefill(model, Request(uid=1, tokens=prompt, max_new_tokens=4))
    prefix.to_host()                      # the transferable (host) form
    eng.insert(prefix, eng.decode_state, 0)
    spliced = read_slot(eng.caches, 0)
    for got, want in zip(spliced, prefix.caches):
        for node_got, node_want in zip(got, want):
            for a, b in zip(node_got.tensors(), node_want.tensors()):
                assert torch.equal(a, b)
    assert int(spliced[0][0].slot_pos[0, 0].max()) == len(prompt) - 1
    with pytest.raises(ValueError, match="stale Prefix"):
        eng.insert(prefix, eng.decode_state, 0)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(Request(uid=2, tokens=prompt, max_new_tokens=40))


RANKS = Mesh(("data", "model"), (2, 1), groups={"data": object()}, sync_group=object())


@pytest.mark.parametrize("arch,kwargs,match", [
    ("internlm2-1.8b_smoke", {"mesh": RANKS}, "later multi-GPU serving slice"),
    ("llama-3.2-vision-11b_smoke", {}, "arch needs image_embeds"),
    ("recurrentgemma-9b_smoke", {"mesh": RANKS}, "later multi-GPU serving slice"),
])
def test_engine_refuses_later_slices(arch, kwargs, match):
    """What the port does not serve yet raises, naming the slice: a mesh of
    ranks (multi-GPU serving), also on a hybrid arch; a data mesh inside
    one process is served since the sharded-serving slice
    (tests/test_torch_sharded_serving.py). The xattn block kind is served
    since the xattn slice (tests/test_torch_xattn_serve.py): its engine
    refuses a request without image_embeds, with the JAX text. (Paged,
    compressed, prefix-shared and speculative serving are served since the
    paged-serving slice: tests/test_torch_{paging,kvquant,cow_spec}.py; moe
    since the MoE slice: tests/test_torch_moe.py; ssm since the ssm slice:
    tests/test_torch_ssm.py; rec and latt since the rec slice:
    tests/test_torch_rglru_serve.py.)"""
    if torch_get_config(arch).vision_tokens:
        cfg = torch_get_config(arch)
        eng = ServeEngine(cfg, TRCFG, t_init_model(cfg, TRCFG, seed=0, device="cpu"),
                          max_slots=1, max_len=16)
        with pytest.raises(ValueError, match=match):
            eng.submit(Request(uid=0, tokens=[1, 2, 3], max_new_tokens=2))
        return
    model = t_init_model(torch_get_config("internlm2-1.8b_smoke"), TRCFG, seed=0,
                         device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        ServeEngine(torch_get_config(arch), TRCFG, model, max_slots=1, max_len=16,
                    **kwargs)


def test_engine_with_a_plan_serves_the_same_tokens():
    """A compression plan routes prefill through site dispatch (as in the
    JAX engine); outputs are exact, so the tokens do not change."""
    tcfg = torch_get_config("internlm2-1.8b_smoke")
    model = t_init_model(tcfg, TRCFG, seed=0, device="cpu")
    reqs = lambda: [Request(uid=i, tokens=list(range(3 + i, 12 + i)), max_new_tokens=5)
                    for i in range(2)]
    plain = ServeEngine(tcfg, TRCFG, model, max_slots=2, max_len=24).run(reqs())
    planned = ServeEngine(tcfg, TRCFG, model, max_slots=2, max_len=24,
                          plan="attn.qkv=pamm(r=1/8);ffn.*=compact(r=1/4)").run(reqs())
    assert {u: r.tokens for u, r in plain.items()} == {u: r.tokens for u, r in planned.items()}


def test_cuda_requested_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = torch_get_config("internlm2-1.8b_smoke")
    with pytest.raises(RuntimeError, match="cuda"):
        t_init_model(tcfg, TRCFG, seed=0)          # the default device is cuda


def test_serve_cli_smoke_and_refusals(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "internlm2-1.8b_smoke", "--device", "cpu", "--batch", "2",
          "--requests", "3", "--prompt-len", "10", "--gen", "4",
          "--dtype", "bfloat16", "--temperature", "0.8", "--top-k", "5", "--smoke"])
    out = capsys.readouterr().out
    assert "SMOKE OK" in out and "prefill buckets" in out
    main(["--arch", "internlm2-1.8b_smoke", "--device", "cpu", "--batch", "2",
          "--requests", "2", "--prompt-len", "8", "--gen", "3",
          "--compression", "attn.qkv=pamm(r=1/8)"])
    assert "decode" in capsys.readouterr().out
    # replicas behind the router, with and without a dedicated prefill
    # engine, run on one device as in the reference
    for extra, front in (([], "router: 2 replicas |"),
                         (["--dedicated-prefill"], "router: 2 replicas + dedicated prefill |")):
        main(["--arch", "internlm2-1.8b_smoke", "--device", "cpu", "--batch", "2",
              "--requests", "4", "--prompt-len", "10", "--gen", "4",
              "--cache-layout", "paged", "--page-size", "8", "--replicas", "2", *extra,
              "--smoke"])
        out = capsys.readouterr().out
        assert "SMOKE OK" in out and front in out
        assert "peak aggregate concurrency 4" in out and "tok/s wall aggregate" in out
    # one engine's pools sharded over an in-process data mesh
    main(["--arch", "internlm2-1.8b_smoke", "--device", "cpu", "--batch", "2",
          "--requests", "4", "--prompt-len", "10", "--gen", "4",
          "--cache-layout", "paged", "--page-size", "8", "--mesh-data", "2", "--smoke"])
    out = capsys.readouterr().out
    assert "SMOKE OK" in out and "replica shards 2" in out
    # a mesh shards one engine, a router fronts several: not both; a
    # dedicated prefill engine needs a router, so it is refused alone
    for argv, msg in ((["--mesh-data", "2", "--replicas", "2"], "pick one"),
                      (["--dedicated-prefill"], "--dedicated-prefill needs --replicas > 1")):
        with pytest.raises(SystemExit) as exc:
            main(["--arch", "internlm2-1.8b_smoke", "--device", "cpu", *argv])
        assert exc.value.code == 2
        assert msg in capsys.readouterr().err


# ---------------------------------------------------------------------------
# sampling contract
# ---------------------------------------------------------------------------
def _sample(logits, seeds, idx, temp, topk):
    n = logits.shape[0]
    as_t = lambda x, dt: torch.as_tensor(x, dtype=dt).expand(n).clone()
    return sample_tokens(logits, as_t(seeds, torch.int64), as_t(idx, torch.int64),
                         as_t(temp, torch.float32), as_t(topk, torch.int64))


def test_sampling_draw_is_a_function_of_seed_and_index():
    """The same (seed, token index) gives the same draw whatever the row,
    the batch around it, or the call; the uniforms differ between seeds."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(1, 40, generator=g).expand(4, 40).clone()
    a = _sample(logits, [7, 7, 8, 7], [3, 3, 3, 4], 0.9, 0)
    assert int(a[0]) == int(a[1])
    alone = _sample(logits[:1], 7, 3, 0.9, 0)
    assert int(alone[0]) == int(a[0])
    again = _sample(logits[[3, 0]], [9, 7], [1, 3], 0.9, 0)
    assert int(again[1]) == int(a[0])
    u = uniform_bits(torch.tensor([7, 7, 8, 7]), torch.tensor([3, 3, 3, 4]), 40)
    assert torch.equal(u[0], u[1])
    assert not torch.equal(u[0], u[2]) and not torch.equal(u[0], u[3])
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0


def test_sampling_greedy_rows_are_argmax():
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(6, 33, generator=g)
    temps = torch.tensor([0.0, 1.0, 0.0, 0.7, 0.0, 0.0])
    toks = sample_tokens(logits, torch.arange(6), torch.zeros(6, dtype=torch.long),
                         temps, torch.zeros(6, dtype=torch.long))
    greedy = temps <= 0
    assert torch.equal(toks[greedy], logits.argmax(-1)[greedy])
    fast = sample_tokens(logits, torch.arange(6), torch.zeros(6, dtype=torch.long),
                         torch.zeros(6), torch.zeros(6, dtype=torch.long),
                         any_sampling=False)
    assert torch.equal(fast, logits.argmax(-1))


def test_sampling_top_k_keeps_exactly_k_lowest_index_ties():
    draws, V = 256, 12
    toks = _sample(torch.zeros(draws, V), torch.arange(draws), 0, 1.0, 3)
    assert set(toks.tolist()) == {0, 1, 2}
    row = torch.zeros(draws, V)
    row[:, [0, 1, 3]] = 5.0
    row[:, 2] = 1.0
    toks = _sample(row, torch.arange(draws), 0, 1.0, 2)
    assert set(toks.tolist()) <= {0, 1}
    logits = torch.randn(64, 50, generator=torch.Generator().manual_seed(3))
    toks = _sample(logits, torch.arange(64), 5, 1.5, 5)
    top5 = logits.topk(5, dim=-1).indices
    assert all(int(t) in top5[b].tolist() for b, t in enumerate(toks))


def test_sampling_frequencies_follow_the_softmax():
    """4000 independent (seed) draws from softmax(logits / T) land within
    0.03 of the distribution (about 5 standard errors)."""
    n = 4000
    logits = torch.tensor([[1.0, 0.0, -1.0, 0.5]]).expand(n, 4).clone()
    toks = _sample(logits, torch.arange(n), 0, 0.8, 0)
    freq = torch.bincount(toks, minlength=4).double() / n
    want = torch.softmax(logits[0].double() / 0.8, dim=-1)
    assert torch.allclose(freq, want, atol=0.03), (freq, want)
