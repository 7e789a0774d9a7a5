"""The port's serving entry points outside the engine loop
(``repro_torch.train.serve_step``) against the JAX package's, on the CPU,
in f32 with bridged parameters on internlm2-1.8b_smoke:

* ``greedy_decode`` (the engine's decode blocks) equals
  ``greedy_decode_per_token`` (one batched prefill, then a Python loop of
  ``decode_step``), as tests/test_serving.py holds the reference;
* both equal JAX's ``greedy_decode`` up to a near tie (a row may diverge
  only where the JAX top-2 logit margin is below 1e-4), shape (B, steps);
* ``make_prefill`` / ``make_decode_step`` are the model functions;
* embed-input and vision archs are refused, naming the later slice.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, get_config
from repro.data import SyntheticStream
from repro.models import forward, init_model
from repro.train.serve_step import greedy_decode as jax_greedy_decode
from repro_torch import bridge
from repro_torch.configs import RunConfig as TorchRunConfig
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import decode_step, prefill
from repro_torch.train import (greedy_decode, greedy_decode_per_token, make_decode_step,
                               make_prefill)

ARCH = "internlm2-1.8b_smoke"
RCFG = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
TRCFG = TorchRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def models():
    cfg = get_config(ARCH)
    params, _ = init_model(cfg, RCFG, jax.random.key(0))
    tcfg = torch_get_config(ARCH)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


def _tokens(cfg, B, L):
    return np.asarray(SyntheticStream.for_arch(cfg, L, B).get_batch(0)["tokens"])


def _jax_margin(cfg, params, seq) -> float:
    batch = {"tokens": jnp.asarray(seq, jnp.int32)[None],
             "labels": jnp.zeros((1, len(seq)), jnp.int32)}
    h, _ = forward(cfg, RCFG, None, params, batch, jax.random.key(2))
    row = np.asarray((h[0, -1] @ params["head"]).astype(jnp.float32))[: cfg.vocab_size]
    top2 = np.sort(row)[-2:]
    return float(top2[1] - top2[0])


@pytest.mark.parametrize("B,L,steps", [(2, 16, 8), (3, 12, 5)])
def test_greedy_decode_fused_equals_per_token_and_jax(models, B, L, steps):
    cfg, params, tcfg, model = models
    toks = _tokens(cfg, B, L)
    max_len = L + steps + 8
    fused = greedy_decode(tcfg, TRCFG, model, {"tokens": torch.from_numpy(toks)},
                          steps=steps, max_len=max_len)
    loop = greedy_decode_per_token(tcfg, TRCFG, model, {"tokens": torch.from_numpy(toks)},
                                   steps=steps, max_len=max_len)
    assert fused.shape == loop.shape == (B, steps)
    assert fused.dtype == loop.dtype == torch.int64
    assert torch.equal(fused, loop)
    want = np.asarray(jax_greedy_decode(cfg, RCFG, params, {"tokens": jnp.asarray(toks)},
                                        steps=steps, max_len=max_len))
    assert want.shape == (B, steps)
    got = fused.numpy()
    for b in range(B):
        diff = np.nonzero(want[b] != got[b])[0]
        if diff.size:
            t = int(diff[0])
            margin = _jax_margin(cfg, params, toks[b].tolist() + want[b, :t].tolist())
            assert margin < NEAR_TIE, f"row {b} diverged at token {t}, margin {margin:.3e}"


def test_make_prefill_and_decode_step_are_the_model_functions(models):
    _, _, tcfg, model = models
    toks = torch.from_numpy(_tokens(tcfg, 2, 10)).long()
    l0, c0 = make_prefill(tcfg, TRCFG, max_len=16)(model, {"tokens": toks})
    l1, c1 = prefill(tcfg, TRCFG, model, {"tokens": toks}, 16)
    assert torch.equal(l0, l1)
    tok = l0[:, -1, : tcfg.vocab_size].argmax(-1)[:, None]
    pos = torch.full((2, 1), 10, dtype=torch.int32)
    s0, _ = make_decode_step(tcfg, TRCFG)(model, tok, pos, c0)
    s1, _ = decode_step(tcfg, TRCFG, model, tok, pos, c1)
    assert torch.equal(s0, s1)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b_smoke", "musicgen-medium_smoke"])
def test_greedy_decode_refuses_later_slice_frontends(arch):
    tcfg = torch_get_config(arch)
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
    for fn in (greedy_decode, greedy_decode_per_token):
        with pytest.raises(NotImplementedError, match="later slices"):
            fn(tcfg, TRCFG, None, batch, steps=2, max_len=8)
