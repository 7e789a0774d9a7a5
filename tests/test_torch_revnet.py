"""Reversible two-stream blocks in the port (``block_structure=
'reversible'``, one ``autograd.Function`` per stage, and
``'reversible_ref'``, the same math under plain autograd) on the CPU
against the JAX package's ``reversible_stage`` and against each other,
with the same parameters and draws (``JaxSampler``); the backward's
rebuilt streams against the forward's; what the graph saves; and the
refusals.

Tolerances, measured afresh on these shapes (f32, seq 64 x batch 4):
against JAX, loss 1e-5 absolute and gradients 1e-4 relative (norm), as in
``test_torch_training.py`` -- measured 1.6e-6 to 2.3e-6; ``reversible``
against ``reversible_ref``, the JAX package's own contract, loss 1e-6
relative and every gradient 1e-4 relative (max |diff| over max |ref| per
leaf) -- measured about 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import SyntheticStream
from repro_torch.configs import RunConfig, get_config
from repro_torch.core.keys import Key
from repro_torch.models import blocks as blk
from repro_torch.models import decode_step, init_model, loss_fn, prefill
from repro_torch.train import make_train_step
from tests.test_torch_remat import (SPEC, check_against_jax, cut_depth, port_loss_grads,
                                    saved_bytes, setup)

ARCHS = ["llama-tiny", "internlm2-1.8b_smoke"]


def worst_rel(grads: dict, ref: dict) -> float:
    """Per-leaf max |a - b| / max |b|, maximised over leaves."""
    return max(float((g - ref[n]).abs().max() / (ref[n].abs().max() + 1e-30))
               for n, g in grads.items())


@pytest.mark.parametrize("structure", ["reversible", "reversible_ref"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reversible_matches_jax_and_the_reference_structure(arch, structure):
    """Loss, every gradient and the site telemetry against JAX under the
    same structure; ``reversible`` also against ``reversible_ref``. K1
    runs twice a site a layer under ``reversible`` (the forward compresses
    for the telemetry, the backward's recompute for the gradient), once
    under ``reversible_ref``; K3 twice / once a layer."""
    jr, tr, params, batch, model = setup(arch, block_structure=structure)
    loss, grads, sites, counts = check_against_jax(arch, tr, jr, params, batch, model)
    n = get_config(arch).n_layers
    twice = 2 if structure == "reversible" else 1
    assert counts == {"csim_argmax_ref": twice * n, "segment_matmul_ref": 3 * n,
                      "flash_attention_fwd_ref": twice * n, "flash_attention_bwd_ref": n}
    if structure == "reversible":
        loss_r, grads_r, sites_r, _ = port_loss_grads(
            arch, dataclasses.replace(tr, block_structure="reversible_ref"), model, batch)
        assert float(loss) == pytest.approx(float(loss_r), rel=1e-6)
        assert worst_rel(grads, grads_r) < 1e-4
        for path, v in sites_r.items():
            assert torch.equal(sites[path], v), path


def _record_streams(monkeypatch, dtype):
    """One loss and backward of llama-tiny under ``reversible`` with every
    ``_dd_add`` recorded as (hi, lo, b, out_hi, out_lo): the forward's
    2 x layers calls, then the backward's."""
    calls = []
    real = blk._dd_add

    def recording(hi, lo, b):
        out = real(hi, lo, b)
        calls.append([t.detach().clone() for t in (hi, lo, b, *out)])
        return out

    monkeypatch.setattr(blk, "_dd_add", recording)
    cfg = get_config("llama-tiny")
    rcfg = RunConfig(compression=SPEC, policy_name="none", compute_dtype=dtype,
                     param_dtype="float32", loss_chunk=16, block_structure="reversible")
    model = init_model(cfg, rcfg, seed=0, device="cpu")
    b = SyntheticStream.for_arch(cfg, 64, 4).get_batch(0)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    loss, _ = loss_fn(cfg, rcfg, None, model, tb, Key(3))
    n = cfg.n_layers
    assert len(calls) == 2 * n
    torch.autograd.grad(loss, list(model.parameters()))
    assert len(calls) == 4 * n
    fwd, bwd = calls[:2 * n], calls[2 * n:]
    # layer r: forward y1 = x1 + F(x2), y2 = x2 + G(y1); its backward
    # rebuilds x2 = y2 - G(y1), then x1 = y1 - F(x2)
    return [(fwd[2 * r], fwd[2 * r + 1], bwd[2 * (n - 1 - r)], bwd[2 * (n - 1 - r) + 1])
            for r in range(n)]


def test_backward_rebuilds_the_forward_streams_bit_for_bit(monkeypatch):
    """f32: every layer input the backward rebuilds equals the forward's,
    hi and lo, bit for bit, and every recomputed sublayer output (one call
    that is both the reconstruction and the vjp's primal) equals the
    forward's."""
    for r, (a, b, c, d) in enumerate(_record_streams(monkeypatch, "float32")):
        x1h, x1l, f = a[:3]
        x2h, x2l, g = b[:3]
        assert torch.equal(c[2], -g) and torch.equal(d[2], -f), r
        assert torch.equal(c[3], x2h) and torch.equal(c[4], x2l), r
        assert torch.equal(d[3], x1h) and torch.equal(d[4], x1l), r


def test_bf16_streams_rebuild_to_the_compensated_precision_only(monkeypatch):
    """bf16 compute (the card's): the top layer's G recompute is the
    forward's bit for bit, but the compensated pair is 16 bits, so its
    rebuilt x2 agrees only to about 2^-16 of the stream (measured 6e-6
    relative) and a few elements' hi differ. F turns such a difference
    into a bf16 rounding of its output, and the layers below inherit it:
    the deeper streams, and the gradients there, drift. The JAX package
    drifts the same way (``reversible`` against ``reversible_ref`` on
    llama-tiny in bf16: worst gradient 1.7 relative in JAX, 0.84 here);
    only f32 rebuilds bit for bit."""
    layers = _record_streams(monkeypatch, "bfloat16")
    top_x2, top_g, rebuilt = layers[-1][1], layers[-1][1][2], layers[-1][2]
    assert torch.equal(rebuilt[2], -top_g)
    pair = lambda h, l: h.float() + l.float()
    err = (pair(rebuilt[3], rebuilt[4]) - pair(top_x2[0], top_x2[1])).abs().max()
    assert float(err) <= 2.0 ** -16 * float(top_x2[0].float().abs().max())


def test_reversible_saves_no_activation_per_layer():
    """What the graph keeps besides the parameters does not grow with
    depth under ``reversible`` (2 against 4 layers: the output streams
    only); under ``reversible_ref`` it does."""
    out = {}
    for structure in ("reversible", "reversible_ref"):
        for layers in (2, 4):
            rcfg = RunConfig(compression=SPEC, policy_name="none", compute_dtype="float32",
                             param_dtype="float32", loss_chunk=16, block_structure=structure)
            packed, states, n_states, _ = saved_bytes(cut_depth("llama-tiny", layers), rcfg)
            assert states == n_states == 0
            out[structure, layers] = packed
    assert out["reversible", 2] == out["reversible", 4]
    assert out["reversible_ref", 4] - out["reversible_ref", 2] > 2 * 2 * 32 * 128 * 4


def test_reversible_trains_on_the_cpu():
    """make_train_step under reversible: finite losses that fall."""
    cfg = get_config("internlm2-1.8b_smoke")
    rcfg = RunConfig(compression=SPEC, policy_name="none", compute_dtype="float32",
                     param_dtype="float32", block_structure="reversible", lr=5e-3)
    from repro_torch.train import init_train_state

    state = init_train_state(cfg, rcfg, device="cpu")
    step = make_train_step(cfg, rcfg, total_steps=8)
    stream = SyntheticStream.for_arch(cfg, 16, 4, seed=0)
    losses = []
    for i in range(8):
        state, m = step(state, stream.get_batch(i), i)
        losses.append(float(m["nll"]))
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


REFUSALS = {
    "remat_full": ("llama-tiny", dict(block_structure="reversible", remat="full"),
                   ValueError, "remat"),
    "remat_pamm": ("llama-tiny", dict(block_structure="reversible_ref", remat="pamm"),
                   ValueError, "remat"),
    "unknown_structure": ("llama-tiny", dict(block_structure="bogus"), ValueError,
                          "block_structure"),
    "unknown_remat": ("llama-tiny", dict(remat="some"), ValueError, "remat"),
    "ssm": ("mamba2-370m_smoke", dict(block_structure="reversible"), ValueError, "ssm"),
    "xattn": ("llama-3.2-vision-11b_smoke", dict(block_structure="reversible"), ValueError,
              "xattn"),
    "moe": ("granite-moe-3b-a800m_smoke", dict(block_structure="reversible", remat="pamm"),
            ValueError, "remat"),
    "rec": ("recurrentgemma-9b_smoke", dict(block_structure="reversible", remat="full"),
            ValueError, "remat"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_config_time_refusals(case):
    """The JAX package's checks and texts (remat x reversible, also on a
    moe arch, whose reversible stack trains since the MoE slice, and on
    recurrentgemma's rec / latt stack, since the rec slice; an unknown
    structure, kinds without an F/G split)."""
    arch, kw, exc, match = REFUSALS[case]
    with pytest.raises(exc, match=match):
        make_train_step(get_config(arch), RunConfig(compression="", **kw))


@pytest.mark.parametrize("entry", ["prefill", "decode_step"])
def test_serving_paths_refuse_reversible(entry):
    cfg = get_config("llama-tiny")
    rcfg = RunConfig(compression="", compute_dtype="float32", param_dtype="float32",
                     block_structure="reversible")
    model = init_model(cfg, rcfg, seed=0, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="reversible"):
        if entry == "prefill":
            prefill(cfg, rcfg, model, {"tokens": tok}, 16)
        else:
            decode_step(cfg, rcfg, model, tok, tok, None)
