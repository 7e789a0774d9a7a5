"""musicgen's embed-input, four-codebook frontend in the port on the CPU,
against the JAX package, on musicgen-medium_smoke (2 attn layers, d 64,
4 / 4 heads of 16, vocab 64, 4 codebooks) in f32 with bridged parameters:

* the parameter tree (no ``embed`` leaf, head (d, 4 x vocab)), the bridge,
  the optimizer state and the train-state tree, and the data stream;
* ``loss_fn``: loss, NLL, every gradient and the site telemetry, exact,
  under ``attn.qkv`` PAMM, under ``remat`` full / pamm, under reversible
  blocks, and under a ``lm_head`` rule (one compression per codebook and
  chunk, from the key ``fold_in(0x1EAD).fold_in(c).fold_in(chunk)``, the
  stats summed), the JAX draws replayed by ``JaxSampler``;
* ``prefill`` and ``decode_step`` over embeddings against the JAX
  package's and against the port's own full forward;
* one train step, the checkpoint both ways, the training CLI, and the
  serving engine's refusals.

Tolerances (f32): loss 1e-5 absolute, gradients 1e-4 relative (norm of
the difference over the JAX gradient's norm; reversible included, the
bound of ``test_torch_revnet.py``) and telemetry 1e-6 relative, as in
``test_torch_remat.py``;
logits rtol 1e-4 / atol 1e-5 against JAX, as in ``test_torch_serving.py``,
and 1e-3 against the full forward, the JAX package's own bound
(``tests/test_models_smoke.py``); parameters and moments after a step 1e-5
relative per leaf, a zero-initialised leaf 1e-2 x lr per element, as in
``test_torch_training.py``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load as jax_load
from repro.checkpoint import save as jax_save
from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.data import SyntheticStream as JaxStream
from repro.models import decode_step as jax_decode_step
from repro.models import init_model as jax_init_model
from repro.models import prefill as jax_prefill
from repro.optim import optimizers as jax_optim
from repro.serve import ServeEngine as JaxEngine
from repro.train import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.checkpoint import load, save
from repro_torch.configs import RunConfig, get_config
from repro_torch.core.keys import Key
from repro_torch.data import SyntheticStream
from repro_torch.models import decode_step, forward, init_model, prefill
from repro_torch.serve import ServeEngine
from repro_torch.train import TrainState, init_train_state, make_train_step
from tests import test_torch_remat as remat_tests
from tests.test_torch_linear import JaxSampler
from tests.test_torch_remat import check_against_jax, flat_tree, rel

ARCH = "musicgen-medium_smoke"
QKV = "attn.qkv=pamm(r=1/8)"
SEQ, BATCH, CHUNK = 32, 2, 16          # two loss chunks a codebook
N_CODEBOOKS = 4
F32 = dict(compute_dtype="float32", param_dtype="float32")


def setup(spec=QKV, **kw):
    """JAX and port run configs, JAX parameters, one stream batch and the
    port model holding the same parameters."""
    common = dict(compression=spec, policy_name="none", loss_chunk=CHUNK, **F32, **kw)
    jr, tr = JaxRunConfig(attn_kernel="jnp", **common), RunConfig(**common)
    params, _ = jax_init_model(jax_get_config(ARCH), jr, jax.random.key(0))
    batch = JaxStream.for_arch(jax_get_config(ARCH), SEQ, BATCH).get_batch(0)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), get_config(ARCH),
                                   device="cpu", trainable=True)
    return jr, tr, params, batch, model


# ---------------------------------------------------------------------------
# the tree, the bridge, the stream
# ---------------------------------------------------------------------------
def test_tree_bridge_and_stream_match_jax():
    """init_model has the JAX tree's names and shapes: no ``embed`` leaf,
    head (d, vocab x 4), not padded; the bridge gives the tree back bit
    for bit; the AdamW state goes both ways; ``train_state_tree`` has the
    JAX TrainState's paths; the port's stream equals the JAX stream
    (embeddings from codebook 0's tokens, labels (B, L, 4))."""
    cfg = get_config(ARCH)
    jr = JaxRunConfig(compression="", pad_vocab_multiple=128)
    jstate, _ = jax_init_train_state(jax_get_config(ARCH), jr, jax.random.key(0))
    params = jax.tree.map(np.asarray, jstate.params)
    assert "embed" not in params
    port = init_model(cfg, RunConfig(pad_vocab_multiple=128), seed=0, device="cpu")
    shapes = {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert shapes == {k: v.shape for k, v in flat_tree(params).items()}
    assert port.embed is None
    assert shapes["head"] == (cfg.d_model, N_CODEBOOKS * cfg.vocab_size)

    model = bridge.from_jax_params(params, cfg, device="cpu")
    back = bridge.to_jax_params(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    m = jax.tree.map(lambda p: np.full(p.shape, 0.5, np.float32), params)
    v = jax.tree.map(lambda p: np.full(p.shape, 0.25, np.float32), params)
    opt = bridge.opt_state_from_jax(np.int32(3), m, v, model)
    assert opt.step == 3 and set(opt.m) == set(shapes)
    step, m2, v2 = bridge.opt_state_to_jax(opt, model)
    assert int(step) == 3 and jax.tree.structure(m2) == jax.tree.structure(m)
    for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(v2)):
        np.testing.assert_array_equal(a, b)
    state = init_train_state(cfg, RunConfig(compression=""), device="cpu", seed=1)
    paths = lambda t: [jax.tree_util.keystr(p) for p, _ in
                       jax.tree_util.tree_flatten_with_path(t)[0]]
    assert paths(bridge.train_state_tree(state)) == paths(jstate)

    for step in (0, 5):
        want = JaxStream.for_arch(jax_get_config(ARCH), SEQ, BATCH, seed=2).get_batch(step)
        got = SyntheticStream.for_arch(cfg, SEQ, BATCH, seed=2).get_batch(step)
        assert sorted(got) == sorted(want) == ["embeds", "labels", "mask"]
        assert got["labels"].shape == (BATCH, SEQ, N_CODEBOOKS)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------
HEAD = f"{QKV};lm_head=pamm(r=1/8)"
# name: (plan, run config fields, K1 launches, K3 launches) per layer; the
# lm_head rule adds one K1 and one K2 a codebook and chunk
CASES = {
    "exact": ("", {}, 0, 1),
    "attn.qkv": (QKV, {}, 1, 1),
    "remat full": (QKV, {"remat": "full"}, 2, 2),
    "remat pamm": (QKV, {"remat": "pamm"}, 1, 2),
    "reversible": (QKV, {"block_structure": "reversible"}, 2, 2),
    "lm_head": (HEAD, {}, 1, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_jax(case, monkeypatch):
    """Loss, NLL, every gradient (the head's four column blocks in the one
    ``head`` leaf) and the telemetry against the JAX ``loss_fn``; the
    launch counts of the plain kernel versions. Under ``lm_head`` the
    head's draws come from the per-codebook key chain, and the site's
    stats are summed over 4 codebooks x 2 chunks."""
    spec, kw, k1, k3 = CASES[case]
    paths = []

    class Recording(JaxSampler):
        def choice(self, seed, path, b, k, device):
            paths.append(path)
            return super().choice(seed, path, b, k, device)

    monkeypatch.setattr(remat_tests, "JaxSampler", Recording)
    jr, tr, params, batch, model = setup(spec, **kw)
    loss, grads, sites, counts = check_against_jax(ARCH, tr, jr, params, batch, model)
    n = get_config(ARCH).n_layers
    head_calls = N_CODEBOOKS * SEQ // CHUNK if case == "lm_head" else 0
    want = {"csim_argmax_ref": k1 * n + head_calls,
            "segment_matmul_ref": (3 * n if spec else 0) + head_calls,
            "flash_attention_fwd_ref": k3 * n, "flash_attention_bwd_ref": n}
    assert counts == {k: c for k, c in want.items() if c}
    assert grads["head"].shape == (64, N_CODEBOOKS * 64) and "embed" not in grads
    assert all(bool(g.abs().sum() > 0) for g in grads["head"].split(64, dim=1))
    if case == "lm_head":
        assert sites["lm_head"][4].item() == head_calls
        head_paths = sorted(p[:3] for p in paths if p[0] == ("fold_in", 0x1EAD))
        assert head_paths == [(("fold_in", 0x1EAD), ("fold_in", c), ("fold_in", ch))
                              for c in range(N_CODEBOOKS) for ch in range(SEQ // CHUNK)]
    else:
        assert "lm_head" not in sites


# ---------------------------------------------------------------------------
# scoring and decode
# ---------------------------------------------------------------------------
def test_prefill_and_decode_over_embeddings_match_jax_and_the_full_forward():
    """Prefill over 16 embeddings, then three decode steps each fed the
    next embedding (B, 1, d): logits (B, 1, 4 x vocab) against the JAX
    package's prefill / decode_step and against the port's own full
    forward at the same positions."""
    jr, tr, params, _, model = setup("")
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    B, L, steps, max_len = 2, 16, 3, 32
    embeds = (np.random.default_rng(1).standard_normal((B, L + steps, cfg.d_model))
              * 0.3).astype(np.float32)
    full = {"embeds": torch.from_numpy(embeds),
            "labels": torch.zeros((B, L + steps, N_CODEBOOKS), dtype=torch.int64)}
    with torch.no_grad():
        h, _ = forward(cfg, tr, "", model, full, Key(2))
        want = (h @ model.head).numpy()
    close = lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                    rtol=1e-4, atol=1e-5)
    lj, cj = jax_prefill(jcfg, jr, params, {"embeds": jnp.asarray(embeds[:, :L])}, max_len)
    lt, ct = prefill(cfg, tr, model, {"embeds": torch.from_numpy(embeds[:, :L])}, max_len)
    assert lt.shape == (B, 1, N_CODEBOOKS * cfg.vocab_size)
    close(lj, lt.numpy())
    assert np.abs(lt.numpy()[:, 0] - want[:, L - 1]).max() < 1e-3
    for i in range(steps):
        x = embeds[:, L + i:L + i + 1]
        pos = np.full((B, 1), L + i, np.int32)
        lj, cj = jax_decode_step(jcfg, jr, params, jnp.asarray(x), jnp.asarray(pos), cj)
        lt, ct = decode_step(cfg, tr, model, torch.from_numpy(x), torch.from_numpy(pos), ct)
        close(lj, lt.numpy())
        assert np.abs(lt.numpy()[:, 0] - want[:, L + i]).max() < 1e-3


# ---------------------------------------------------------------------------
# training state
# ---------------------------------------------------------------------------
def test_train_step_matches_jax():
    """One make_train_step under attn.qkv PAMM: metrics, updated
    parameters and AdamW moments against one JAX train step."""
    jr, tr, params, batch, model = setup(QKV, weight_decay=0.01)
    batch = JaxStream.for_arch(jax_get_config(ARCH), SEQ, 4).get_batch(0)
    state_j, _ = jax_init_train_state(jax_get_config(ARCH), jr, jax.random.key(0))
    step_j = jax.jit(jax_make_train_step(jax_get_config(ARCH), jr, total_steps=10))
    state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()},
                          jnp.int32(3))
    opt = bridge.opt_state_from_jax(*jax.tree.map(np.asarray, jax_optim.adamw_init(params)),
                                    model)
    step = make_train_step(get_config(ARCH), tr, total_steps=10, sampler=JaxSampler())
    state, m = step(TrainState(model, opt), batch, 3)
    for k in ("loss", "nll", "grad_norm", "lr"):
        assert abs(float(m[k]) - float(m_j[k])) <= 1e-5 * max(1.0, abs(float(m_j[k]))), k
    assert set(m) == set(m_j)
    step_n, mom1, mom2 = bridge.opt_state_to_jax(state.opt, state.params)
    assert step_n == int(state_j.opt.step) == 1
    before = flat_tree(params)
    for mine, theirs in ((bridge.to_jax_params(state.params), state_j.params),
                         (mom1, state_j.opt.m), (mom2, state_j.opt.v)):
        a, b = flat_tree(mine), flat_tree(theirs)
        assert set(a) == set(b)
        for name in b:
            if theirs is state_j.params and not before[name].any():
                assert np.abs(a[name] - b[name]).max() <= 1e-2 * float(m_j["lr"]), name
            else:
                assert rel(a[name], b[name]) < 1e-5, name


def test_checkpoint_both_ways(tmp_path):
    """A musicgen TrainState with bf16 parameters saved by the JAX
    checkpointer loads into the port; the port saves it, the JAX
    checkpointer loads that: every leaf equal, bf16 kept, no embed."""
    jr = JaxRunConfig(compression="", param_dtype="bfloat16")
    jstate, _ = jax_init_train_state(jax_get_config(ARCH), jr, jax.random.key(0))
    jstate = jstate._replace(opt=jstate.opt._replace(
        step=jnp.int32(5), m=jax.tree.map(lambda p: jnp.full(p.shape, 0.25, jnp.float32),
                                          jstate.params)))
    jax_save(str(tmp_path / "jax"), 5, jstate)
    port = init_train_state(get_config(ARCH), RunConfig(compression="",
                                                        param_dtype="bfloat16"),
                            device="cpu", seed=9)
    tree_, step = load(str(tmp_path / "jax"), bridge.train_state_tree(port))
    port = bridge.install_train_state_tree(port, tree_)
    assert step == 5 and port.opt.step == 5 and port.params.embed is None
    assert port.params.head.dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.to_jax_params(port.params)["head"].view(np.uint16),
                                  np.asarray(jstate.params["head"]).view(np.uint16))
    save(str(tmp_path / "port"), 6, bridge.train_state_tree(port))
    back, step = jax_load(str(tmp_path / "port"), jstate)
    assert step == 6
    flat = lambda s: {jax.tree_util.keystr(p): np.asarray(v, np.float32)
                      for p, v in jax.tree_util.tree_flatten_with_path(s)[0]}
    for (k, a), b in zip(flat(jstate).items(), flat(back).values()):
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert back.params["head"].dtype == jnp.bfloat16


# ---------------------------------------------------------------------------
# front ends
# ---------------------------------------------------------------------------
def test_train_cli_trains_from_embeddings_and_four_codebooks(capsys, tmp_path):
    """The training CLI on musicgen smoke under both rules, then under the
    checkpoint/restart supervisor: a second run resumes from the last
    checkpoint of the tree without ``embed``."""
    from repro_torch.launch import train

    common = ["--arch", ARCH, "--device", "cpu", "--seq-len", "16", "--global-batch", "2",
              "--log-every", "1", "--compression", HEAD]
    train.main([*common, "--steps", "3"])
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "done: 3 steps" in out and "device cpu" in out
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    train.main([*common, "--steps", "3", *ck])
    assert "completed_steps=3" in capsys.readouterr().out
    train.main([*common, "--steps", "4", *ck])
    out = capsys.readouterr().out
    assert out.count("step ") == 1 and "completed_steps=1" in out


@pytest.mark.parametrize("embed_inputs", [True, False])
def test_engine_refuses_with_the_jax_texts(embed_inputs):
    """The serving engine refuses an embed-input arch, and a multi-codebook
    head alone, with the JAX engine's texts."""
    jcfg = dataclasses.replace(jax_get_config(ARCH), embed_inputs=embed_inputs)
    tcfg = dataclasses.replace(get_config(ARCH), embed_inputs=embed_inputs)
    with pytest.raises(NotImplementedError) as want:
        JaxEngine(jcfg, JaxRunConfig(), None, max_slots=1, max_len=8)
    with pytest.raises(NotImplementedError) as got:
        ServeEngine(tcfg, RunConfig(), None, max_slots=1, max_len=8)
    assert str(got.value) == str(want.value)
