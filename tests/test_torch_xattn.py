"""The xattn block kind (gated cross-attention over image embeddings,
llama-3.2-vision) in the port on the CPU, against the JAX package:
``cross_attn`` (its output and the image K/V it returns) and
``cross_attn_decode`` (K6 non-causal, against the JAX Pallas kernel in
interpret mode and against its jnp reference); K6's plain version against
the JAX ``flash_decode_kernel(causal=False)`` at 16 and 300 slots; one
xattn block's gradients, exact and under ``attn.*`` PAMM; vision-smoke
training in every remat mode, with the ``attn.cross_kv`` site's telemetry
and launch counts. Serving (prefill, decode, the engine) is in
``test_torch_xattn_serve.py``.

Both gates start at zero, which makes an xattn block the identity, so
every test sets them to nonzero values (:data:`GATES`) in the numpy tree
before it is bridged into both packages. Inputs are seeded numpy, f32;
the JAX draws reach the port through ``JaxSampler``.

Tolerances (f32): cross_attn and cross_attn_decode max abs error 1e-5 x
max |ref| (the same einsums in another order; measured about 1e-7); K6's
plain version against the JAX kernel per row 1e-5 of the row's max, as in
``test_torch_attention_kernels.py``; the block's gradients 1e-4 relative
per leaf (norm of the difference over the JAX gradient's norm), as in
``test_torch_rglru.py``; loss 1e-5 absolute, gradients 1e-4 relative and
telemetry 1e-6 relative, as in ``test_torch_remat.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.core import plan as jax_plan
from repro.data import SyntheticStream
from repro.kernels.flash_decode import flash_decode_kernel as jax_flash_decode_kernel
from repro.models import attention as jax_attn
from repro.models import blocks as jax_blocks
from repro.models import init_model as jax_init_model
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config
from repro_torch.core import plan as plan_lib
from repro_torch.core.keys import Key
from repro_torch.core.plan import exact_ctx
from repro_torch.kernels import flash_decode as fd
from repro_torch.models import attention as attn_lib
from repro_torch.models import blocks as blk
from tests.test_torch_linear import JaxSampler
from tests.test_torch_remat import check_against_jax, rel

ARCH = "llama-3.2-vision-11b_smoke"
SPEC = "attn.*=pamm(r=1/8)"
GATES = {"gate_attn": 0.5, "gate_ffn": -0.75}
JR = JaxRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")
TR = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none")


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def set_gates(node: dict) -> dict:
    """An xattn block's numpy tree with both gates filled from GATES (any
    leading layer axis kept)."""
    node["attn"]["gate_attn"] = np.full_like(node["attn"]["gate_attn"], GATES["gate_attn"])
    node["gate_ffn"] = np.full_like(node["gate_ffn"], GATES["gate_ffn"])
    return node


def gated_params(jr=JR, arch=ARCH) -> dict:
    """The JAX model's parameters as numpy, every xattn block's gates set."""
    cfg = jax_get_config(arch)
    params, _ = jax_init_model(cfg, jr, jax.random.key(0))
    pn = jax.tree.map(np.asarray, params)
    for (unit, _), stage in zip(cfg.stages, pn["stages"]):
        for kind, node in zip(unit, stage):
            if kind == "xattn":
                set_gates(node)
    return pn


def models(arch=ARCH):
    """(JAX cfg, JAX params, port cfg, port model) in f32, gates set."""
    pn = gated_params(JR, arch)
    tcfg = get_config(arch)
    return (jax_get_config(arch), jax.tree.map(jnp.asarray, pn), tcfg,
            bridge.from_jax_params(pn, tcfg, device="cpu"))


def images(B, cfg, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)


def _block_params(seed=1) -> dict:
    pj, _ = jax_blocks.init_block("xattn", jax_get_config(ARCH), jax.random.key(seed),
                                  jnp.float32)
    return set_gates(jax.tree.map(np.asarray, pj))


def _max_err_ok(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# ---------------------------------------------------------------------------
# the attention functions and K6 non-causal
# ---------------------------------------------------------------------------
def test_init_adds_zero_gates_in_the_jax_layout():
    """init_block('xattn') has the JAX tree's names, shapes and dtypes, the
    two scalar gates included, and both gates start at zero."""
    cfg = get_config(ARCH)
    pt = blk.init_block("xattn", cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    pj, _ = jax_blocks.init_block("xattn", jax_get_config(ARCH), jax.random.key(0),
                                  jnp.bfloat16)
    flat = lambda tree: {jax.tree_util.keystr(p): tuple(v.shape)
                         for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert flat(pt) == flat(pj)
    assert pt["gate_ffn"].shape == () and pt["attn"]["gate_attn"].shape == ()
    assert float(pt["gate_ffn"]) == float(pt["attn"]["gate_attn"]) == 0.0
    assert pt["gate_ffn"].dtype == torch.bfloat16


@pytest.mark.parametrize("Lq", [1, 9, 24])
def test_cross_attn_matches_jax(Lq):
    """Output and the image K/V over 16 image tokens, with a query chunk
    of 8 (Lq 24 runs three chunks, Lq 9 a ragged one)."""
    pn = _block_params()
    cfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    rng = np.random.default_rng(Lq)
    x = rng.standard_normal((2, Lq, cfg.d_model)).astype(np.float32)
    img = images(2, cfg, seed=Lq + 1)
    oj, (kj, vj) = jax_attn.cross_attn(jax.tree.map(jnp.asarray, pn["attn"]),
                                       jnp.asarray(x), jnp.asarray(img), cfg,
                                       jax_plan.exact_ctx(), None, chunk=8)
    ot, (kt, vt) = attn_lib.cross_attn(jax.tree.map(T, pn["attn"]), T(x), T(img), tcfg,
                                       exact_ctx(), None, chunk=8)
    _max_err_ok(ot.numpy(), oj)
    _max_err_ok(kt.numpy(), kj)
    _max_err_ok(vt.numpy(), vj)


@pytest.mark.parametrize("kernel", [True, False])
def test_cross_attn_decode_matches_jax(kernel):
    """One decode row over the cached image K/V: the JAX Pallas K6
    (interpret mode) and its jnp reference against the port's plain K6
    through an XAttnCache; the cache is only read."""
    pn = _block_params()
    cfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    k = rng.standard_normal((3, cfg.vision_tokens, cfg.n_kv_heads, cfg.head_dim))
    v = rng.standard_normal(k.shape)
    k, v = k.astype(np.float32), v.astype(np.float32)
    oj = jax_attn.cross_attn_decode(jax.tree.map(jnp.asarray, pn["attn"]), jnp.asarray(x),
                                    (jnp.asarray(k), jnp.asarray(v)), cfg, kernel=kernel)
    stacked = attn_lib.init_xattn_cache(3, cfg.vision_tokens, cfg.n_kv_heads, cfg.head_dim,
                                        torch.float32, "cpu", layers=1)
    stacked.k.copy_(T(k)[None])
    stacked.v.copy_(T(v)[None])
    cache = stacked.layer(0)
    ot = attn_lib.cross_attn_decode(jax.tree.map(T, pn["attn"]), T(x), cache, tcfg)
    _max_err_ok(ot.numpy(), oj)
    assert torch.equal(cache.k, T(k)) and torch.equal(cache.v, T(v))
    assert cache.q_pos.tolist() == [0, 0, 0] and cache.slot_pos[2].tolist() == list(range(16))
    # built once with the cache: the next step's layer view gets the same tensors
    assert stacked.layer(0).slot_pos is cache.slot_pos


@pytest.mark.parametrize("S", [16, 300])
def test_k6_plain_non_causal_matches_jax_kernel(S):
    """K6's plain version, causal=False, against the JAX Pallas kernel
    (interpret mode) at the smoke arch's 16 image slots and at 300 (two of
    the JAX kernel's key blocks, the second ragged); one row parked at
    q_pos -1 attends to every slot all the same, and a dead slot
    (slot_pos -1) is masked."""
    rng = np.random.default_rng(S)
    B, H, KV, dh = 3, 4, 2, 16
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    q_pos = np.array([0, -1, 0], np.int32)
    slot_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    slot_pos[2, S // 2] = -1
    oj = np.asarray(jax_flash_decode_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(slot_pos), causal=False, window=0, interpret=True))
    ot = fd.flash_decode_ref(T(q), T(k), T(v), torch.from_numpy(q_pos),
                             torch.from_numpy(slot_pos), causal=False).numpy()
    for b in range(B):
        _max_err_ok(ot[b], oj[b])
    live = fd.flash_decode_ref(T(q), T(k), T(v), torch.zeros(B, dtype=torch.int32),
                               torch.from_numpy(slot_pos), causal=False).numpy()
    np.testing.assert_array_equal(live[1], ot[1])


# ---------------------------------------------------------------------------
# one block, and the model in training
# ---------------------------------------------------------------------------
def _leaves(tree):
    names, leaves = [], []
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        names.append(jax.tree_util.keystr(path))
        leaves.append(leaf)
    return names, leaves


@pytest.mark.parametrize("spec", ["", SPEC])
def test_xattn_block_matches_jax(spec):
    """One xattn block (stage 0, the smoke arch's fifth) over 12 tokens and
    16 image tokens: output, the input gradient and every parameter
    gradient, the gates' included, against JAX's ``block_train``; under
    the PAMM rule both sites compress (K1 twice, JAX's draws) and report."""
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    pn = _block_params()
    rng = np.random.default_rng(4)
    L = 12
    x = rng.standard_normal((2, L, jcfg.d_model)).astype(np.float32)
    img = images(2, jcfg, seed=5)
    gy = rng.standard_normal((2, L, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (2, L)).copy()
    jrc = JaxRunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none",
                       compression=spec, attn_chunk=8)
    trc = RunConfig(compute_dtype="float32", param_dtype="float32", policy_name="none",
                    compression=spec, attn_chunk=8)
    jres = jax_plan.as_resolved(None, jcfg, jrc)
    tres = plan_lib.as_resolved(None, tcfg, trc)

    def f(p, x):
        tele = jres.zero_telemetry()
        y, _, _ = jax_blocks.block_train("xattn", jcfg, jrc, jres.ctx(0, "xattn", tele), p,
                                         x, jnp.asarray(pos),
                                         {"image_embeds": jnp.asarray(img)},
                                         jax.random.key(7), jnp.float32(0))
        return y, tele

    pj = jax.tree.map(jnp.asarray, pn)
    (yj, telej), vjp = jax.vjp(f, pj, jnp.asarray(x))
    gpj, gxj = vjp((jnp.asarray(gy), jax.tree.map(jnp.zeros_like, telej)))
    pt = jax.tree.map(lambda a: T(a).requires_grad_(), pn)
    names, leaves = _leaves(pt)
    xt = T(x).requires_grad_()
    tele = tres.zero_telemetry()
    yt, _ = blk.block_train("xattn", tcfg, trc, tres.ctx(0, "xattn", tele), pt, xt,
                            torch.from_numpy(pos), Key(7, sampler=JaxSampler()),
                            torch.zeros(()), extras={"image_embeds": T(img)})
    grads = torch.autograd.grad(yt, [xt, *leaves], T(gy))
    assert rel(yt.detach().numpy(), yj) < 1e-5
    assert rel(grads[0].numpy(), gxj) < 1e-4
    gj = dict(zip(*_leaves(gpj)))
    assert "['gate_ffn']" in gj and "['attn']['gate_attn']" in gj
    for name, g in zip(names, grads[1:]):
        assert rel(g.numpy(), gj[name]) < 1e-4, name
        assert float(g.abs().max()) > 0, name
    assert sorted(tele) == sorted(telej)
    for path, v in telej.items():
        np.testing.assert_allclose(tele[path].detach().numpy(), np.asarray(v), rtol=1e-6)
    if spec:
        _, kept, total, _, obs = tele["stage0.xattn.attn.cross_kv"].tolist()
        assert 0 < kept <= total == 2 * jcfg.vision_tokens and obs == 1
        assert tele["stage0.xattn.attn.qkv"][2] == 2 * L


def _setup(spec="", **kw):
    """JAX and port run configs (f32), gated JAX parameters, one batch
    with its image_embeds, and the port model holding the parameters."""
    common = dict(compression=spec, policy_name="none", compute_dtype="float32",
                  param_dtype="float32", loss_chunk=16, attn_chunk=8, **kw)
    jr = JaxRunConfig(attn_kernel="jnp", **common)
    tr = RunConfig(**common)
    pn = gated_params(jr)
    batch = SyntheticStream.for_arch(jax_get_config(ARCH), 32, 4).get_batch(0)
    assert batch["image_embeds"].shape == (4, 16, 64)
    model = bridge.from_jax_params(pn, get_config(ARCH), device="cpu", trainable=True)
    return jr, tr, jax.tree.map(jnp.asarray, pn), batch, model


N_ATTN = 4   # vision smoke: (attn x4, xattn) x 1


@pytest.mark.parametrize("remat", ["none", "full", "pamm"])
@pytest.mark.parametrize("spec", ["", SPEC])
def test_training_matches_jax(spec, remat):
    """Loss, every gradient (the gates' included) and the telemetry of
    both attention sites against JAX's ``loss_fn``. Under the PAMM rule K1
    runs once a site a layer (again in remat='full''s recompute): 4
    self-attention attn.qkv, the xattn layer's attn.qkv (wq) and
    attn.cross_kv (over the image tokens); K2 once a weight: 4 x (wq, wk,
    wv) + wq + wk, wv. K3 once a self-attention layer (twice under
    remat), K4/K5 once; the cross-attention is no kernel's."""
    jr, tr, params, batch, model = _setup(spec, remat=remat)
    _, grads, sites, counts = check_against_jax(ARCH, tr, jr, params, batch, model)
    for name in ("stages.0.4.gate_ffn", "stages.0.4.attn.gate_attn"):
        assert float(grads[name].abs().max()) > 0, name
    attn = {"flash_attention_fwd_ref": (1 if remat == "none" else 2) * N_ATTN,
            "flash_attention_bwd_ref": N_ATTN}
    if not spec:
        assert counts == attn and sites == {}
        return
    k1 = (N_ATTN + 2) * (2 if remat == "full" else 1)
    assert counts == {"csim_argmax_ref": k1, "segment_matmul_ref": 3 * N_ATTN + 3, **attn}
    assert sorted(sites) == ["stage0.attn.attn.qkv", "stage0.xattn.attn.cross_kv",
                             "stage0.xattn.attn.qkv"]
    stored, kept, total, beta, obs = sites["stage0.xattn.attn.cross_kv"].tolist()
    assert stored > 0 and 0 < kept <= total == batch["image_embeds"].shape[0] * 16
    assert obs == 1


def test_cross_kv_input_takes_no_gradient():
    """The attn.cross_kv site's input is data: under the PAMM rule the
    image embeddings get no gradient (nothing is computed for them), while
    wk and wv get theirs from the compressed state."""
    jr, tr, params, batch, model = _setup(SPEC)
    img = torch.from_numpy(batch["image_embeds"]).requires_grad_(False)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tb["image_embeds"] = img
    from repro_torch.models import loss_fn
    loss, _ = loss_fn(get_config(ARCH), tr, None, model, tb, Key(3, sampler=JaxSampler()))
    wk = model.stages[0][4].attn.wk
    (g,) = torch.autograd.grad(loss, [wk])
    assert img.grad is None and float(g.abs().max()) > 0


def test_reversible_refuses_xattn_and_serving_paths_take_images():
    """The reversible structure refuses the xattn kind (the JAX text); a
    batch without image_embeds fails at the xattn block, naming the key."""
    with pytest.raises(ValueError, match="xattn consumes cross-modal"):
        blk.resolve_block_structure(get_config(ARCH), RunConfig(block_structure="reversible"))
    _, tr, _, batch, model = _setup()
    from repro_torch.models import forward
    with pytest.raises(KeyError, match="image_embeds"):
        forward(get_config(ARCH), tr, None, model,
                {"tokens": torch.from_numpy(batch["tokens"]).long()}, Key(0))


def test_bridge_carries_the_gates_both_ways():
    """The gates are (layers,)-stacked 0-d leaves: from the JAX tree into
    the port's Block (one 0-d view a layer) and back bit for bit, in bf16
    too; a JAX TrainState's AdamW moments both ways; ``train_state_tree``
    with the JAX TrainState's paths."""
    from repro.train import init_train_state as jax_init_train_state
    from repro_torch.train import init_train_state

    tcfg = get_config(ARCH)
    jr = JaxRunConfig(compression="", param_dtype="bfloat16")
    jstate, _ = jax_init_train_state(jax_get_config(ARCH), jr, jax.random.key(0))
    params = jax.tree.map(np.asarray, jstate.params)
    set_gates(params["stages"][0][4])
    model = bridge.from_jax_params(params, tcfg, device="cpu")
    block = model.stages[0][4]
    assert block.gate_ffn.shape == (1,) and block.gate_ffn.dtype == torch.bfloat16
    assert float(block.layer(0)["attn"]["gate_attn"]) == GATES["gate_attn"]
    back = bridge.to_jax_params(model)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    m = jax.tree.map(lambda p: np.full(p.shape, 0.5, np.float32), params)
    v = jax.tree.map(lambda p: np.full(p.shape, 0.25, np.float32), params)
    opt = bridge.opt_state_from_jax(np.int32(3), m, v, model)
    assert opt.m["stages.0.4.gate_ffn"].shape == (1,)
    assert "stages.0.4.attn.gate_attn" in opt.v
    step, m2, v2 = bridge.opt_state_to_jax(opt, model)
    assert int(step) == 3 and jax.tree.structure(v2) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(v2)):
        np.testing.assert_array_equal(a, b)
    port = init_train_state(tcfg, RunConfig(compression="", param_dtype="bfloat16"),
                            device="cpu", seed=1)
    flat = lambda t: [jax.tree_util.keystr(p) for p, _ in
                      jax.tree_util.tree_flatten_with_path(t)[0]]
    assert flat(bridge.train_state_tree(port)) == flat(jstate)
