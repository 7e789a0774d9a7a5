"""The port's ring context parallelism on the CPU, against the JAX package
(after ``tests/test_ring.py``).

In-process: the zigzag permutation, its inverse and the shard positions,
``ring_pair_live`` (causal and windowed), ``_merge`` with NEG_INF rows,
and the texts of ``validate_seq_divisible`` and of the cp gates of
``resolve_block_structure``.

On gloo ranks (``repro_torch.launch.ranks``; one spawned group per mesh
shape, every case of that shape inside it, running
``tests/torch_rank_jobs.py``): the ring at cp 2 and 4 (GQA
4/2 and MQA 4/1 causal; windows 12, 24 and 40 that cross the zigzag
seams; L 64, dh 16, f32) through the plain K3 / K4 / K5 versions with
offsets, against JAX's single-device ``flash_attention`` (interpret
mode) over the whole sequence, forward and dq / dk / dv of sum(sin(o)),
relative to the reference's largest entry: 1e-5 (``tests/test_ring.py``'s
bound: the same f32 math, summed per chunk pair); and the mesh executor's
train step on llama-tiny at (data, model, context) (1,1,2), (2,1,2) and
(1,1,4), policy ``none``, f32, two steps on one batch, against JAX's
single-device ``make_train_step`` from the same parameters (bridged):
loss relative 2e-5, grad_norm relative 2e-4 (``tests/test_ring.py``'s
bounds); and ``h2o-danube-3-4b_smoke`` (swa blocks, window 8 shorter
than a shard) under cp 2, loss relative 2e-5.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.data import SyntheticStream
from repro.kernels import ring_attention as jring
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.models.blocks import resolve_block_structure as jax_resolve_block_structure
from repro.runtime import sharding as jsh
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train import TrainState as JaxTrainState
from repro.train import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config
from repro_torch.kernels import ring_attention as tring
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import init_model
from repro_torch.models.blocks import resolve_block_structure
from repro_torch.runtime import sharding as tsh
from tests import torch_rank_jobs

ARCH = "llama-tiny"
L_RING, B_RING, DH_RING = 64, 2, 16
RING_CASES = [(2, 2, 0), (2, 1, 0), (4, 2, 0), (4, 1, 0)] \
    + [(cp, 2, w) for cp in (2, 4) for w in (12, 24, 40)]   # cp, KV (H 4), window
MESHES = [(1, 1, 2), (2, 1, 2), (1, 1, 4)]
TIMEOUT = torch_rank_jobs.TIMEOUT


# ---------------------------------------------------------------------------
# in-process, against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L,cp", [(16, 2), (64, 4), (96, 2), (128, 8)])
def test_zigzag_permutation_and_positions_match_jax(L, cp):
    np.testing.assert_array_equal(tring.zigzag_permutation(L, cp),
                                  jring.zigzag_permutation(L, cp))
    np.testing.assert_array_equal(tring.zigzag_inverse_permutation(L, cp),
                                  jring.zigzag_inverse_permutation(L, cp))
    for i in range(cp):
        np.testing.assert_array_equal(
            tring.zigzag_shard_positions(i, L, cp).numpy(),
            np.asarray(jring.zigzag_shard_positions(jnp.int32(i), L, cp)))
    with pytest.raises(ValueError, match="not divisible"):
        tring.zigzag_permutation(30, 4)


@pytest.mark.parametrize("window", [0, 4, 12])
def test_ring_pair_live_matches_jax(window):
    C = 8
    for q_off in range(0, 48, 4):
        for k_off in range(0, 48, 4):
            assert tring.ring_pair_live(q_off, k_off, C, causal=True, window=window) == \
                bool(jring.ring_pair_live(q_off, k_off, C, causal=True, window=window))
    # the zigzag balance: 2cp + 1 live pairs on every rank without a window
    for cp in (2, 4):
        assert {tring.live_pairs(i, cp, C) for i in range(cp)} == {2 * cp + 1}


def test_merge_matches_jax_with_neg_inf_rows():
    rng = np.random.default_rng(0)
    B, H, C, dh = 2, 3, 5, 4
    o_a, o_b = (rng.standard_normal((B, C, H, dh)).astype(np.float32) for _ in range(2))
    lse_a, lse_b = (rng.standard_normal((B, H, C)).astype(np.float32) for _ in range(2))
    lse_a[:, :, 0] = NEG_INF                    # one dead side
    lse_a[:, :, 1] = lse_b[:, :, 1] = NEG_INF   # both dead
    o_a[:, 1], o_b[:, 1] = 0.0, 0.0
    mo, ml = tring._merge(*map(torch.from_numpy, (o_a, lse_a, o_b, lse_b)))
    jo, jl = jring._merge(*map(jnp.asarray, (o_a, lse_a, o_b, lse_b)))
    np.testing.assert_allclose(mo.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ml.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-6)
    assert np.isfinite(mo.numpy()).all()
    np.testing.assert_array_equal(mo.numpy()[:, 0], o_b[:, 0])


def _abstract_meshes(shape):
    axes = ("data", "model", "context")[:len(shape)]
    jmesh = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    return Mesh(axes, shape), jmesh


def _error_text(fn, *args, **kw):
    with pytest.raises(ValueError) as ei:
        fn(*args, **kw)
    return str(ei.value)


def test_validate_seq_and_batch_texts_match_jax():
    tmesh, jmesh = _abstract_meshes((1, 1, 2))
    tsh.validate_seq_divisible(32, tmesh)
    tsh.validate_seq_divisible(30, Mesh(("data", "model"), (1, 1)))
    for kw in ({}, {"bq": 8}):
        got = _error_text(tsh.validate_seq_divisible, 30, tmesh, **kw)
        assert got == _error_text(jsh.validate_seq_divisible, 30, jmesh, **kw)
    assert "2*cp = 4" in got and "28 or 32" in got and "context" in got
    tmesh, jmesh = _abstract_meshes((4, 1))
    assert _error_text(tsh.validate_batch_divisible, 6, tmesh, where="shard_map train step") \
        == _error_text(jsh.validate_batch_divisible, 6, jmesh, where="shard_map train step")
    assert _error_text(tsh.validate_batch_divisible, 8, tmesh, grad_accum=3) \
        == _error_text(jsh.validate_batch_divisible, 8, jmesh, grad_accum=3)
    assert tsh.cp_degree(_abstract_meshes((2, 1, 4))[0]) == 4
    assert tsh.dp_degree(_abstract_meshes((2, 1, 4))[0]) == 2


def test_resolve_block_structure_cp_gates_match_jax():
    assert resolve_block_structure(get_config(ARCH), RunConfig(), cp=2) == "residual"
    for arch, kw in ((ARCH, {"block_structure": "reversible"}),
                     ("recurrentgemma-9b_smoke", {}), ("mamba2-370m_smoke", {}),
                     ("llama-3.2-vision-11b_smoke", {})):
        got = _error_text(resolve_block_structure, get_config(arch), RunConfig(**kw), cp=2)
        assert got == _error_text(jax_resolve_block_structure, jax_get_config(arch),
                                  JaxRunConfig(**kw), cp=2)
    assert resolve_block_structure(get_config("recurrentgemma-9b_smoke"), RunConfig(),
                                   cp=1) == "residual"


# ---------------------------------------------------------------------------
# on gloo ranks
# ---------------------------------------------------------------------------
def _ring_inputs(kv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B_RING, L_RING, 4, DH_RING)).astype(np.float32)
    k = rng.standard_normal((B_RING, L_RING, kv, DH_RING)).astype(np.float32)
    v = rng.standard_normal((B_RING, L_RING, kv, DH_RING)).astype(np.float32)
    return q, k, v


def _train_setup(arch, batch, seq=32):
    """The JAX run config, a JAX TrainState and its parameters as numpy
    (drawn by the port's init: faster than JAX's eager one), and batch 0."""
    jr = JaxRunConfig(policy_name="none", compute_dtype="float32", param_dtype="float32",
                      attn_kernel="jnp")
    params = bridge.to_jax_params(init_model(get_config(arch), RunConfig(), seed=0,
                                             device="cpu"))
    jparams = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(params=jparams, opt=jax_make_optimizer("adamw")[0](jparams))
    b = SyntheticStream.for_arch(jax_get_config(arch), seq, batch).get_batch(0)
    return jr, state, params, b


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's port steps are tiny: on one intra-op thread, as the
    ranks run (beside other busy processes a pool waits for cores at
    every op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    """Every mesh shape's group, started together; the JAX references are
    computed while they run."""
    inputs = {(cp, kv, w): _ring_inputs(kv, seed=kv * 100 + w) for cp, kv, w in RING_CASES}
    tiny = _train_setup(ARCH, batch=4)
    danube = _train_setup("h2o-danube-3-4b_smoke", batch=2)
    rcfg = dict(policy_name="none", compute_dtype="float32", param_dtype="float32")
    jobs = {}
    for shape in MESHES:
        cp = shape[2]
        ring_cases = [(*inputs[key], key[2]) for key in RING_CASES
                      if key[0] == cp and shape[0] == 1]
        runs = [{"arch": ARCH, "rcfg": rcfg, "params": tiny[2], "batches": [tiny[3]] * 2}]
        if shape == (1, 1, 2):
            runs.append({"arch": "h2o-danube-3-4b_smoke", "rcfg": rcfg,
                         "params": danube[2], "batches": [danube[3]]})
        jobs[shape] = (ring_cases, runs)
    started = {s: spawn_ranks(int(np.prod(s)), torch_rank_jobs.job, s, *jobs[s],
                              timeout=TIMEOUT) for s in MESHES}
    refs = {"ring": {}, "train": {}}
    for kv, w in sorted({(kv, w) for _, kv, w in RING_CASES}):
        q, k, v = map(jnp.asarray, _ring_inputs(kv, seed=kv * 100 + w))
        o, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_attention(
            q_, k_, v_, causal=True, window=w, bq=16, bk=16), q, k, v)
        ref = [np.asarray(x) for x in (o, *vjp(jnp.cos(o)))]   # d sum(sin(o))
        for cp in (2, 4):
            refs["ring"][(cp, kv, w)] = ref
    for arch, (jr, state, _, batch), steps in ((ARCH, tiny, 2), ("h2o-danube-3-4b_smoke",
                                                                   danube, 1)):
        fn = jax.jit(jax_make_train_step(jax_get_config(arch), jr, total_steps=steps))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        got = []
        for s in range(steps):
            state, m = fn(state, jb, jnp.int32(s))
            got.append((float(m["loss"]), float(m["grad_norm"])))
        refs["train"][arch] = got
    return {s: r.results() for s, r in started.items()}, jobs, refs


@pytest.mark.parametrize("case", RING_CASES, ids=[f"cp{c}-kv{k}-w{w}" for c, k, w in RING_CASES])
def test_ring_matches_jax_flash_attention(ranks, case):
    results, jobs, refs = ranks
    cp, kv, w = case
    shape = (1, 1, cp)
    i = [key for key in RING_CASES if key[0] == cp].index(case)
    inv = tring.zigzag_inverse_permutation(L_RING, cp)
    for j, name in enumerate(("o", "dq", "dk", "dv")):
        whole = np.concatenate([results[shape][r]["ring"][i][j] for r in range(cp)], 1)
        rel = _rel(whole[:, inv], refs["ring"][case][j])
        assert rel < 1e-5, f"{name} rel {rel:.2e}"


@pytest.mark.parametrize("shape", MESHES, ids=["1x1x2", "2x1x2", "1x1x4"])
def test_train_step_matches_jax_single_device(ranks, shape):
    results, _, refs = ranks
    got = [[(m["loss"], m["grad_norm"]) for m in r["runs"][0]["metrics"]]
           for r in results[shape]]
    assert all(g == got[0] for g in got)        # every rank reports the same metrics
    for (l0, g0), (l1, g1) in zip(refs["train"][ARCH], got[0]):
        assert abs(l0 - l1) / max(abs(l0), 1e-9) < 2e-5
        assert abs(g0 - g1) / max(abs(g0), 1e-9) < 2e-4


def test_train_step_cp_swa_arch(ranks):
    """Window 8 < the shard length 16: the window masks cross the zigzag
    seams inside the ring."""
    results, _, refs = ranks
    (l0, _), = refs["train"]["h2o-danube-3-4b_smoke"]
    l1 = results[(1, 1, 2)][0]["runs"][1]["metrics"][0]["loss"]
    assert np.isfinite(l1)
    assert abs(l0 - l1) / max(abs(l0), 1e-9) < 2e-5
