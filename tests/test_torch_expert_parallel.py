"""The port's model axis for compressed row-parallel sites and for MoE
under expert parallelism on the CPU, against the JAX package.

On one spawned (data 1, model 2) gloo group (``repro_torch.launch.ranks``,
jobs in ``tests/torch_rank_jobs.py``), f32, batches of ``SyntheticStream``
(global 8 x 32, seed 0), the same parameters in both packages (drawn by
the port, bridged to JAX; each rank takes its slices with
``bridge.shard_jax_params``), each case against the JAX single-device
``make_train_step`` at ``tests/test_torch_tensor_parallel.py``'s bounds
(loss and NLL 5e-5, grad_norm relative 5e-5, the parameters gathered over
the model ranks 5e-4):

  * granite-moe smoke under ``attn.qkv=pamm(r=1/8);moe.expert=pamm(r=1/8)``,
    three steps, each rank holding 4 of the 8 experts;
  * one step (index 1) each for kimi smoke (shared experts, an attn stage,
    ``ffn.*`` compressed, the shared ``ffn.down`` row-parallel), granite
    smoke with ``moe_token_blocks=2`` and with ``seq_shard=True``, 7
    experts padded to 8
    (``pad_experts_multiple=2``), 7 experts unpadded (whole on every
    rank), and internlm2 smoke with ``ffn.*=pamm(r=1/8)`` and
    ``ffn.*=compact(r=1/4)``, ``ffn.down`` compressed through the split
    route (its alpha / assign / beta, or CompAct's sketch, equal on both
    ranks bit for bit);
  * the router's gradient against the single-process port's, and a
    planted doubled or missing share of the balance loss's gradient that
    must fail that check.

The ranks draw what one process draws: the JAX draws (generator rows and
CompAct's normal projections), recorded by a single-process port run
through the JAX sampler and looked up on the ranks (``TableSampler``).

In-process: K1's split route (pass A on column halves, summed, then pass
B) against ``csim_argmax_ref`` and the JAX ``csim_argmax`` (interpret
mode) on the whole rows; ``model_cut`` / ``local_model_cut`` of the expert
and shared-expert leaves against JAX's ``logical_to_pspec``, split and
whole; ``shard_jax_params`` then ``unshard_params`` returns granite's and
kimi's trees bit for bit; the CLI on granite smoke.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.kernels.pamm_compress import csim_argmax as jax_csim_argmax
from repro.models import param_specs as jax_param_specs
from repro.runtime.sharding import logical_to_pspec
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config
from repro_torch.core.keys import Key, choice_batched
from repro_torch.core.plan import resolve_for_run
from repro_torch.kernels import pamm_compress as tpc
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models.model import _padded_vocab
from repro_torch.optim import adamw_init
from repro_torch.runtime import sharding as tsh
from repro_torch.train import TrainState, make_train_step
from repro_torch.train.train_step import batch_to_device, loss_and_grad
from tests import torch_rank_jobs
from tests.test_torch_distributed import _Recording
from tests.test_torch_tensor_parallel import _batches, _hold, _jax_run, _params, _rcfg

GRANITE, KIMI, INTERN = ("granite-moe-3b-a800m_smoke", "kimi-k2-1t-a32b_smoke",
                         "internlm2-1.8b_smoke")
MOE_SPEC = "attn.qkv=pamm(r=1/8);moe.expert=pamm(r=1/8)"
# (id, arch, compression, RunConfig fields, config fields, steps from index)
CASES = [
    ("granite", GRANITE, MOE_SPEC, {}, {}, 0),
    ("kimi", KIMI, MOE_SPEC + ";ffn.*=pamm(r=1/8)", {}, {}, 1),
    ("granite-blocked", GRANITE, MOE_SPEC, {"moe_token_blocks": 2}, {}, 1),
    ("granite-seq-shard", GRANITE, MOE_SPEC, {"seq_shard": True}, {}, 1),
    ("experts7-padded", GRANITE, MOE_SPEC, {"pad_experts_multiple": 2}, {"n_experts": 7}, 1),
    ("experts7-whole", GRANITE, MOE_SPEC, {}, {"n_experts": 7}, 1),
    ("ffn-pamm", INTERN, "attn.qkv=pamm(r=1/8);ffn.*=pamm(r=1/8)", {}, {}, 1),
    ("ffn-compact", INTERN, "ffn.*=compact(r=1/4)", {}, {}, 1),
]
STEPS = {"granite": 3}
PLANTS = ("aux_doubled", "aux_missing")
TOL_ROUTER = 1e-5


class _RecordingAll(_Recording):
    """The JAX sampler, keeping its generator rows and normal draws."""

    def normal(self, seed, path, shape, device):
        p = super().normal(seed, path, shape, device)
        self.table[(seed, path, tuple(shape))] = p.numpy().copy()
        return p


def _cfg(arch, over):
    return dataclasses.replace(get_config(arch), **over)


def _port_single(arch, params, rk, over, batches, start):
    """The port's single-process steps on the JAX draws: the draws, and the
    router's gradient of the first batch at ``params``."""
    cfg, rcfg = _cfg(arch, over), RunConfig(**rk)
    model = bridge.from_jax_params(params, cfg, device="cpu", trainable=True)
    sampler = _RecordingAll()
    _, _, grads = loss_and_grad(cfg, rcfg, resolve_for_run(cfg, rcfg), model,
                                batch_to_device(batches[0], "cpu"),
                                Key(rcfg.seed, sampler=sampler).fold_in(start))
    router = {n: g.numpy().copy() for n, g in grads.items() if n.endswith("router")}
    state = TrainState(model, adamw_init(dict(model.named_parameters())))
    step = make_train_step(cfg, rcfg, total_steps=start + len(batches), sampler=sampler)
    for i, b in enumerate(batches, start=start):
        state, _ = step(state, b, i)
    return sampler.table, router


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """Record the draws, start the (1, 2) group, run the JAX references
    while it trains, then collect."""
    plans, singles = {}, {}
    for cid, arch, spec, rk, over, start in CASES:
        rk = _rcfg(compression=spec, **rk)
        plans[cid] = (arch, _params(arch, rk, over), rk, over,
                      _batches(arch, STEPS.get(cid, 1), over), start)
        singles[cid] = _port_single(*plans[cid])

    def run(cid, plant=None):
        arch, p, rk, over, b, s = plans[cid]
        collect = ("params", "split_states") if arch == INTERN else ("params", "router_grads")
        if plant:     # its router gradient alone: one step, nothing gathered
            b, collect = b[:1], ("router_grads",)
        return {"arch": arch, "rcfg": rk, "cfg": over, "params": p, "batches": b, "start": s,
                "sampler": torch_rank_jobs.TableSampler(singles[cid][0]), "plant": plant,
                "collect": collect}

    jobs = [run(c[0]) for c in CASES] + [run("granite", plant) for plant in PLANTS]
    group = spawn_ranks(2, torch_rank_jobs.job, (1, 2), [], jobs,
                        timeout=torch_rank_jobs.TIMEOUT)
    ref = {cid: _jax_run(*plan) for cid, plan in plans.items()}
    got = [r["runs"] for r in group.results()]
    return got, ref, {cid: router for cid, (_, router) in singles.items()}


def _router_rel(got: dict, want: dict) -> float:
    assert set(got) == set(want) and got
    return max(float(np.abs(got[n] - want[n]).max() / np.abs(want[n]).max()) for n in want)


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_model_axis_matches_jax_single_device(runs, cid):
    """Losses, grad norms and parameters against the JAX step; each site's
    telemetry (stored bytes, kept rows, beta) equal to the JAX step's: the
    split route's generator slices and a rank's experts summed over the
    model ranks."""
    got, ref, routers = runs
    i = [c[0] for c in CASES].index(cid)
    _hold([r[i] for r in got], ref[cid])
    for want, have in zip(ref[cid][1], got[0][i]["metrics"]):
        sites = [k for k in want if k.startswith("site/")]
        assert sites and all(have[k] == pytest.approx(want[k], rel=1e-6) for k in sites), \
            {k: (have.get(k), want[k]) for k in sites}
    if CASES[i][1] != INTERN:
        assert _router_rel(got[0][i]["router_grads"], routers[cid]) < TOL_ROUTER


@pytest.mark.parametrize("cid", ["ffn-pamm", "ffn-compact"])
def test_row_parallel_states_are_equal_on_the_model_ranks(runs, cid):
    """alpha, assign and beta of every split PAMM state (CompAct: the summed
    sketch) are the same bits on both ranks."""
    got, _, _ = runs
    i = [c[0] for c in CASES].index(cid)
    a, b = (r[i]["split_states"] for r in got)
    assert len(a) == len(b) == get_config(INTERN).n_layers   # one ffn.down a layer
    for sa, sb in zip(a, b):
        for x, y in zip(sa, sb):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("plant", PLANTS)
def test_a_wrong_balance_loss_share_fails_the_router_check(runs, plant):
    """Doubling (every rank keeps the whole) or dropping the balance loss's
    share of the router's gradient moves it far past the bound the real
    run meets."""
    got, _, routers = runs
    rel = _router_rel(got[0][len(CASES) + PLANTS.index(plant)]["router_grads"],
                      routers["granite"])
    assert rel > 100 * TOL_ROUTER, rel


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------
def test_a_ranks_experts_draw_what_they_draw_together():
    """The default sampler draws a rank's share of a MoE site's experts
    (``split(E')[first:first + E]``) as the rows the whole split draws."""
    keys = Key(3).fold_in(5).split(8)
    whole = choice_batched(keys, 64, 4, "cpu")
    for first in (0, 4):
        assert torch.equal(choice_batched(keys[first:first + 4], 64, 4, "cpu"),
                           whole[first:first + 4])


@pytest.mark.parametrize("n", [64, 100])
def test_split_passes_equal_k1_on_whole_rows(n):
    """Pass A on two column halves, summed, then pass B: K1 of the whole
    rows (``csim_argmax_ref`` and the JAX kernel in interpret mode): the
    same indices, cs within 1e-6; a zero row and a zero generator too."""
    rng = np.random.default_rng(n)
    b, k = 96, 12
    x = rng.standard_normal((b, n)).astype(np.float32)
    x[5] = 0.0
    idx = rng.choice(b, k, replace=False)
    idx[3] = 5                                   # a generator of norm 0
    xt = torch.from_numpy(x)
    c = xt[torch.from_numpy(idx)]
    h = n // 2
    part = tpc.csim_partial_ref(xt[:, :h].contiguous(), c[:, :h].contiguous()) \
        + tpc.csim_partial_ref(xt[:, h:].contiguous(), c[:, h:].contiguous())
    cs, got_idx, norm = tpc.csim_finish_ref(part, torch.from_numpy(idx))
    cs_r, idx_r, norm_r = tpc.csim_argmax_ref(xt, c)
    cs_j, idx_j, norm_j = jax_csim_argmax(jnp.asarray(x), jnp.asarray(x[idx]), interpret=True)
    for want_cs, want_idx, want_norm in ((cs_r.numpy(), idx_r.numpy(), norm_r.numpy()),
                                         (np.asarray(cs_j), np.asarray(idx_j),
                                          np.asarray(norm_j))):
        np.testing.assert_array_equal(got_idx.numpy(), want_idx)
        np.testing.assert_allclose(cs.numpy(), want_cs, atol=1e-6, rtol=0)
        np.testing.assert_allclose(norm.numpy(), want_norm, rtol=1e-6, atol=0)
    assert got_idx.dtype == torch.int32 and cs[5] == 0 and got_idx[5] == 0


def _moe_cfgs():
    """(arch, cfg fields, RunConfig fields) of the expert layouts held below."""
    return [(GRANITE, {}, {}), (KIMI, {}, {}), (GRANITE, {"n_experts": 7}, {}),
            (GRANITE, {"n_experts": 7}, {"pad_experts_multiple": 2}),
            (GRANITE, {"n_experts": 6}, {})]


@pytest.mark.parametrize("tp", [2, 4])
def test_expert_leaves_model_dim_matches_jax_logical_to_pspec(tp):
    """Each leaf of the MoE smoke trees (padded and odd expert counts among
    them): ``model_cut``'s dimension on the whole shape against
    ``logical_to_pspec`` of the JAX ``param_specs`` with the uneven
    dimensions dropped (``sanitize_shardings``), and ``local_model_cut`` on
    a rank's slice (E' from ``padded_experts``) gives the same cut back."""
    jmesh = types.SimpleNamespace(axis_names=("data", "model"))
    is_leaf = lambda s: isinstance(s, tuple) and all(isinstance(x, (str, type(None)))
                                                     for x in s)
    seen = {"split": 0, "whole": 0}
    for arch, over, rk in _moe_cfgs():
        jcfg = dataclasses.replace(jax_get_config(arch), **over)
        cfg, rcfg = _cfg(arch, over), RunConfig(**rk)
        shapes, specs = jax_param_specs(jcfg, JaxRunConfig(**rk))
        v_pad, e_pad = _padded_vocab(cfg, rcfg), tsh.padded_experts(cfg, rcfg)
        for (path, shp), logical in zip(jax.tree_util.tree_leaves_with_path(shapes),
                                        jax.tree.leaves(specs, is_leaf=is_leaf)):
            name = jax.tree_util.keystr(path, simple=True, separator=".")
            ps = tuple(logical_to_pspec(logical, jmesh))
            want = next((i for i, e in enumerate(ps) if e == "model"), None)
            if want is not None and shp.shape[want] % tp:
                want = None
            cut = tsh.model_cut(name, shp.shape, tp, cfg.head_dim)
            got = None if cut is None else cut.dim
            leaf = name.rsplit(".", 1)[-1]
            if leaf in tsh.Q_HEAD_LEAVES + tsh.KV_HEAD_LEAVES:
                continue               # heads: tests/test_torch_tensor_parallel.py
            assert got == want, (arch, over, name, logical)
            local = list(shp.shape)
            if got is not None:
                local[got] //= tp
            assert tsh.local_model_cut(name, local, cfg, v_pad, e_pad) == cut, (arch, name)
            if leaf.startswith("w_") and len(shp.shape) == 4:
                seen["split" if got is not None else "whole"] += 1
    assert seen["split"] and seen["whole"], seen


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_then_unshard_gives_the_moe_trees_back(tp):
    for arch, over, rk in _moe_cfgs():
        cfg, rcfg = _cfg(arch, over), RunConfig(compute_dtype="float32", **rk)
        params = _params(arch, {"compute_dtype": "float32", **rk}, over)
        shards = [bridge.to_jax_params(bridge.shard_jax_params(
            params, cfg, Mesh(("data", "model"), (1, tp), rank=r), device="cpu"))
            for r in range(tp)]
        got = tsh.unshard_params([bridge._flatten(s) for s in shards], cfg,
                                 _padded_vocab(cfg, rcfg), tsh.padded_experts(cfg, rcfg))
        want = bridge._flatten(params)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        experts = [k for k in want if k.endswith("w_gate") and want[k].ndim == 4]
        split = tsh.padded_experts(cfg, rcfg) % tp == 0
        assert all((bridge._flatten(shards[0])[k].shape != want[k].shape) == split
                   for k in experts), (arch, over)


def test_train_cli_expert_parallel_on_the_cpu(capfd):
    from repro_torch.launch import train

    train.main(["--arch", GRANITE, "--device", "cpu", "--steps", "2", "--seq-len", "32",
                "--global-batch", "4", "--compression", MOE_SPEC, "--log-every", "1",
                "--executor", "shard_map", "--data-model", "1", "2"])
    out = capfd.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "done: 2 steps on 2 ranks (data 1 x model 2)" in out
