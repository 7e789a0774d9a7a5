"""The port's model axis for the ssm and rec / latt block kinds on the CPU,
against the JAX package.

On one spawned (data 1, model 2) gloo group (``repro_torch.launch.ranks``,
jobs in ``tests/torch_rank_jobs.py``), f32, batches of ``SyntheticStream``
(global 8 x 32, seed 0), the same parameters in both packages (drawn by
the port, bridged to JAX; each rank takes its slices with
``bridge.shard_jax_params``), each case against the JAX single-device
``make_train_step`` at ``tests/test_torch_tensor_parallel.py``'s bounds
(loss and NLL 5e-5, grad_norm relative 5e-5, the parameters gathered over
the model ranks 5e-4) and every site's telemetry at 1e-6:

  * mamba2 smoke under ``ssm.in=pamm(r=1/8)``, three steps, each rank
    holding 4 of the 8 heads (B / C whole);
  * recurrentgemma smoke under ``attn.qkv=pamm(r=1/8);rglru.in=pamm(r=1/8)``,
    three steps, each rank holding half the RG-LRU width, 2 of latt's 4 q
    heads and its one K/V head whole;
  * one step (index 1) each of mamba2 smoke under ``seq_shard=True`` with
    ``remat='pamm'`` and under ``ssm.in=compact(r=1/4)``;
  * planted faults, each of which must fail that check: the ssm norm's sum
    of squares over the rank's columns only, the B / C columns' gradient
    left unsummed, RG-LRU's ``lambda`` gradient left unsummed.

The ranks draw what one process draws: the JAX draws, recorded by a
single-process port run through the JAX sampler and looked up on the
ranks (``TableSampler``).

In-process: ``model_cut`` of every ssm and rec leaf against
``logical_to_pspec`` of the JAX ``param_specs`` at tp 2 and 4, with the
departures by design listed (Mamba-2's packed leaves cut by heads,
``w_a`` / ``w_i`` by columns); ``local_model_cut`` of a rank's slice
naming the cut ``model_cut`` made; ``shard_jax_params`` then
``unshard_params`` returning the mamba2 and recurrentgemma trees bit for
bit, and failing when the layout's two halves disagree; a rank's
``in_proj`` columns; uneven head counts that keep the leaves whole; the
global norm's count of the whole parts; the CLI on mamba2 smoke.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.models import param_specs as jax_param_specs
from repro.runtime.sharding import logical_to_pspec
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models.model import _padded_vocab
from repro_torch.optim.optimizers import clip_by_global_norm
from repro_torch.runtime import sharding as tsh
from tests import torch_rank_jobs
from tests.test_torch_expert_parallel import _port_single
from tests.test_torch_tensor_parallel import _batches, _hold, _jax_run, _params, _rcfg

SSM, REC = "mamba2-370m_smoke", "recurrentgemma-9b_smoke"
SSM_SPEC = "ssm.in=pamm(r=1/8)"
REC_SPEC = "attn.qkv=pamm(r=1/8);rglru.in=pamm(r=1/8)"
# (id, arch, compression, RunConfig fields, config fields, first step index)
CASES = [
    ("mamba2", SSM, SSM_SPEC, {}, {}, 0),
    ("recurrentgemma", REC, REC_SPEC, {}, {}, 0),
    ("mamba2-seq-shard", SSM, SSM_SPEC, {"seq_shard": True, "remat": "pamm"}, {}, 1),
    ("mamba2-compact", SSM, "ssm.in=compact(r=1/4)", {}, {}, 1),
]
STEPS = {"mamba2": 3, "recurrentgemma": 3}
# planted fault: the case it runs in
PLANTS = {"norm_local": "mamba2", "bc_unsummed": "mamba2", "lambda_unsummed": "recurrentgemma"}
# leaves whose cut departs from JAX's logical_to_pspec on purpose
# (runtime/sharding.py): the packed ssm leaves by heads (the same
# dimension, other parts), the RG-LRU gates by columns (JAX: rows)
HEAD_ALIGNED = ("ssm.in_proj", "ssm.conv_w")
BY_COLUMNS = ("rec.w_a", "rec.w_i")


def _cfg(arch, over=None):
    return dataclasses.replace(get_config(arch), **(over or {}))


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
    plans, tables = {}, {}
    for cid, arch, spec, rk, over, start in CASES:
        rk = _rcfg(compression=spec, **rk)
        plans[cid] = (arch, _params(arch, rk, over), rk, over,
                      _batches(arch, STEPS.get(cid, 1), over), start)
        tables[cid] = _port_single(*plans[cid])[0]

    def run(cid, plant=None):
        arch, p, rk, over, b, s = plans[cid]
        return {"arch": arch, "rcfg": rk, "cfg": over, "params": p, "batches": b, "start": s,
                "sampler": torch_rank_jobs.TableSampler(tables[cid]), "plant": plant,
                "collect": ("params",)}

    jobs = [run(c[0]) for c in CASES] + [run(cid, plant) for plant, cid in PLANTS.items()]
    group = spawn_ranks(2, torch_rank_jobs.job, (1, 2), [], jobs,
                        timeout=torch_rank_jobs.TIMEOUT)
    ref = {cid: _jax_run(*plan) for cid, plan in plans.items()}
    return [r["runs"] for r in group.results()], ref


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_model_axis_matches_jax_single_device(runs, cid):
    """Losses, grad norms and the gathered parameters against the JAX
    step; each site's telemetry equal to the JAX step's."""
    got, ref = runs
    i = [c[0] for c in CASES].index(cid)
    _hold([r[i] for r in got], ref[cid])
    for want, have in zip(ref[cid][1], got[0][i]["metrics"]):
        sites = [k for k in want if k.startswith("site/")]
        assert sites and all(have[k] == pytest.approx(want[k], rel=1e-6) for k in sites), \
            {k: (have.get(k), want[k]) for k in sites}


@pytest.mark.parametrize("plant", list(PLANTS))
def test_a_planted_fault_fails_the_parity_check(runs, plant):
    got, ref = runs
    i = len(CASES) + list(PLANTS).index(plant)
    with pytest.raises(AssertionError):
        _hold([r[i] for r in got], ref[PLANTS[plant]])


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------
def _leaves(arch, over=None):
    """(name, whole shape, JAX's model dimension or None) of every leaf."""
    jmesh = types.SimpleNamespace(axis_names=("data", "model"))
    is_leaf = lambda s: isinstance(s, tuple) and all(isinstance(x, (str, type(None)))
                                                     for x in s)
    jcfg = dataclasses.replace(jax_get_config(arch), **(over or {}))
    shapes, specs = jax_param_specs(jcfg, JaxRunConfig())
    for (path, shp), logical in zip(jax.tree_util.tree_leaves_with_path(shapes),
                                    jax.tree.leaves(specs, is_leaf=is_leaf)):
        ps = tuple(logical_to_pspec(logical, jmesh))
        yield (jax.tree_util.keystr(path, simple=True, separator="."), shp.shape,
               next((i for i, e in enumerate(ps) if e == "model"), None))


@pytest.mark.parametrize("tp", [2, 4])
def test_model_dim_matches_jax_logical_to_pspec(tp):
    """Every leaf of the ssm and rec smoke trees: the dimension the port
    cuts is JAX's (its uneven dimensions dropped, ``sanitize_shardings``)
    but for the departures by design, which are exactly the packed ssm
    leaves (JAX's dimension, cut in parts) and ``w_a`` / ``w_i`` (their
    columns where JAX takes rows)."""
    departed = set()
    for arch in (SSM, REC):
        cfg = get_config(arch)
        for name, shape, want in _leaves(arch):
            if want is not None and shape[want] % tp:
                want = None
            cut = tsh.model_cut(name, shape, tp, cfg.head_dim, cfg)
            key = tsh._leaf_key(name, len(shape))[0]
            if key in tsh.Q_HEAD_LEAVES + tsh.KV_HEAD_LEAVES:
                continue               # heads: tests/test_torch_tensor_parallel.py
            if key in HEAD_ALIGNED:
                assert cut.dim == want and not cut.contiguous, name
                departed.add(key)
            elif key in BY_COLUMNS:
                assert want == len(shape) - 2 and cut.dim == len(shape) - 1, name
                departed.add(key)
            else:
                assert (None if cut is None else cut.dim) == want, (arch, name)
                assert cut is None or cut.contiguous
    assert departed == set(HEAD_ALIGNED + BY_COLUMNS)


@pytest.mark.parametrize("tp", [2, 4])
def test_a_ranks_slice_names_the_cut_that_made_it(tp):
    """``local_model_cut`` of a rank's slice is the ``model_cut`` of the
    whole leaf (a whole leaf: None on both), for every ssm and rec leaf."""
    keys = set()
    for arch in (SSM, REC):
        cfg, rcfg = get_config(arch), RunConfig()
        for name, shape, _ in _leaves(arch):
            cut = tsh.model_cut(name, shape, tp, cfg.head_dim, cfg)
            local = list(shape)
            if cut is not None:
                local[cut.dim] = cut.local_size(tp)
            got = tsh.local_model_cut(name, local, cfg, _padded_vocab(cfg, rcfg))
            assert got == cut, (arch, name, got, cut)
            if cut is not None:
                keys.add(tsh._leaf_key(name, len(shape))[0])
    assert {k for k in keys if k[:4] in ("ssm.", "rec.")} == {
        "ssm.in_proj", "ssm.conv_w", "ssm.out_norm", "ssm.out_proj",
        "rec.w_x", "rec.w_y", "rec.conv_w", "rec.w_a", "rec.w_i", "rec.out"}


def _round_trip(arch, tp, over=None):
    cfg, rcfg = _cfg(arch, over), RunConfig(compute_dtype="float32")
    params = _params(arch, {"compute_dtype": "float32"}, over or {})
    shards = [bridge._flatten(bridge.to_jax_params(bridge.shard_jax_params(
        params, cfg, Mesh(("data", "model"), (1, tp), rank=r), device="cpu")))
        for r in range(tp)]
    return bridge._flatten(params), shards, tsh.unshard_params(shards, cfg,
                                                               _padded_vocab(cfg, rcfg))


def _same_tree(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(
        got[k].shape == want[k].shape and np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", [SSM, REC])
def test_shard_then_unshard_gives_the_tree_back(arch, tp):
    want, shards, got = _round_trip(arch, tp)
    assert _same_tree(got, want)
    split = [k for k in want if (".ssm." in k or ".rec." in k)
             and shards[0][k].shape != want[k].shape]
    assert len(split) == (4 if arch == SSM else 24), split   # 4 rec blocks of 6 leaves


def test_a_layout_that_disagrees_with_itself_fails_the_round_trip(monkeypatch):
    """Plant back the layout fault the sharding module once had:
    ``_full_size`` knows no ssm or rec leaf, so ``local_model_cut`` calls
    each rank's slice whole while ``shard_params`` cut it. The round trip
    then no longer gives the tree back."""
    real = tsh._full_size
    monkeypatch.setattr(tsh, "_full_size", lambda name, *a: None if (
        ".ssm." in name or ".rec." in name) else real(name, *a))
    for arch in (SSM, REC):
        want, _, got = _round_trip(arch, 2)
        assert not _same_tree(got, want), arch


@pytest.mark.parametrize("tp", [2, 4])
def test_a_ranks_in_proj_holds_its_heads_and_the_whole_b_c(tp):
    """mamba2 smoke (din 128, 8 heads, one group of state 16): rank r's
    ``in_proj`` columns are its heads' z, x and dt with B and C whole, and
    its ``conv_w`` its heads' x with B and C whole."""
    cfg = get_config(SSM)
    din, st, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
    w = torch.arange(2 * 64 * (2 * din + 2 * st + nh), dtype=torch.float32).view(2, 64, -1)
    conv = torch.arange(2 * 4 * (din + 2 * st), dtype=torch.float32).view(2, 4, -1)
    dl, hl = din // tp, nh // tp
    for r in range(tp):
        mine = tsh.shard_params({"s.0.0.ssm.in_proj": w, "s.0.0.ssm.conv_w": conv},
                                Mesh(("data", "model"), (1, tp), rank=r), cfg.head_dim, cfg)
        cols = torch.cat([torch.arange(r * dl, (r + 1) * dl),
                          din + torch.arange(r * dl, (r + 1) * dl),
                          torch.arange(2 * din, 2 * din + 2 * st),
                          2 * din + 2 * st + torch.arange(r * hl, (r + 1) * hl)])
        assert torch.equal(mine["s.0.0.ssm.in_proj"], w[..., cols])
        assert mine["s.0.0.ssm.in_proj"].shape[-1] == 2 * dl + 2 * st + hl
        ccols = torch.cat([torch.arange(r * dl, (r + 1) * dl), torch.arange(din, din + 2 * st)])
        assert torch.equal(mine["s.0.0.ssm.conv_w"], conv[..., ccols])


@pytest.mark.parametrize("over,tp,split", [({}, 3, False), ({"ssm_ngroups": 2}, 4, False),
                                           ({"ssm_ngroups": 2}, 2, True)])
def test_uneven_heads_or_groups_keep_the_ssm_leaves_whole(over, tp, split):
    """8 heads at tp 3, or 2 groups at tp 4: every ssm leaf whole on every
    rank (and the round trip still exact); 2 groups at tp 2: the groups'
    B / C columns split with the heads."""
    cfg = _cfg(SSM, over)
    assert tsh.ssm_splits(cfg, tp) == split
    want, shards, got = _round_trip(SSM, tp, over)
    assert _same_tree(got, want)
    cut = [k for k in want if ".ssm." in k and shards[0][k].shape != want[k].shape]
    assert bool(cut) == split
    if split:
        inp = tsh.model_cut("stages.0.0.ssm.in_proj", want["stages.0.0.ssm.in_proj"].shape,
                            tp, cfg=cfg)
        assert all(s for _, s in inp.parts)


def test_the_global_norm_counts_a_whole_part_once(monkeypatch):
    """Two ranks' slices of a mixed leaf (split columns and a whole part)
    and a whole leaf: the norm equals the whole tree's, the model group's
    sum of the split squares stood in for by adding the other rank's."""
    import repro_torch.runtime.collectives as coll

    cfg = get_config(SSM)
    name, whole = "stages.0.0.ssm.in_proj", "stages.0.0.ssm.a_log"
    gen = torch.Generator().manual_seed(0)
    full = torch.randn(2, 64, 2 * cfg.ssm_d_inner + 2 * cfg.ssm_state + cfg.ssm_nheads,
                       generator=gen)
    a_log = torch.randn(8, generator=gen)
    cut = tsh.model_cut(name, full.shape, 2, cfg=cfg)
    parts = [cut.take(full, r, 2) for r in range(2)]
    sq = lambda t: t.square().sum()
    other = sq(parts[1]) - sum(sq(parts[1][i]) for i in cut.whole_index(2))
    monkeypatch.setattr(coll, "reduce_from_model", lambda x, mg: x + other)
    _, gn = clip_by_global_norm({name: parts[0].clone(), whole: a_log.clone()}, 1e9,
                                model_split=({name: cut, whole: None},
                                             types.SimpleNamespace(tp=2)))
    torch.testing.assert_close(gn, torch.sqrt(sq(full) + sq(a_log)), rtol=1e-6, atol=0)


def test_zero1_keeps_off_the_model_cut():
    """ZeRO-1's moment slices of a rank's mixed ``in_proj`` take another
    dimension than the model axis's cut."""
    cfg = get_config(SSM)
    cut = tsh.model_cut("stages.0.0.ssm.in_proj", (2, 64, 296), 2, cfg=cfg)
    assert tsh.zero1_dim("stages.0.0.ssm.in_proj", (2, 64, cut.local_size(2)), 2) == 0
    assert tsh.zero1_dim("stages.0.0.rec.w_a", (4, 64, 32), 4) == 0
    assert tsh.zero1_dim("stages.0.0.rec.w_a", (3, 64, 32), 4) == 1


def test_validate_admits_ssm_rec_latt_and_names_xattns_slice():
    """ssm, rec and latt are admitted, and so is xattn, which came with
    the slice after theirs; a kind without a model-axis layout is named
    in the refusal."""
    for arch in (SSM, REC, "internlm2-1.8b_smoke", "llama-3.2-vision-11b_smoke"):
        tsh.validate_tensor_parallel(get_config(arch), RunConfig(), 2)
    odd = _cfg(SSM, {"stages": ((("ssm", "odd"), 1),)})
    with pytest.raises(NotImplementedError, match=r"\['odd'\] has none"):
        tsh.validate_tensor_parallel(odd, RunConfig(), 2)


def test_train_cli_ssm_tensor_parallel_on_the_cpu(capfd):
    from repro_torch.launch import train

    train.main(["--arch", SSM, "--device", "cpu", "--steps", "2", "--seq-len", "32",
                "--global-batch", "4", "--compression", SSM_SPEC, "--log-every", "1",
                "--executor", "shard_map", "--data-model", "1", "2"])
    out = capfd.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "done: 2 steps on 2 ranks (data 1 x model 2)" in out
