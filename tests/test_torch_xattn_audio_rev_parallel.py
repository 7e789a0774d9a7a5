"""The port's model axis for the xattn kind, musicgen's four-codebook head
and reversible blocks on the CPU, against the JAX package.

On one spawned (data 1, model 2) gloo group (``repro_torch.launch.ranks``,
jobs in ``tests/torch_rank_jobs.py``), f32, batches of ``SyntheticStream``
(global 8 x 32, seed 0), the same parameters in both packages (drawn by
the port, bridged to JAX; each rank takes its slices with
``bridge.shard_jax_params``), each case against the JAX single-device
``make_train_step`` at ``tests/test_torch_tensor_parallel.py``'s bounds
(loss and NLL 5e-5, grad_norm relative 5e-5, the parameters gathered over
the model ranks 5e-4) and every site's telemetry at 1e-6:

  * llama-3.2-vision smoke under ``attn.qkv`` and ``attn.cross_kv`` PAMM,
    both gates of its xattn block nonzero (zero gates make the block the
    identity and leave the cross-attention without a gradient), two
    steps, each rank holding 2 of the 4 q heads and 1 of the 2 K/V heads
    of every block; and one step with ``n_kv_heads=1``, the K/V head
    whole on both ranks;
  * musicgen smoke under ``attn.qkv`` PAMM, with and without ``lm_head``
    PAMM, one step each, each rank holding half of every codebook's 64
    head columns;
  * reversible internlm2 smoke (two steps), granite-moe smoke (experts
    over the model axis inside G) and recurrentgemma smoke (rec and latt
    blocks) (one step each);
  * ``seq_shard=True`` runs of vision, musicgen and reversible internlm2,
    each over its residual case's steps and held to that case's JAX run
    (the sequence split is the port's; JAX runs the same step);
  * planted faults, each of which must fail that check: ``gate_attn``
    applied before the row-parallel sum, ``gate_attn``'s gradient left
    unsummed under ``seq_shard``, the head cut contiguously (whole
    codebooks a rank), the reversible sublayers' norms without
    ``seq_param`` under ``seq_shard``.

The ranks draw what one process draws: the JAX draws, recorded by a
single-process port run through the JAX sampler and looked up on the
ranks (``TableSampler``). The reversible internlm2 ranks also record their
first step's stream adds: the backward rebuilds every f32 stream bit for
bit, the recomputed all-reduces included.

In-process: ``model_cut`` of every cross-attention leaf and of musicgen's
head against ``logical_to_pspec`` at tp 2 and 4 (the codebook cut the
listed departure), ``local_model_cut`` of a rank's slice naming that cut;
shard-then-unshard round trips of both trees; a rank's head columns; the
global norm's count of the gates; ZeRO-1 off the codebook cut; the CLI on
vision smoke with ``--data-model 1 2``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import RunConfig, get_config
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models.model import _padded_vocab
from repro_torch.optim.optimizers import clip_by_global_norm
from repro_torch.runtime import sharding as tsh
from tests import torch_rank_jobs
from tests.test_torch_ssm_rec_parallel import _leaves, _round_trip, _same_tree
from tests.test_torch_tensor_parallel import (_batches, _hold, _jax_run, _params,
                                              _port_single, _rcfg)
from tests.test_torch_xattn import set_gates

VIS, AUDIO = "llama-3.2-vision-11b_smoke", "musicgen-medium_smoke"
INTERN, MOE, REC = "internlm2-1.8b_smoke", "granite-moe-3b-a800m_smoke", "recurrentgemma-9b_smoke"
VIS_SPEC = "attn.qkv=pamm(r=1/8);attn.cross_kv=pamm(r=1/8)"
QKV = "attn.qkv=pamm(r=1/8)"
HEAD = QKV + ";lm_head=pamm(r=1/8)"
REV = {"block_structure": "reversible"}
# (id, arch, compression, RunConfig fields, config fields, first step index,
# number of steps)
CASES = [
    ("vision", VIS, VIS_SPEC, {}, {}, 0, 2),
    ("vision-kv-whole", VIS, VIS_SPEC, {}, {"n_kv_heads": 1}, 1, 1),
    ("musicgen", AUDIO, QKV, {}, {}, 1, 1),
    ("musicgen-lm-head", AUDIO, HEAD, {}, {}, 1, 1),
    ("internlm2-rev", INTERN, QKV, REV, {}, 0, 2),
    ("granite-rev", MOE, QKV + ";moe.expert=pamm(r=1/8)", REV, {}, 1, 1),
    ("recurrentgemma-rev", REC, QKV + ";rglru.in=pamm(r=1/8)", REV, {}, 1, 1),
]
# seq_shard runs: the residual (or reversible) case whose draws, steps and
# JAX run they share
SEQ_SHARD = {"vision-seq-shard": "vision", "musicgen-seq-shard": "musicgen",
             "internlm2-rev-seq-shard": "internlm2-rev"}
# planted fault (tests/torch_rank_jobs.py): the run it is planted in
PLANTS = {"gate_before_exit": "vision-kv-whole", "gate_unsummed": "vision-seq-shard",
          "head_contiguous": "musicgen", "rev_norm_unsummed": "internlm2-rev-seq-shard"}


def _gated(params: dict, cfg) -> dict:
    """The numpy tree with every xattn block's gates set nonzero."""
    for (unit, _), stage in zip(cfg.stages, params["stages"]):
        for kind, node in zip(unit, stage):
            if kind == "xattn":
                set_gates(node)
    return params


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
    for cid, arch, spec, rk, over, start, steps in CASES:
        rk = _rcfg(compression=spec, **rk)
        cfg = dataclasses.replace(get_config(arch), **over)
        plans[cid] = (arch, _gated(_params(arch, rk, over), cfg), rk, over,
                      _batches(arch, steps, over), start)
        tables[cid] = _port_single(*plans[cid])

    def run(cid, plant=None):
        base = SEQ_SHARD.get(cid, cid)
        arch, p, rk, over, b, s = plans[base]
        if base != cid:
            rk = {**rk, "seq_shard": True}
        collect = ("params", "streams") if cid == "internlm2-rev" else ("params",)
        return {"arch": arch, "rcfg": rk, "cfg": over, "params": p, "batches": b, "start": s,
                "sampler": torch_rank_jobs.TableSampler(tables[base]), "plant": plant,
                "collect": collect}

    ids = [c[0] for c in CASES] + list(SEQ_SHARD)
    jobs = [run(cid) for cid in ids] + [run(cid, plant) for plant, cid in PLANTS.items()]
    group = spawn_ranks(2, torch_rank_jobs.job, (1, 2), [], jobs,
                        timeout=torch_rank_jobs.TIMEOUT)
    ref = {cid: _jax_run(*plan) for cid, plan in plans.items()}
    got = [r["runs"] for r in group.results()]
    return ({cid: [r[i] for r in got] for i, cid in enumerate(ids)},
            {plant: [r[len(ids) + i] for r in got] for i, plant in enumerate(PLANTS)},
            {cid: ref[SEQ_SHARD.get(cid, cid)] for cid in ids})


@pytest.mark.parametrize("cid", [c[0] for c in CASES] + list(SEQ_SHARD))
def test_model_axis_matches_jax_single_device(runs, cid):
    """Losses, grad norms and the gathered parameters against the JAX
    step; each site's telemetry equal to the JAX step's."""
    got, _, ref = runs
    _hold(got[cid], ref[cid])
    for want, have in zip(ref[cid][1], got[cid][0]["metrics"]):
        sites = [k for k in want if k.startswith("site/")]
        assert sites and all(have[k] == pytest.approx(want[k], rel=1e-6) for k in sites), \
            {k: (have.get(k), want[k]) for k in sites}


@pytest.mark.parametrize("plant", list(PLANTS))
def test_a_planted_fault_fails_the_parity_check(runs, plant):
    _, planted, ref = runs
    with pytest.raises(AssertionError):
        _hold(planted[plant], ref[PLANTS[plant]])


def test_reversible_streams_rebuild_bit_for_bit_on_the_ranks(runs):
    """f32, model 2: on each rank, every layer input the backward rebuilds
    equals the forward's, hi and lo, bit for bit, and every recomputed
    sublayer output -- its all-reduced row-parallel sums among them --
    equals the forward's."""
    got, _, _ = runs
    for rank in got["internlm2-rev"]:
        assert rank["streams"] and all(rank["streams"]), rank["streams"]


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------
def _xattn_or_head(arch, name) -> bool:
    cfg = get_config(arch)
    if name == "head":
        return True
    parts = name.split(".")
    return parts[0] == "stages" and cfg.stages[int(parts[1])][0][int(parts[2])] == "xattn"


@pytest.mark.parametrize("tp", [2, 4])
def test_model_cut_matches_jax_but_for_the_codebook_cut(tp):
    """Every leaf of vision smoke's xattn block and musicgen's head: the
    port cuts JAX's dimension (its uneven dimensions dropped), the K/V
    leaves in whole heads (whole where tp exceeds the heads), the gates
    whole; the departure is musicgen's head, cut by codebooks in JAX's
    dimension. ``local_model_cut`` of a rank's slice names the same cut."""
    departed, seen = set(), set()
    for arch in (VIS, AUDIO):
        cfg, rcfg = get_config(arch), RunConfig()
        for name, shape, want in _leaves(arch):
            if not _xattn_or_head(arch, name):
                continue
            if want is not None and shape[want] % tp:
                want = None
            cut = tsh.model_cut(name, shape, tp, cfg.head_dim, cfg)
            leaf = tsh._leaf_key(name, len(shape))[0]
            seen.add(leaf)
            if leaf in tsh.KV_HEAD_LEAVES and shape[-1] % (tp * cfg.head_dim):
                assert want is not None and cut is None, (name, tp)
            elif arch == AUDIO:
                assert cut.dim == want and cut.parts == ((cfg.vocab_size, True),) * 4, name
                departed.add(name)
            else:
                assert (None if cut is None else cut.dim) == want, (arch, name)
                assert cut is None or cut.contiguous
            local = list(shape)
            if cut is not None:
                local[cut.dim] = cut.local_size(tp)
            assert tsh.local_model_cut(name, local, cfg, _padded_vocab(cfg, rcfg)) == cut
    assert departed == {"head"}
    assert {"wq", "wk", "wv", "wo", "gate_attn", "gate_ffn", "norm1", "w_gate"} <= seen


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", [VIS, AUDIO])
def test_shard_then_unshard_gives_the_tree_back(arch, tp):
    want, shards, got = _round_trip(arch, tp)
    assert _same_tree(got, want)
    if arch == AUDIO:
        # rank r's head: its 1/tp of each codebook's 64 columns, in order
        v = get_config(AUDIO).vocab_size
        for r, shard in enumerate(shards):
            cols = np.concatenate([c * v + np.arange(r * v // tp, (r + 1) * v // tp)
                                   for c in range(4)])
            np.testing.assert_array_equal(shard["head"], want["head"][:, cols])


def test_the_global_norm_counts_the_gates_once(monkeypatch):
    """A rank's slices of a cross-attention wq and two whole gates: the
    norm equals the whole tree's, the model group's sum of the split
    squares stood in for by adding the other rank's."""
    import repro_torch.runtime.collectives as coll

    cfg = get_config(VIS)
    gen = torch.Generator().manual_seed(0)
    wq = torch.randn(1, 64, 64, generator=gen)
    gates = {"stages.0.4.attn.gate_attn": torch.randn(1, generator=gen),
             "stages.0.4.gate_ffn": torch.randn(1, generator=gen)}
    name = "stages.0.4.attn.wq"
    cut = tsh.model_cut(name, wq.shape, 2, cfg.head_dim, cfg)
    parts = [cut.take(wq, r, 2) for r in range(2)]
    monkeypatch.setattr(coll, "reduce_from_model",
                        lambda x, mg: x + parts[1].square().sum())
    local = {name: parts[0].clone(), **{n: g.clone() for n, g in gates.items()}}
    layout = tsh.model_layout(local, cfg, _padded_vocab(cfg, RunConfig()))
    assert layout[name] == cut and all(layout[n] is None for n in gates)
    _, gn = clip_by_global_norm(local, 1e9, model_split=(layout, types.SimpleNamespace(tp=2)))
    want = torch.sqrt(wq.square().sum() + sum(g.square().sum() for g in gates.values()))
    torch.testing.assert_close(gn, want, rtol=1e-6, atol=0)


def test_zero1_keeps_off_the_codebook_cut():
    """A rank's (d, 4 x V/tp) head: ZeRO-1 splits its rows, not the
    columns the model axis cut by codebooks."""
    cfg = get_config(AUDIO)
    cut = tsh.model_cut("head", (64, 256), 2, cfg.head_dim, cfg)
    assert cut.local_size(2) == 128 and not cut.contiguous
    assert tsh.zero1_dim("head", (64, cut.local_size(2)), 2) == 0


def test_validate_admits_xattn_reversible_and_musicgen():
    for arch in (VIS, AUDIO, INTERN, MOE, REC):
        for structure in ("residual", "reversible"):
            tsh.validate_tensor_parallel(get_config(arch),
                                         RunConfig(block_structure=structure), 2)
    tsh.validate_tensor_parallel(get_config(VIS), RunConfig(), 4)
    tsh.validate_tensor_parallel(get_config(AUDIO), RunConfig(), 4)


def test_train_cli_vision_tensor_parallel_on_the_cpu(capfd):
    from repro_torch.launch import train

    train.main(["--arch", VIS, "--device", "cpu", "--steps", "2", "--seq-len", "32",
                "--global-batch", "4", "--compression", VIS_SPEC, "--log-every", "1",
                "--executor", "shard_map", "--data-model", "1", "2"])
    out = capfd.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "done: 2 steps on 2 ranks (data 1 x model 2)" in out
