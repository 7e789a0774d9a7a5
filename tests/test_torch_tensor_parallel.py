"""The port's tensor parallelism (the model axis) on the CPU, against the
JAX package (after ``tests/test_multidevice.py:114-156``, which needs
several JAX devices and skips on one).

On gloo ranks (``repro_torch.launch.ranks``; one spawned group per mesh
shape, every case inside it, running ``tests/torch_rank_jobs.py``), f32,
batches of ``SyntheticStream`` (global 8 x 32, seed 0), the same
parameters in both packages (drawn by the port, bridged to JAX; each rank
takes its model-axis slices with ``bridge.shard_jax_params``):

  * meshes (1, 2) and (2, 2), three steps of llama-tiny under
    ``attn.qkv=pamm(r=1/8)``, against the JAX single-device
    ``make_train_step`` with ``blocks=dp``: loss and NLL within 5e-5,
    grad_norm relative 5e-5, every parameter (gathered over the model
    ranks) within 5e-4 (``tests/test_multidevice.py``'s bounds). The model
    ranks draw the same generator rows: the JAX draws, recorded by a
    single-process port step through ``JaxSampler`` and looked up on the
    ranks (``TableSampler``); the (2, 2) ranks' ZeRO-1 moment slices are
    their model and data slices of the gathered whole;
  * (4, 1) against (2, 2) with exact compression (``:143-156``);
  * one (1, 2) step (step index 1, so the rate is not 0) each for
    internlm2 smoke (GQA 4/2), qwen2 smoke (qkv_bias), qwen3 smoke
    (qk_norm), h2o-danube smoke (swa), ``ffn.gate/up=pamm`` with
    ``lm_head=pamm``, a padded odd vocabulary (250 padded to 256) and
    ``seq_shard=True``, each against the JAX step at the same bounds.

In-process: ``model_cut``'s dimension against ``logical_to_pspec`` of the JAX
``param_specs`` for every leaf of every dense smoke arch at tp 2 and 4;
``shard_jax_params`` then ``unshard_params`` gives the tree back bit for
bit; the CLI ``--data-model 1 2 --device cpu``; the refusal texts of what
a model degree above 1 still refuses (adafactor, int8_ef, a context
degree, a block kind without a layout), and that what it once refused
builds (``moe`` and a compressed ``ffn.down``:
``tests/test_torch_expert_parallel.py``; ``ssm``, ``rec`` and ``latt``:
``tests/test_torch_ssm_rec_parallel.py``; ``xattn``, reversible blocks and
musicgen: ``tests/test_torch_xattn_audio_rev_parallel.py``).
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
from repro.data import SyntheticStream
from repro.models import param_specs as jax_param_specs
from repro.optim import make_optimizer as jax_make_optimizer
from repro.runtime.sharding import logical_to_pspec
from repro.train import TrainState as JaxTrainState
from repro.train import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config
from repro_torch.launch.mesh import Mesh, make_debug_mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import init_model
from repro_torch.models.model import _padded_vocab
from repro_torch.optim import adamw_init
from repro_torch.runtime import sharding as tsh
from repro_torch.train import TrainState, make_train_step
from repro_torch.train.distributed import make_shard_map_train_step
from tests import torch_rank_jobs
from tests.test_torch_distributed import _Recording

ARCH = "llama-tiny"
SPEC = "attn.qkv=pamm(r=1/8)"
STEPS = 3
DENSE_SMOKE = ["internlm2-1.8b_smoke", "qwen2-72b_smoke", "qwen3-32b_smoke",
               "h2o-danube-3-4b_smoke"]
# one (1, 2) step each: (id, arch, compression, RunConfig fields, config fields)
CASES = [(a.split("-")[0], a, SPEC, {}, {}) for a in DENSE_SMOKE] + [
    ("ffn-head-pamm", "internlm2-1.8b_smoke",
     SPEC + ";ffn.*=pamm(r=1/8);ffn.down=none;lm_head=pamm(r=1/8)", {}, {}),
    ("odd-vocab", "internlm2-1.8b_smoke", SPEC, {"pad_vocab_multiple": 8},
     {"vocab_size": 250}),
    ("seq-shard", "internlm2-1.8b_smoke", SPEC, {"seq_shard": True, "remat": "pamm"}, {}),
]


def _rcfg(**kw):
    base = dict(compression=SPEC, lr=5e-3, compute_dtype="float32", param_dtype="float32")
    base.update(kw)
    return base


def _blocked(spec, n):
    """Every rule of ``spec`` with ``blocks=n``."""
    return ";".join(r[:-1] + f",blocks={n})" if r.endswith(")") else r
                    for r in spec.split(";"))


def _batches(arch, n, over=None):
    cfg = dataclasses.replace(jax_get_config(arch), **(over or {}))
    stream = SyntheticStream.for_arch(cfg, 32, 8, seed=0)
    return [stream.get_batch(i) for i in range(n)]


def _params(arch, rk, over):
    cfg = dataclasses.replace(get_config(arch), **over)
    return bridge.to_jax_params(init_model(cfg, RunConfig(**rk), seed=0, device="cpu"))


def _port_single(arch, params, rk, over, batches, start):
    """The port's single-process steps, drawing the JAX chain: the draws."""
    cfg = dataclasses.replace(get_config(arch), **over)
    rcfg = RunConfig(**rk)
    model = bridge.from_jax_params(params, cfg, device="cpu", trainable=True)
    state = TrainState(model, adamw_init(dict(model.named_parameters())))
    sampler = _Recording()
    step = make_train_step(cfg, rcfg, total_steps=start + len(batches), sampler=sampler)
    for i, b in enumerate(batches, start=start):
        state, _ = step(state, b, i)
    return sampler.table


def _jax_run(arch, params, rk, over, batches, start):
    jr = JaxRunConfig(**rk, attn_kernel="jnp")
    jp = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(params=jp, opt=jax_make_optimizer("adamw")[0](jp))
    cfg = dataclasses.replace(jax_get_config(arch), **over)
    fn = jax.jit(jax_make_train_step(cfg, jr, total_steps=start + len(batches)))
    out = []
    for i, b in enumerate(batches, start=start):
        state, m = fn(state, {k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(i))
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """Record the draws, start the (1, 2), (2, 2) and (4, 1) groups, run
    the JAX references while they train, then collect."""
    params = _params(ARCH, _rcfg(), {})
    batches = _batches(ARCH, STEPS)
    plans = {}     # key -> (arch, params, RunConfig fields, cfg fields, batches, start)
    for dp in (1, 2):
        plans[("pamm", dp)] = (ARCH, params, _rcfg(compression=_blocked(SPEC, dp)), {},
                               batches, 0)
    for cid, arch, spec, rk, over in CASES:
        plans[cid] = (arch, _params(arch, _rcfg(**rk), over), _rcfg(compression=spec, **rk),
                      over, _batches(arch, 1, over), 1)
    tables = {k: _port_single(a, p, rk, over, b, s)
              for k, (a, p, rk, over, b, s) in plans.items()}

    def run(key, collect=("params",)):
        arch, p, rk, over, b, s = plans[key]
        # the ranks resolve blocks=auto from their mesh: the spec without blocks
        rk = {**rk, "compression": rk["compression"].replace(",blocks=2", "")
              .replace(",blocks=1", "")}
        return {"arch": arch, "rcfg": rk, "cfg": over, "params": p, "batches": b,
                "start": s, "sampler": torch_rank_jobs.TableSampler(tables[key]),
                "collect": collect}

    exact = {"arch": ARCH, "rcfg": _rcfg(compression="", policy_name="none"),
             "params": params, "batches": batches, "collect": ("params",)}
    started = {
        (1, 2): spawn_ranks(2, torch_rank_jobs.job, (1, 2), [],
                            [run(("pamm", 1))] + [run(c[0]) for c in CASES],
                            timeout=torch_rank_jobs.TIMEOUT),
        (2, 2): spawn_ranks(4, torch_rank_jobs.job, (2, 2), [],
                            [run(("pamm", 2), ("params", "state", "local")), exact],
                            timeout=torch_rank_jobs.TIMEOUT),
        (4, 1): spawn_ranks(4, torch_rank_jobs.job, (4, 1), [], [exact],
                            timeout=torch_rank_jobs.TIMEOUT)}
    ref = {k: _jax_run(a, p, rk, over, b, s) for k, (a, p, rk, over, b, s) in plans.items()}
    got = {shape: [r["runs"] for r in g.results()] for shape, g in started.items()}
    return got, ref


def _hold(ranks: list, ref):
    """Every rank's metrics equal; rank 0's against the JAX run."""
    state_j, mj = ref
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    for a, b in zip(mj, ranks[0]["metrics"]):
        assert a["loss"] == pytest.approx(b["loss"], abs=5e-5)
        assert a["nll"] == pytest.approx(b["nll"], abs=5e-5)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=5e-5)
    want = _flat(state_j.params)
    assert set(want) == set(ranks[0]["params"])
    for k in want:
        assert ranks[0]["params"][k].shape == want[k].shape, k
    assert max(np.abs(ranks[0]["params"][k] - want[k]).max() for k in want) < 5e-4


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["dp1-tp2", "dp2-tp2"])
def test_train_step_matches_jax_blocked_single_device(runs, shape):
    got, ref = runs
    _hold([r[0] for r in got[shape]], ref[("pamm", shape[0])])


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_dense_variants_one_step_match_jax(runs, cid):
    got, ref = runs
    i = 1 + [c[0] for c in CASES].index(cid)
    _hold([r[i] for r in got[(1, 2)]], ref[cid])


def test_mesh_shapes_agree_with_exact_compression(runs):
    """(data 4) and (data 2, model 2) with exact compression agree: the
    distributed math is mesh-shape independent (``:143-156``)."""
    got, _ = runs
    a, b = got[(4, 1)][0][0], got[(2, 2)][0][1]
    for x, y in zip(a["metrics"], b["metrics"]):
        assert x["loss"] == pytest.approx(y["loss"], abs=5e-5)
    assert max(np.abs(a["params"][k] - b["params"][k]).max() for k in a["params"]) < 5e-4


def test_moment_slices_are_the_ranks_model_and_data_slices(runs):
    """On (2, 2) each rank's AdamW moments are its model slice of the
    whole, then its ZeRO-1 data slice of that; the gathered whole equals
    the JAX moments (1e-6)."""
    got, ref = runs
    state_j = ref[("pamm", 2)][0]
    run0 = got[(2, 2)][0][0]
    want = _flat(state_j.opt.m)
    assert max(np.abs(run0["m"][k] - want[k]).max() for k in want) < 1e-6
    cfg = get_config(ARCH)
    mesh = Mesh(("data", "model"), (2, 2))
    for r, ranks in enumerate(got[(2, 2)]):
        local = ranks[0]
        coord = dataclasses.replace(mesh, rank=r)
        for name, whole in run0["m"].items():
            part = tsh.shard_params({name: torch.from_numpy(whole)}, coord,
                                    cfg.head_dim)[name]
            part = tsh.shard_slice(part, local["layout"][name], coord.coord("data"), 2)
            np.testing.assert_array_equal(local["m_local"][name], part.numpy())


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------
def _cut_dim(cut):
    return None if cut is None else cut.dim


@pytest.mark.parametrize("tp", [2, 4])
def test_model_dim_matches_jax_logical_to_pspec(tp):
    """The dimension of ``model_cut`` against ``logical_to_pspec`` of the
    JAX ``param_specs`` with the uneven dimensions dropped (``sanitize_shardings``), leaf by
    leaf. The port splits the head leaves in whole heads: where tp divides
    the columns but not the head count (2 K/V heads at tp 4), GSPMD splits
    inside a head and the port keeps the leaf whole on every rank."""
    jmesh = types.SimpleNamespace(axis_names=("data", "model"))
    is_leaf = lambda s: isinstance(s, tuple) and all(isinstance(x, (str, type(None)))
                                                     for x in s)
    whole_heads = 0
    for arch in DENSE_SMOKE + [ARCH]:
        cfg = jax_get_config(arch)
        shapes, specs = jax_param_specs(cfg, JaxRunConfig())
        for (path, shp), logical in zip(jax.tree_util.tree_leaves_with_path(shapes),
                                        jax.tree.leaves(specs, is_leaf=is_leaf)):
            name = jax.tree_util.keystr(path, simple=True, separator=".")
            ps = tuple(logical_to_pspec(logical, jmesh))
            want = next((i for i, e in enumerate(ps) if e == "model"), None)
            if want is not None and shp.shape[want] % tp:
                want = None
            got = _cut_dim(tsh.model_cut(name, shp.shape, tp, cfg.head_dim))
            leaf = name.rsplit(".", 1)[-1]
            if (want is not None and leaf in tsh.Q_HEAD_LEAVES + tsh.KV_HEAD_LEAVES
                    and shp.shape[want] % (tp * cfg.head_dim)):
                assert got is None, (arch, name)
                whole_heads += 1
                continue
            assert got == want, (arch, name, logical)
    assert (whole_heads > 0) == (tp == 4)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_then_gather_gives_the_tree_back(tp):
    for arch in DENSE_SMOKE + [ARCH]:
        cfg, rcfg = get_config(arch), RunConfig(compute_dtype="float32")
        params = bridge.to_jax_params(init_model(cfg, rcfg, seed=1, device="cpu"))
        shards = [bridge.to_jax_params(bridge.shard_jax_params(
            params, cfg, Mesh(("data", "model"), (1, tp), rank=r), device="cpu"))
            for r in range(tp)]
        got = tsh.unshard_params([bridge._flatten(s) for s in shards], cfg,
                                 _padded_vocab(cfg, rcfg))
        want = bridge._flatten(params)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        split = sum(bridge._flatten(shards[0])[k].shape != want[k].shape for k in want)
        assert split >= 7, (arch, split)       # embed, head, wq, wo and the FFN at least


def test_init_model_on_a_mesh_keeps_this_ranks_slices():
    """``init_model(mesh=)`` draws as one process and keeps its slices."""
    cfg, rcfg = get_config("internlm2-1.8b_smoke"), RunConfig()
    whole = dict(init_model(cfg, rcfg, seed=3, device="cpu").named_parameters())
    for r in range(2):
        mesh = Mesh(("data", "model"), (1, 2), rank=r)
        mine = dict(init_model(cfg, rcfg, seed=3, device="cpu", mesh=mesh).named_parameters())
        want = tsh.shard_params(whole, mesh, cfg.head_dim)
        for k, t in want.items():
            torch.testing.assert_close(mine[k], t, rtol=0, atol=0)


def test_train_cli_tensor_parallel_on_the_cpu(capfd):
    """``--executor shard_map --data-model 1 2`` starts two ranks and trains
    with finite losses (rank 0 logs every step)."""
    from repro_torch.launch import train

    train.main(["--arch", "internlm2-1.8b_smoke", "--device", "cpu", "--steps", "3",
                "--seq-len", "32", "--global-batch", "4", "--compression", SPEC,
                "--log-every", "1", "--executor", "shard_map", "--data-model", "1", "2"])
    out = capfd.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "done: 3 steps on 2 ranks (data 1 x model 2)" in out


def _refusal(arch, **rk):
    cfg = get_config(arch)
    with pytest.raises(NotImplementedError) as ei:
        make_shard_map_train_step(cfg, RunConfig(**rk), mesh=Mesh(("data", "model"), (1, 2)))
    return str(ei.value)


def test_refusals_name_their_later_slices(capsys):
    """What a model degree above 1 still refuses names the slice that
    brings it; the kinds, structures and frontends it once refused build
    (their parity: tests/test_torch_xattn_audio_rev_parallel.py)."""
    mesh = Mesh(("data", "model"), (1, 2))
    for arch, rk in (("llama-3.2-vision-11b_smoke", {}),
                     ("internlm2-1.8b_smoke", {"block_structure": "reversible"}),
                     ("granite-moe-3b-a800m_smoke", {"block_structure": "reversible"}),
                     ("musicgen-medium_smoke", {})):
        make_shard_map_train_step(get_config(arch), RunConfig(**rk), mesh=mesh)
    odd = dataclasses.replace(get_config("internlm2-1.8b_smoke"), stages=((("odd",), 2),))
    with pytest.raises(NotImplementedError) as ei:
        tsh.validate_tensor_parallel(odd, RunConfig(), 2)
    assert "['odd'] has none" in str(ei.value) and "'xattn'" in str(ei.value)
    for text, what in ((_refusal("internlm2-1.8b_smoke", optimizer="adafactor"),
                        "factored moments"),
                       (_refusal("internlm2-1.8b_smoke", grad_compress="int8_ef"),
                        "int8 scale")):
        assert what in text and "the next tensor-parallel slice" in text, text
    with pytest.raises(NotImplementedError, match="ring inside tensor-parallel attention"):
        make_debug_mesh(1, 2, 2)
    from repro_torch.launch import train

    with pytest.raises(SystemExit):
        train.main(["--arch", "llama-3.2-vision-11b_smoke", "--device", "cpu", "--executor",
                    "shard_map", "--data-model", "1", "2", "--grad-compress", "int8_ef"])
    assert "the next tensor-parallel slice" in capsys.readouterr().err
