"""The port's mesh executor on the CPU, data-parallel, against the JAX
package (after ``tests/test_multidevice.py``, which needs several JAX
devices and skips on one).

On gloo ranks (``repro_torch.launch.ranks``; one spawned group per mesh
shape, every case inside it, running ``tests/torch_rank_jobs.py``),
llama-tiny, f32, ``attn.qkv=pamm(r)`` with ``blocks=auto`` (= the data
degree), batches of ``SyntheticStream`` (global 8 x 32, seed 0), the same
parameters (drawn by the port, bridged to JAX):

  * 4 ranks, r = 1/8, 1/20 (13 generators, not a multiple of 4) and 1/256
    (one generator for four blocks), and 2 ranks at r = 1/8: three steps
    against the JAX package's single-device ``make_train_step`` with
    ``blocks=4`` (``blocks=2``) -- loss and NLL within 5e-5, grad_norm
    relative 5e-5, every parameter within 5e-4 after three steps
    (``tests/test_multidevice.py``'s bounds). The ranks draw the JAX key
    chain's rows: a single-process port step with ``blocks=n`` records
    them through ``JaxSampler`` and the ranks look them up
    (``TableSampler``); a rank's draw is the blocked step's draw of its
    block exactly when :func:`shard_site_key` gives it that block's key,
    and a draw the table lacks fails the rank. The ranks are also held to
    that single-process port step (1e-5);
  * the telemetry summed across the ranks equals the single-device
    blocked run's (stored MiB relative 1e-6, kept fraction and beta 1);
  * the ZeRO-1 moments gathered from the ranks equal the JAX moments
    after three steps (1e-6, ``tests/test_multidevice.py``'s bound), each
    rank keeps exactly its slice of them, and the split dimension follows
    ``zero1_specs``' rule on the JAX parameter specs of every smoke arch;
  * int8_ef for 16 steps tracks the uncompressed run (loss within 0.08,
    both learning), with per-rank residues that differ between ranks and
    shrink (``tests/test_multidevice.py:219-254``);
  * ``compressed_psum`` gives every rank the mean of the ranks'
    dequantised values and keeps its own residue (1e-6 / 1e-5 against
    ``ef_quantize`` of the JAX package, per rank).

In-process against JAX: ``ef_quantize`` / ``ef_dequantize``,
``allreduce_wire_bytes``, ``shard_site_key``'s key path, and the texts of
an indivisible batch and of an unknown ``grad_compress``.
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
from repro.models import param_specs as jax_param_specs
from repro.optim import make_optimizer as jax_make_optimizer
from repro.runtime import grad_compress as jgc
from repro.runtime.sharding import DEFAULT_RULES
from repro.train import TrainState as JaxTrainState
from repro.train import make_train_step as jax_make_train_step
from repro.train.distributed import make_shard_map_train_step as jax_make_shard_map_step
from repro.train.distributed import shard_site_key as jax_shard_site_key
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config, list_configs
from repro_torch.core.keys import Key
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import init_model
from repro_torch.optim import adamw_init
from repro_torch.runtime import grad_compress as tgc
from repro_torch.runtime import sharding as tsh
from repro_torch.train import TrainState, make_train_step
from repro_torch.train.distributed import (local_batch, make_shard_map_train_step,
                                           shard_site_key)
from tests import torch_rank_jobs
from tests.test_torch_linear import JaxSampler

ARCH = "llama-tiny"
SPECS = ["attn.qkv=pamm(r=1/8)", "attn.qkv=pamm(r=1/20)", "attn.qkv=pamm(r=1/256)"]
STEPS, EF_STEPS = 3, 16
SITE = "site/stage0.attn.attn.qkv"


def _rcfg(**kw):
    base = dict(compression=SPECS[0], lr=5e-3, compute_dtype="float32",
                param_dtype="float32")
    base.update(kw)
    return base


def _batches(n):
    stream = SyntheticStream.for_arch(jax_get_config(ARCH), 32, 8, seed=0)
    return [stream.get_batch(i) for i in range(n)]


def _blocked(spec, n):
    return spec[:-1] + f",blocks={n})"


class _Recording(JaxSampler):
    """JaxSampler that keeps every draw it makes (and the keys on the way,
    so a path's prefix is derived once)."""

    def __init__(self):
        self.table, self._keys = {}, {}

    def key(self, seed, path):
        if not path:
            return jax.random.key(seed)
        if (seed, path) not in self._keys:
            parent, op = self.key(seed, path[:-1]), path[-1]
            if op[0] == "fold_in":
                self._keys[(seed, path)] = jax.random.fold_in(parent, op[1])
            else:
                for i, k in enumerate(jax.random.split(parent, op[1])):
                    self._keys[(seed, path[:-1] + (("split", op[1], i),))] = k
        return self._keys[(seed, path)]

    def choice(self, seed, path, b, k, device):
        idx = super().choice(seed, path, b, k, device)
        self.table[(seed, path, b, k)] = idx.numpy()
        return idx


def _port_single(params, spec, batches):
    """The port's single-process step with ``spec`` (explicitly blocked),
    drawing the JAX chain: (metrics, the draws it made)."""
    cfg = get_config(ARCH)
    rcfg = RunConfig(**_rcfg(compression=spec))
    model = bridge.from_jax_params(params, cfg, device="cpu", trainable=True)
    state = TrainState(model, adamw_init(dict(model.named_parameters())))
    sampler = _Recording()
    step = make_train_step(cfg, rcfg, total_steps=len(batches), sampler=sampler)
    out = []
    for i, b in enumerate(batches):
        state, m = step(state, b, i)
        out.append({k: float(v) for k, v in m.items()})
    return out, sampler.table


def _jax_run(params, spec, batches):
    jr = JaxRunConfig(**_rcfg(compression=spec), attn_kernel="jnp")
    jp = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(params=jp, opt=jax_make_optimizer("adamw")[0](jp))
    fn = jax.jit(jax_make_train_step(jax_get_config(ARCH), jr, total_steps=len(batches)))
    out = []
    for i, b in enumerate(batches):
        state, m = fn(state, {k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(i))
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


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
def runs():
    """Record the draws, start the 4-rank and 2-rank groups, run the JAX
    references while they train, then collect."""
    params = bridge.to_jax_params(init_model(get_config(ARCH), RunConfig(), seed=0,
                                             device="cpu"))
    batches, ef_batches = _batches(STEPS), _batches(EF_STEPS)
    single, tables = {}, {}
    for n, specs in ((4, SPECS), (2, SPECS[:1])):
        for spec in specs:
            single[(n, spec)], tables[(n, spec)] = _port_single(params, _blocked(spec, n),
                                                                batches)
    sampler = lambda n, spec: torch_rank_jobs.TableSampler(tables[(n, spec)])
    runs4 = [{"arch": ARCH, "rcfg": _rcfg(compression=spec), "params": params,
              "batches": batches, "sampler": sampler(4, spec),
              "collect": ("params", "state", "local") if spec == SPECS[0] else ("params",)}
             for spec in SPECS]
    runs4 += [{"arch": ARCH, "rcfg": _rcfg(grad_compress=gc), "params": params,
               "batches": ef_batches, "collect": ("local",)} for gc in ("int8_ef", "none")]
    psum = np.random.default_rng(0).standard_normal((4, 16, 5)).astype(np.float32)
    started = {4: spawn_ranks(4, torch_rank_jobs.job, (4, 1), [], runs4, psum,
                              timeout=torch_rank_jobs.TIMEOUT),
               2: spawn_ranks(2, torch_rank_jobs.job, (2, 1), [],
                              [{**runs4[0], "sampler": sampler(2, SPECS[0]),
                                "collect": ("params",)}],
                              timeout=torch_rank_jobs.TIMEOUT)}
    ref = {(n, spec): _jax_run(params, _blocked(spec, n), batches) for n, spec in single}
    got = {n: r.results() for n, r in started.items()}
    return got, ref, single, psum


@pytest.mark.parametrize("n,spec", [(4, s) for s in SPECS] + [(2, SPECS[0])],
                         ids=["dp4-r8", "dp4-r20", "dp4-r256", "dp2-r8"])
def test_train_step_matches_jax_blocked_single_device(runs, n, spec):
    got, ref, single, _ = runs
    i = SPECS.index(spec)
    ranks = [r["runs"][i] for r in got[n]]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    state_j, mj = ref[(n, spec)]
    for a, b, c in zip(mj, ranks[0]["metrics"], single[(n, spec)]):
        assert a["loss"] == pytest.approx(b["loss"], abs=5e-5)
        assert a["nll"] == pytest.approx(b["nll"], abs=5e-5)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=5e-5)
        for k in ("loss", "nll", "grad_norm"):
            assert c[k] == pytest.approx(b[k], rel=1e-5), k
    want = _flat(state_j.params)
    assert set(want) == set(ranks[0]["params"])
    assert max(np.abs(ranks[0]["params"][k] - want[k]).max() for k in want) < 5e-4


def test_telemetry_aggregated_across_shards(runs):
    got, ref, _, _ = runs
    m = got[4][0]["runs"][0]["metrics"][0]
    mj = ref[(4, SPECS[0])][1][0]
    assert m[f"{SITE}/stored_mb"] == pytest.approx(mj[f"{SITE}/stored_mb"], rel=1e-6)
    assert m[f"{SITE}/kept_frac"] == pytest.approx(1.0)
    assert m[f"{SITE}/beta"] == pytest.approx(1.0)


def test_zero1_moments_gathered_equal_jax_and_ranks_keep_their_rows(runs):
    got, ref, _, _ = runs
    state_j = ref[(4, SPECS[0])][0]
    run0 = got[4][0]["runs"][0]
    for mine, theirs in ((run0["m"], state_j.opt.m), (run0["v"], state_j.opt.v)):
        want = _flat(theirs)
        assert set(want) == set(mine)
        assert max(np.abs(mine[k] - want[k]).max() for k in want) < 1e-6
    layout = run0["layout"]
    assert sum(d is not None for d in layout.values()) == len(layout)   # all split at dp 4
    for r, rank in enumerate(got[4]):
        local = rank["runs"][0]["m_local"]
        for name, d in layout.items():
            whole = torch.from_numpy(run0["m"][name])
            np.testing.assert_array_equal(local[name],
                                          tsh.shard_slice(whole, d, r, 4).numpy())
            assert local[name].shape[d] * 4 == whole.shape[d]


@pytest.mark.parametrize("dp", [2, 4])
def test_zero1_rule_matches_jax_specs(dp):
    """``zero1_dim`` against ``zero1_specs``' rule on the JAX logical
    specs: the first dimension whose logical axis the rules leave off the
    model axis, that dp divides and is at least dp. The RG-LRU gates
    ``w_a`` / ``w_i`` put their columns on the model axis where JAX puts
    their rows (a departure by design, ``runtime/sharding.py``), so the
    rule reads their two last axes swapped."""
    is_leaf = lambda s: isinstance(s, tuple) and all(isinstance(x, (str, type(None)))
                                                     for x in s)
    for arch in [a for a in list_configs() if a.endswith("_smoke")] + [ARCH]:
        shapes, specs = jax_param_specs(jax_get_config(arch), JaxRunConfig())
        flat_specs = jax.tree.leaves(specs, is_leaf=is_leaf)
        for (path, shp), logical in zip(jax.tree_util.tree_leaves_with_path(shapes),
                                        flat_specs):
            name = jax.tree_util.keystr(path, simple=True, separator=".")
            if name.endswith((".rec.w_a", ".rec.w_i")):
                logical = (*logical[:-2], logical[-1], logical[-2])
            free = [DEFAULT_RULES.get(ax) is None or "model" not in DEFAULT_RULES[ax]
                    for ax in logical]
            want = next((i for i, (dim, f) in enumerate(zip(shp.shape, free))
                         if f and dim % dp == 0 and dim >= dp), None)
            assert tsh.zero1_dim(name, shp.shape, dp) == want, (arch, name, logical)


def test_int8_ef_tracks_uncompressed_with_shrinking_per_rank_buffers(runs):
    got, _, _, _ = runs
    ef, un = (got[4][0]["runs"][i]["metrics"] for i in (3, 4))
    for a, b in zip(ef, un):
        assert a["loss"] == pytest.approx(b["loss"], abs=0.08)
    assert ef[-1]["loss"] < ef[0]["loss"]
    # the norm of all ranks' residues together, as the JAX (dp, *param) tree
    norms = np.sqrt(sum(np.square(r["runs"][3]["ef_norms"]) for r in got[4]))
    assert np.mean(norms[-4:]) < np.mean(norms[:4])
    assert norms[-1] < 2.0 * min(norms)
    e0, e1 = (got[4][r]["runs"][3]["ef_local"] for r in (0, 1))
    name = next(iter(e0))
    assert not np.array_equal(e0[name], e1[name])
    assert all(np.isfinite(e).all() for e in e0.values())


def test_compressed_psum_is_mean_of_dequantized(runs):
    got, _, _, g = runs
    outs = [r["psum"] for r in got[4]]
    deq = []
    for s, (out, err) in enumerate(outs):
        np.testing.assert_array_equal(out, outs[0][0])
        q, scale, e2 = jgc.ef_quantize(jnp.asarray(g[s]), jnp.zeros_like(g[s]))
        deq.append(np.asarray(jgc.ef_dequantize(q, scale)))
        np.testing.assert_allclose(err, np.asarray(e2), atol=1e-5)
    np.testing.assert_allclose(outs[0][0], np.mean(deq, 0), atol=1e-6)
    np.testing.assert_allclose(outs[0][0], g.mean(0), atol=0.05)


# ---------------------------------------------------------------------------
# in-process against JAX
# ---------------------------------------------------------------------------
def test_ef_quantize_and_dequantize_match_jax():
    rng = np.random.default_rng(3)
    for shape, scale in (((16, 5), 1.0), ((7, 3, 4), 1e-3), ((9,), 0.0)):
        g = (rng.standard_normal(shape) * scale).astype(np.float32)
        err = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
        q, s, e = tgc.ef_quantize(torch.from_numpy(g), torch.from_numpy(err))
        qj, sj, ej = jgc.ef_quantize(jnp.asarray(g), jnp.asarray(err))
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        assert q.dtype == torch.int8
        np.testing.assert_allclose(float(s), float(sj), rtol=1e-7)
        np.testing.assert_allclose(e.numpy(), np.asarray(ej), atol=1e-7)
        np.testing.assert_allclose(tgc.ef_dequantize(q, s).numpy(),
                                   np.asarray(jgc.ef_dequantize(qj, sj)), rtol=1e-7)


def test_wire_bytes_accounting_matches_jax():
    shapes = {"w": (64, 64), "b": (64,)}
    jshapes = {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in shapes.items()}
    for dp in (1, 2, 4, 8):
        for scheme in ("bf16", "f32", "int8_ef"):
            assert tgc.allreduce_wire_bytes(shapes, dp, scheme) == \
                jgc.allreduce_wire_bytes(jshapes, dp, scheme)
    with pytest.raises(ValueError, match="scheme must be one of"):
        tgc.allreduce_wire_bytes(shapes, 4, "fp8")


def test_shard_site_keys_follow_the_jax_chain_and_are_decorrelated():
    key = Key(123).fold_in(7)
    jkey = jax.random.fold_in(jax.random.key(123), 7)
    datas = [np.asarray(jax.random.key_data(JaxSampler.key(
        123, shard_site_key(key, 5, dp=4, shard=s).path))) for s in range(4)]
    for s in range(4):
        np.testing.assert_array_equal(datas[s], np.asarray(jax.random.key_data(
            jax_shard_site_key(jkey, 5, dp=4, shard=s))))
        assert all(not np.array_equal(datas[s], datas[t]) for t in range(s))


def test_indivisible_batch_and_unknown_scheme_texts_match_jax():
    cfg = get_config(ARCH)
    mesh = Mesh(("data", "model"), (4, 1))
    jmesh = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((4, 1)))
    bad = SyntheticStream.for_arch(jax_get_config(ARCH), 32, 6).get_batch(0)
    with pytest.raises(ValueError) as ei:
        local_batch(bad, mesh, "cpu")
    assert "not divisible by the data-parallel degree 4" in str(ei.value)
    from repro.runtime.sharding import validate_batch_divisible

    with pytest.raises(ValueError) as ej:
        validate_batch_divisible(6, jmesh, where="shard_map train step")
    assert str(ei.value) == str(ej.value)
    with pytest.raises(ValueError) as ei:
        make_shard_map_train_step(cfg, RunConfig(grad_compress="fp8"), mesh=mesh)
    with pytest.raises(ValueError) as ej:
        jax_make_shard_map_step(jax_get_config(ARCH), JaxRunConfig(grad_compress="fp8"),
                                mesh=jmesh)
    assert str(ei.value) == str(ej.value)
    with pytest.raises(ValueError, match="needs a mesh"):
        make_shard_map_train_step(cfg, RunConfig(), mesh=None)


def test_single_process_step_with_a_mesh_as_jax():
    """``make_train_step(mesh=)``: a context axis above 1 is refused with
    the JAX executor's text; a data mesh only resolves ``blocks=auto`` to
    its degree, so the step equals the one with ``blocks=4`` spelled out."""
    cfg = get_config(ARCH)
    axes = ("data", "model", "context")
    jmesh = types.SimpleNamespace(axis_names=axes, devices=np.empty((1, 1, 2)))
    with pytest.raises(ValueError) as ei:
        make_train_step(cfg, RunConfig(**_rcfg()), mesh=Mesh(axes, (1, 1, 2)))
    with pytest.raises(ValueError) as ej:
        jax_make_train_step(jax_get_config(ARCH), JaxRunConfig(**_rcfg()), mesh=jmesh)
    assert "cannot run ring context-parallel attention" in str(ei.value)
    assert str(ei.value) == str(ej.value)
    batch = _batches(1)[0]
    runs = []
    for spec, mesh in ((SPECS[0], Mesh(("data", "model"), (4, 1))),
                       (_blocked(SPECS[0], 4), None)):
        rcfg = RunConfig(**_rcfg(compression=spec))
        model = init_model(cfg, rcfg, seed=0, device="cpu")
        state = TrainState(model, adamw_init(dict(model.named_parameters())))
        state, m = make_train_step(cfg, rcfg, total_steps=4, mesh=mesh)(state, batch, 1)
        runs.append(({k: float(v) for k, v in m.items()},
                     {n: p.detach().clone() for n, p in model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for n, p in runs[0][1].items():
        torch.testing.assert_close(p, runs[1][1][n], rtol=0, atol=0)


def test_odd_blocks_warning_matches_jax():
    """blocks != the shard count trains, with the JAX executor's warning
    that the draws are not those of the single-process blocked run."""
    import warnings

    spec = "attn.qkv=pamm(r=1/8,blocks=2)"
    jmesh = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((4, 1)))
    with pytest.warns(UserWarning, match="NOT sampling-compatible") as mine:
        make_shard_map_train_step(get_config(ARCH), RunConfig(compression=spec),
                                  mesh=Mesh(("data", "model"), (4, 1)))
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        with pytest.raises(Exception):     # the fake mesh goes no further than the warning
            jax_make_shard_map_step(jax_get_config(ARCH), JaxRunConfig(compression=spec),
                                    mesh=jmesh)
    want = [str(w.message) for w in theirs if "sampling-compatible" in str(w.message)]
    assert [str(w.message) for w in mine] == want


@pytest.mark.parametrize("shape", [(4, 1), (2, 1, 2), (1, 1, 4)])
def test_blocks_auto_resolves_to_the_mesh_degree_as_jax(shape):
    from repro.core.plan import resolve_for_run as jax_resolve_for_run
    from repro_torch.core.plan import resolve_for_run

    axes = ("data", "model", "context")[:len(shape)]
    jmesh = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    for spec in SPECS + ["attn.qkv=pamm(r=1/8,blocks=2)"]:
        t = resolve_for_run(get_config(ARCH), RunConfig(compression=spec), Mesh(axes, shape))
        j = jax_resolve_for_run(jax_get_config(ARCH), JaxRunConfig(compression=spec),
                                mesh=jmesh)
        assert [s.policy.n_blocks for s in t.compressed_sites] == \
            [s.policy.n_blocks for s in j.compressed_sites]
    assert t.compressed_sites[0].policy.n_blocks == 2
    assert resolve_for_run(get_config(ARCH), RunConfig(compression=SPECS[0]),
                           Mesh(axes, shape)).compressed_sites[0].policy.n_blocks == 4


def test_train_cli_mesh_on_the_cpu(capfd):
    """``--executor shard_map --data-model 2 1 --mesh-context 2
    --grad-compress int8_ef`` starts four ranks and trains with finite
    losses (rank 0 logs every step)."""
    from repro_torch.launch import train

    train.main(["--arch", ARCH, "--device", "cpu", "--steps", "3", "--seq-len", "32",
                "--global-batch", "4", "--compression", SPECS[0], "--log-every", "1",
                "--executor", "shard_map", "--data-model", "2", "1", "--mesh-context", "2",
                "--grad-compress", "int8_ef"])
    out = capfd.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "done: 3 steps on 4 ranks (data 2 x context 2)" in out


def test_a_failing_or_late_rank_stops_the_group():
    """Nothing is swallowed: a rank's exception reaches the caller with its
    traceback, a group past its deadline raises, and either way no rank is
    left running."""
    group = spawn_ranks(2, torch_rank_jobs.fail_on, 1, timeout=60)
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*told to fail"):
        group.results()
    group = spawn_ranks(2, torch_rank_jobs.sleep, 120, timeout=60, deadline=2)
    with pytest.raises(RuntimeError, match="not done within 2 s"):
        group.results()
    assert not any(p.is_alive() for p in group._procs)
