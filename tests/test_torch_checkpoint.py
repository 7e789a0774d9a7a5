"""The port's checkpointer and fault runtime on the CPU: the cases of
``tests/test_checkpoint_fault.py`` (integrity, atomic publish, keep-N,
async save, a missing leaf; supervisor recovery, resume across runs,
replayed steps counted once, the watchdog), plus the JAX package's
on-disk format both ways with bf16 leaves, a reversible train state
restored and continued, and the refusal of elastic re-sharding."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load as jax_load
from repro.checkpoint import save as jax_save
from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.data import SyntheticStream
from repro.train import init_train_state as jax_init_train_state
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager, available_steps, load, save
from repro_torch.configs import RunConfig, get_config
from repro_torch.runtime.fault import FaultInjector, StragglerWatchdog, run_supervised
from repro_torch.train import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]


def tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nest": {"b": torch.ones(2, dtype=torch.bfloat16),
                     "c": torch.full((2, 2), -1.5, dtype=torch.float16), "step": 7},
            "seq": [np.arange(3, dtype=np.int32), torch.zeros(1, dtype=torch.int32)]}


def leaves(t):
    from repro_torch.checkpoint.checkpointer import _leaves

    return dict(_leaves(t))


def test_roundtrip(tmp_path):
    t = tree()
    save(str(tmp_path), 5, t)
    restored, step = load(str(tmp_path), t)
    assert step == 5
    a, b = leaves(t), leaves(restored)
    assert list(a) == list(b)
    for k in a:
        assert type(a[k]) is type(b[k]), k
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            np.testing.assert_array_equal(a[k], b[k])


def test_keys_and_bytes_are_the_jax_checkpointers(tmp_path):
    """The same tree saved by both: the same npz keys, dtype names, shapes
    and CRCs (the same bytes)."""
    t = tree()

    def to_jax(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(x.numpy())

    jt = jax.tree.map(to_jax, t, is_leaf=lambda x: isinstance(x, torch.Tensor))
    d_port = save(str(tmp_path / "port"), 1, t)
    d_jax = jax_save(str(tmp_path / "jax"), 1, jt)
    m_port = json.load(open(os.path.join(d_port, "manifest.json")))["arrays"]
    m_jax = json.load(open(os.path.join(d_jax, "manifest.json")))["arrays"]
    assert m_port.keys() == m_jax.keys()
    for k, meta in m_jax.items():
        assert m_port[k] == meta, k


def test_crc_detects_corruption(tmp_path):
    t = tree()
    d = save(str(tmp_path), 1, t)
    path = os.path.join(d, "manifest.json")
    man = json.load(open(path))
    key = next(iter(man["arrays"]))
    man["arrays"][key]["crc32"] ^= 0xFFFF
    json.dump(man, open(path, "w"))
    with pytest.raises(IOError):
        load(str(tmp_path), t)


def test_atomic_publish_ignores_tmp(tmp_path):
    os.makedirs(tmp_path / "step_000000009.tmp")
    assert available_steps(str(tmp_path)) == []


def test_keep_last_n_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_sync(s, tree())
    assert available_steps(str(tmp_path)) == [3, 4]


def test_async_save_snapshots_the_tree_when_called(tmp_path):
    """The leaves are copied when save_async is called: an in-place update
    after it (the port's optimizer updates parameters in place) does not
    reach the file."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = tree()
    mgr.save_async(11, t)
    t["a"].add_(100.0)
    mgr.wait()
    assert available_steps(str(tmp_path)) == [11]
    restored, _ = load(str(tmp_path), t)
    assert torch.equal(restored["a"], torch.arange(12, dtype=torch.float32).reshape(3, 4))


@pytest.mark.parametrize("case", ["missing_leaf", "shape", "shardings"])
def test_load_refusals(tmp_path, case):
    save(str(tmp_path), 1, {"a": torch.ones(2)})
    if case == "missing_leaf":
        with pytest.raises(KeyError):
            load(str(tmp_path), {"a": torch.ones(2), "b": torch.ones(2)})
    elif case == "shape":
        with pytest.raises(ValueError, match="shape"):
            load(str(tmp_path), {"a": torch.ones(3)})
    else:
        with pytest.raises(NotImplementedError, match="multi-GPU slice"):
            load(str(tmp_path), {"a": torch.ones(2)}, shardings={"a": None})


def _jax_state(arch, **kw):
    jr = JaxRunConfig(compression="", **kw)
    state, _ = jax_init_train_state(jax_get_config(arch), jr, jax.random.key(0))
    return jr, state


def _flat(state) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def test_jax_checkpoint_loads_into_the_port_and_back(tmp_path):
    """A JAX TrainState with bf16 parameters, saved by the JAX package,
    loads into a port TrainState (Model + OptState); the port saves it,
    and the JAX package loads that file into its own TrainState: every
    leaf equal, bf16 kept."""
    arch = "internlm2-1.8b_smoke"
    _, jstate = _jax_state(arch, param_dtype="bfloat16")
    jstate = jstate._replace(opt=jstate.opt._replace(
        step=jnp.int32(5), m=jax.tree.map(lambda p: jnp.full(p.shape, 0.25, jnp.float32),
                                          jstate.params)))
    jax_save(str(tmp_path / "jax"), 5, jstate)
    port = init_train_state(get_config(arch), RunConfig(compression="", param_dtype="bfloat16"),
                            device="cpu", seed=9)
    tree_, step = load(str(tmp_path / "jax"), bridge.train_state_tree(port))
    port = bridge.install_train_state_tree(port, tree_)
    assert step == 5 and port.opt.step == 5
    assert port.params.embed.dtype == torch.bfloat16
    assert list(leaves(bridge.train_state_tree(port))) == list(_flat(jstate))
    save(str(tmp_path / "port"), 6, bridge.train_state_tree(port))
    back, step = jax_load(str(tmp_path / "port"), jstate)
    assert step == 6
    for (k, a), b in zip(_flat(jstate).items(), _flat(back).values()):
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert jax.tree.leaves(back.params)[0].dtype == jnp.bfloat16


def test_bf16_checkpoints_need_no_ml_dtypes(tmp_path):
    """Saving and loading bf16 leaves imports no ml_dtypes (the card
    machine has none)."""
    code = ("import sys, torch\n"
            "from repro_torch.checkpoint import load, save\n"
            "t = {'w': torch.randn(3, 4).to(torch.bfloat16)}\n"
            f"save({str(tmp_path)!r}, 1, t)\n"
            f"r, _ = load({str(tmp_path)!r}, t)\n"
            "assert torch.equal(r['w'], t['w'])\n"
            "print('ml_dtypes' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), check=True,
                         timeout=120)
    assert out.stdout.strip() == "False"


def test_reversible_state_restores_and_continues(tmp_path):
    """A reversible train state with bf16 parameters round-trips (CRC
    verified) and training continues from the restore as it does from
    the live state (the port of ``test_revnet_checkpoint_restore_and_continue``)."""
    cfg = get_config("internlm2-1.8b_smoke")
    rcfg = RunConfig(compression="attn.qkv=pamm(r=1/8);ffn.*=compact(r=1/4)",
                     compute_dtype="float32", param_dtype="bfloat16",
                     block_structure="reversible", lr=5e-3)
    stream = SyntheticStream.for_arch(cfg, 16, 4, seed=0)
    step_fn = make_train_step(cfg, rcfg, total_steps=6)

    def run(state, lo, hi):
        losses = []
        for i in range(lo, hi):
            state, m = step_fn(state, stream.get_batch(i), i)
            losses.append(float(m["loss"]))
        return state, losses

    state, _ = run(init_train_state(cfg, rcfg, device="cpu"), 0, 3)
    ckdir = save(str(tmp_path), 3, bridge.train_state_tree(state))
    saved = {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in leaves(bridge.train_state_tree(state)).items()}
    state, tail_direct = run(state, 3, 6)
    template = init_train_state(cfg, rcfg, device="cpu", seed=1)
    tree_, step = load(str(tmp_path), bridge.train_state_tree(template))
    restored = bridge.install_train_state_tree(template, tree_)
    assert step == 3 and restored.opt.step == 3
    for k, v in leaves(bridge.train_state_tree(restored)).items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == saved[k].dtype and torch.equal(v, saved[k]), k
    _, tail_restored = run(restored, 3, 6)
    np.testing.assert_allclose(tail_restored, tail_direct, rtol=1e-6)
    path = os.path.join(ckdir, "manifest.json")
    man = json.load(open(path))
    man["arrays"][next(iter(man["arrays"]))]["crc32"] ^= 0xFFFF
    json.dump(man, open(path, "w"))
    with pytest.raises(IOError):
        load(str(tmp_path), bridge.train_state_tree(template))


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------
def _counter():
    state = {"x": torch.zeros(())}
    return state, (lambda: dict(state)), (lambda t, s: state.update(t))


def test_supervisor_recovers_from_injected_failures(tmp_path):
    state, provide, restore = _counter()
    trace = []

    def step_fn(step):
        state["x"] = state["x"] + 1.0
        trace.append(step)
        return {}

    report = run_supervised(total_steps=20, step_fn=step_fn, state_provider=provide,
                            state_restorer=restore, ckpt_root=str(tmp_path), ckpt_every=5,
                            injector=FaultInjector(fail_at=(7, 13)))
    assert report.restarts == 2 and report.completed_steps == 20
    assert max(trace) == 19
    assert float(state["x"]) == 20.0   # the replays restored the counted work


def test_supervisor_resumes_across_runs(tmp_path):
    """A fresh supervisor picks up from the published checkpoint."""
    state, provide, restore = _counter()

    def mk_step(stop_at=None):
        def step_fn(step):
            if stop_at is not None and step >= stop_at:
                raise KeyboardInterrupt
            state["x"] = state["x"] + 1.0
            return {}
        return step_fn

    with pytest.raises(KeyboardInterrupt):
        run_supervised(total_steps=20, step_fn=mk_step(stop_at=12), state_provider=provide,
                       state_restorer=restore, ckpt_root=str(tmp_path), ckpt_every=5,
                       max_restarts=0)
    state["x"] = torch.zeros(())
    report = run_supervised(total_steps=20, step_fn=mk_step(), state_provider=provide,
                            state_restorer=restore, ckpt_root=str(tmp_path), ckpt_every=5)
    assert report.restarts == 0 and report.completed_steps == 10
    assert available_steps(str(tmp_path))[-1] == 20
    assert float(state["x"]) == 20.0


def test_supervisor_counts_replayed_steps_once(tmp_path):
    state, provide, restore = _counter()
    trace = []

    def step_fn(step):
        state["x"] = state["x"] + 1.0
        trace.append(step)
        return {}

    report = run_supervised(total_steps=12, step_fn=step_fn, state_provider=provide,
                            state_restorer=restore, ckpt_root=str(tmp_path), ckpt_every=5,
                            injector=FaultInjector(fail_at=(9,)))
    assert report.restarts == 1
    assert len(trace) > 12
    assert report.completed_steps == 12


def test_supervisor_excludes_post_restore_step_from_watchdog(tmp_path):
    """The first step after a restore is a restart's, not a straggler."""
    state, provide, _ = _counter()
    pending = {}

    def step_fn(step):
        time.sleep(0.25 if pending.pop("slow", False) else 0.01)
        state["x"] = state["x"] + 1.0
        return {}

    def restorer(t, s):
        state.update(t)
        pending["slow"] = True

    wd = StragglerWatchdog(threshold=3.0)
    report = run_supervised(total_steps=16, step_fn=step_fn, state_provider=provide,
                            state_restorer=restorer, ckpt_root=str(tmp_path), ckpt_every=4,
                            injector=FaultInjector(fail_at=(12,)), watchdog=wd)
    assert report.restarts == 1 and report.completed_steps == 16
    assert report.straggler_events == 0 and wd.slow_steps == []


@pytest.mark.parametrize("window", [64, 8])
def test_straggler_watchdog(window):
    """A step 10x the median is a straggler; with a small window a slow
    early epoch ages out of the median."""
    wd = StragglerWatchdog(threshold=3.0, window=window)
    if window == 8:
        for i in range(8):
            wd.observe(i, 1.0)
    for i in range(8, 24):
        assert not wd.observe(i, 0.1)
    if window == 8:
        assert len(wd._times) == 8 and wd.median() == pytest.approx(0.1)
        assert wd.observe(24, 0.4)
    else:
        assert wd.observe(24, 1.0)
        assert not wd.observe(25, 0.12)
        assert len(wd.slow_steps) == 1
