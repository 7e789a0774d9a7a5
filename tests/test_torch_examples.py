"""The port's examples (``repro_torch.examples``, the counterparts of
``examples/*.py``) on the CPU at their shortest: each runs through the
port's entry points and prints what the JAX script prints; the analytic
QKV memory figures equal the JAX package's for the same arguments; and
each runs on the card unless the caller asks for the CPU."""
import dataclasses
import math
import os

import pytest
import torch

from repro.core import PammPolicy as JaxPamm
from repro.core import qkv_activation_bytes as jax_qkv_activation_bytes
from repro_torch.core import PammPolicy, qkv_activation_bytes
from repro_torch.examples import finetune_compare, pretrain, quickstart, serve_batched

LLAMA_TINY = dict(n_layers=4, batch=8, seq=64, hidden=128)   # the scripts' arguments


@pytest.fixture(autouse=True)
def one_thread():
    """The examples' ops are tiny: on one intra-op thread. Beside other
    busy processes, a pool of threads waits for cores at every op (11
    quickstart steps: 74 s against 1.2 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_trains_and_reports_the_jax_packages_figures(capsys):
    """The script's 50 steps: losses every 10 steps, finite and falling;
    one telemetry triple per compressed site; the report equal to the JAX
    package's."""
    quickstart.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    losses = [float(line.split()[-1]) for line in lines if line.startswith("step ")]
    assert len(losses) == 5 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    sites = [line for line in lines if line.startswith("site/")]
    assert len(sites) == 9 and all(math.isfinite(float(s.split(" = ")[1])) for s in sites)
    want = jax_qkv_activation_bytes(JaxPamm(ratio=1 / 512), **LLAMA_TINY)
    got = qkv_activation_bytes(PammPolicy(ratio=1 / 512), **LLAMA_TINY)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert lines[-1] == str(want)


def test_pretrain_checkpoints_and_resumes(capsys, tmp_path):
    """Through the training CLI's supervisor: a checkpoint at the end of a
    3-step run, and a 5-step run that resumes from it for 2 steps."""
    common = ["--device", "cpu", "--seq-len", "16", "--global-batch", "2",
              "--ckpt", str(tmp_path)]
    pretrain.main(["--steps", "3", *common])
    out = capsys.readouterr().out
    assert "completed_steps=3" in out and "done: 3 steps" in out and "device cpu" in out
    assert os.listdir(tmp_path) == ["step_000000003"]
    pretrain.main(["--steps", "5", *common])
    out = capsys.readouterr().out
    assert "completed_steps=2" in out and "done: 5 steps" in out
    assert math.isfinite(float(out.split("final loss ")[1].split(",")[0]))


def test_finetune_compare_table(capsys):
    """Three rows of finite perplexity; the "QKV mem saved" column is the
    JAX script's analytic figure at r = 1/128 and 1/256."""
    finetune_compare.main(["--device", "cpu", "--pretrain-steps", "3",
                           "--finetune-steps", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-4].split() == ["setting", "ppl", "QKV", "mem", "saved"]
    saved = {"full-ft": 0.0}
    for div in (128, 256):
        rep = jax_qkv_activation_bytes(JaxPamm(ratio=1 / div), **LLAMA_TINY)
        saved[f"pamm r=1/{div}"] = 100 * rep.saving
    for line, (name, pct) in zip(lines[-3:], saved.items()):
        assert line.startswith(name) and line.endswith(f"{pct:13.2f}%")
        assert math.isfinite(float(line[16:25]))


def test_serve_batched_serves_every_request(capsys):
    serve_batched.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    reqs = [line for line in lines if line.startswith("req ")]
    assert len(reqs) == 8 and all("new=16 finish=length" in r for r in reqs)
    assert lines[-1].startswith("[dense]") and lines[-1].endswith("device cpu")


@pytest.mark.parametrize("example", [quickstart, pretrain, finetune_compare, serve_batched])
def test_examples_default_to_the_card(example, monkeypatch):
    """With no --device an example asks for CUDA, which raises here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        example.main([])
