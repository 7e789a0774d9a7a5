"""Quickstart: drop PAMM into a training step in ~30 lines (the port of
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cpu]

Trains llama-tiny in f32 under ``attn.qkv=pamm(r=1/512,eps=inf)`` and
CompAct on the FFN projections, printing the loss every 10 steps, the
per-site telemetry and the QKV activation-memory report.
"""
import argparse

from repro_torch.configs import RunConfig, get_config
from repro_torch.core import PammPolicy, qkv_activation_bytes
from repro_torch.data import SyntheticStream
from repro_torch.train import init_train_state, make_train_step

# per-site CompressionPlan spec (DESIGN.md §2): the paper's method at x512
# on the QKV projections, CompAct on the FFN projections.
COMPRESSION = "attn.qkv=pamm(r=1/512,eps=inf);ffn.*=compact(r=1/4)"
STEPS = 50


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("llama-tiny")                  # any registered arch
    rcfg = RunConfig(compression=COMPRESSION,
                     compute_dtype="float32", param_dtype="float32")
    state = init_train_state(cfg, rcfg, device=args.device, seed=0)
    stream = SyntheticStream.for_arch(cfg, seq_len=64, global_batch=8)
    step = make_train_step(cfg, rcfg, total_steps=STEPS)

    for i in range(STEPS):
        state, metrics = step(state, stream.get_batch(i), i)
        if i % 10 == 0:
            print(f"step {i:3d}  loss {float(metrics['loss']):.4f}")

    # per-site telemetry flows through train metrics
    for k, v in sorted(metrics.items()):
        if k.startswith("site/"):
            print(f"{k} = {float(v):.5f}")

    report = qkv_activation_bytes(
        PammPolicy(ratio=1 / 512), n_layers=cfg.n_layers,
        batch=8, seq=64, hidden=cfg.d_model,
    )
    print(report)


if __name__ == "__main__":
    main()
