"""Finetuning-style comparison (the port of ``examples/finetune_compare.py``,
paper §4.3 shape): start from a pretrained model, continue training with
Full FT vs PAMM at r=1/128 and 1/256, and report final quality + QKV
activation memory -- the Table-1 experiment at small scale.

    python -m repro_torch.examples.finetune_compare [--device cpu] \
        [--pretrain-steps 80] [--finetune-steps 60]
"""
import argparse
import math

import numpy as np

from repro_torch.configs import RunConfig, get_config
from repro_torch.core import PammPolicy, qkv_activation_bytes
from repro_torch.data import SyntheticStream
from repro_torch.train import init_train_state, make_train_step

DIVISORS = (128, 256)       # PAMM at r = 1/128 and 1/256


def pretrain(cfg, device, steps=80):
    rcfg = RunConfig(policy_name="none", lr=5e-3,
                     compute_dtype="float32", param_dtype="float32")
    state = init_train_state(cfg, rcfg, device=device, seed=0)
    stream = SyntheticStream.for_arch(cfg, 64, 8, seed=0)
    step = make_train_step(cfg, rcfg, total_steps=steps)
    for i in range(steps):
        state, _ = step(state, stream.get_batch(i), i)
    return state.params


def finetune(cfg, base, policy, ratio, device, steps=60):
    # "task" = a different seed of the synthetic stream (new distribution)
    rcfg = RunConfig(policy_name=policy, pamm_ratio=ratio, lr=1e-3,
                     compute_dtype="float32", param_dtype="float32")
    state = init_train_state(cfg, rcfg, device=device, seed=1)
    state.params.load_state_dict(base.state_dict())   # fresh moments, base weights
    stream = SyntheticStream.for_arch(cfg, 64, 8, seed=1234)
    step = make_train_step(cfg, rcfg, total_steps=steps)
    last = []
    for i in range(steps):
        state, m = step(state, stream.get_batch(i), i)
        if i >= steps - 10:
            last.append(float(m["nll"]))
    return math.exp(float(np.mean(last)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--pretrain-steps", type=int, default=80)
    ap.add_argument("--finetune-steps", type=int, default=60)
    args = ap.parse_args(argv)

    cfg = get_config("llama-tiny")
    base = pretrain(cfg, args.device, args.pretrain_steps)
    ft = lambda policy, ratio: finetune(cfg, base, policy, ratio, args.device,
                                        args.finetune_steps)
    rows = [("full-ft", ft("none", 1.0), 0.0)]
    for div in DIVISORS:
        ppl = ft("pamm", 1 / div)
        rep = qkv_activation_bytes(PammPolicy(ratio=1 / div),
                                   n_layers=cfg.n_layers, batch=8, seq=64,
                                   hidden=cfg.d_model)
        rows.append((f"pamm r=1/{div}", ppl, 100 * rep.saving))
    print(f"{'setting':<16} {'ppl':>8} {'QKV mem saved':>14}")
    for name, ppl, saved in rows:
        print(f"{name:<16} {ppl:8.3f} {saved:13.2f}%")


if __name__ == "__main__":
    main()
