"""Training entry point of the port (twin of ``repro/launch/train.py``,
jit executor, one device).

  python -m repro_torch.launch.train --arch internlm2-1.8b --device cuda \
      --steps 100 --seq-len 256 --global-batch 16 --compression 'attn.qkv=pamm(r=1/512)'

Parameters are f32 and compute is bf16 by default (RunConfig's defaults);
the batches come from the deterministic ``SyntheticStream``. On a CUDA
device the compressed QKV projections run K1/K2 and attention runs K3
forward and K4/K5 backward; ``--device cpu`` runs their plain versions
(use a ``*_smoke`` arch there). Flags of the JAX launcher that need later
slices of the port (meshes, the shard_map executor, gradient compression,
reversible blocks, checkpointing) are refused with the slice named.
"""
from __future__ import annotations

import argparse
import math
import time

from repro_torch.configs import RunConfig, get_config
from repro_torch.data import SyntheticStream
from repro_torch.train import init_train_state, make_train_step

_LATER = {
    "executor": "the shard_map executor arrives with the port's multi-GPU slice",
    "mesh_context": "ring context parallelism arrives with the port's multi-GPU slice",
    "grad_compress": "gradient compression arrives with the port's multi-GPU slice",
    "data_model": "meshes arrive with the port's multi-GPU slice",
    "block_structure": "reversible blocks arrive with the port's reversible-training slice",
    "ckpt_dir": "checkpointing arrives with the port's fault-tolerance slice",
}


def _refuse_later_slices(ap, args) -> None:
    asked = {
        "executor": args.executor != "jit",
        "mesh_context": args.mesh_context > 1,
        "grad_compress": args.grad_compress != "none",
        "data_model": args.data_model is not None,
        "block_structure": args.block_structure != "residual",
        "ckpt_dir": args.ckpt_dir is not None,
    }
    for flag, on in asked.items():
        if on:
            ap.error(f"--{flag.replace('_', '-')}: {_LATER[flag]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises if there is no card) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--policy", default="pamm",
                    choices=["pamm", "uniform_crs", "compact", "none"],
                    help="legacy single-policy shorthand (see --compression)")
    ap.add_argument("--ratio", type=float, default=512, help="compression divisor r=1/x")
    ap.add_argument("--compression", default="",
                    help="CompressionPlan spec, e.g. 'attn.qkv=pamm(r=1/512)'; "
                         "overrides --policy/--ratio")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data-model", type=int, nargs=2, default=None,
                    metavar=("DATA", "MODEL"))
    ap.add_argument("--mesh-context", type=int, default=1)
    ap.add_argument("--executor", default="jit", choices=["jit", "shard_map"])
    ap.add_argument("--grad-compress", default="none", choices=["none", "int8_ef"])
    ap.add_argument("--block-structure", default="residual",
                    choices=["residual", "reversible"])
    args = ap.parse_args(argv)
    _refuse_later_slices(ap, args)

    cfg = get_config(args.arch)
    rcfg = RunConfig(compression=args.compression, policy_name=args.policy,
                     pamm_ratio=1.0 / args.ratio, lr=args.lr)
    stream = SyntheticStream.for_arch(cfg, args.seq_len, args.global_batch)
    state = init_train_state(cfg, rcfg, device=args.device)
    step_fn = make_train_step(cfg, rcfg, total_steps=args.steps)

    t0 = time.monotonic()
    m = None
    for step in range(args.steps):
        state, m = step_fn(state, stream.get_batch(step), step)
        if step % args.log_every == 0 or step == args.steps - 1:
            f = {k: float(v) for k, v in m.items()}
            print(f"step {step:6d} loss {f['loss']:.4f} ppl {math.exp(min(f['nll'], 20)):.2f} "
                  f"gnorm {f['grad_norm']:.3f} lr {f['lr']:.2e}", flush=True)
    dt = time.monotonic() - t0
    tokens = args.steps * args.global_batch * args.seq_len
    print(f"done: {args.steps} steps, {tokens / dt:.0f} tok/s, final loss "
          f"{float(m['loss']):.4f}, device {state.params.device}")


if __name__ == "__main__":
    main()
