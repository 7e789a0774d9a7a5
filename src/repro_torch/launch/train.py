"""Training entry point of the port (twin of ``repro/launch/train.py``,
jit executor, one device).

  python -m repro_torch.launch.train --arch internlm2-1.8b --device cuda \
      --steps 100 --seq-len 256 --global-batch 16 --compression 'attn.qkv=pamm(r=1/512)'

Parameters are f32 and compute is bf16 by default (RunConfig's defaults);
the batches come from the deterministic ``SyntheticStream``. On a CUDA
device the compressed QKV projections run K1/K2 and attention runs K3
forward and K4/K5 backward; ``--device cpu`` runs their plain versions
(use a ``*_smoke`` arch there). A moe arch trains the same way, and its
experts' gate / up projections compress through the ``moe.expert`` rule
(``--compression 'attn.qkv=pamm(r=1/512);moe.expert=pamm(r=1/512)'``: K1 /
K2 once a layer for all experts). An ssm arch (mamba2) has no attention:
its in-projection is the ``ssm.in`` site (``--arch mamba2-370m
--compression 'ssm.in=pamm(r=1/512)'``: K1 / K2 once a layer), which
RunConfig's legacy ``pamm_on_ssm_inproj=True`` also resolves to; the
default ``--policy pamm`` alone names only ``attn.qkv`` and leaves it
exact. recurrentgemma (``--arch recurrentgemma-9b``) adds the rec blocks'
recurrent-branch input projection as the ``rglru.in`` site (``--compression
'attn.qkv=pamm(r=1/512);rglru.in=pamm(r=1/512)'``: K1 / K2 once a rec
layer), and its latt blocks' attention runs K3-K5 at head dim 256 within
the local window. A vision arch (``--arch llama-3.2-vision-11b``) reads
the stream's ``image_embeds``; its xattn blocks' image K/V projection is
the ``attn.cross_kv`` site (``--compression
'attn.qkv=pamm(r=1/512);attn.cross_kv=pamm(r=1/512)'``), and their
cross-attention is the chunked einsum ``sdpa`` (no kernel takes Lq != Lk).
The audio arch (``--arch musicgen-medium``, or ``musicgen-medium_smoke
--device cpu``) has no token table: it trains from the stream's
``embeds`` and four-codebook labels, its head four vocab blocks side by
side and its NLL the mean over the codebooks; a ``lm_head`` rule
(``--compression 'attn.qkv=pamm(r=1/512);lm_head=pamm(r=1/512)'``) runs K1 /
K2 once a codebook and loss chunk. ``--block-structure reversible`` trains
the two-stream reversible stack; ``--ckpt-dir`` runs the step loop under
the checkpoint/restart supervisor (``runtime.fault.run_supervised``, a
checkpoint every ``--ckpt-every`` steps, resuming from the latest one).
Flags of the JAX launcher that need the multi-GPU slice of the port
(meshes, the shard_map executor, gradient compression) are refused with
the slice named.
"""
from __future__ import annotations

import argparse
import math
import time

from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config
from repro_torch.data import SyntheticStream
from repro_torch.runtime.fault import StragglerWatchdog, run_supervised
from repro_torch.train import init_train_state, make_train_step

_LATER = {
    "executor": "the shard_map executor arrives with the port's multi-GPU slice",
    "mesh_context": "ring context parallelism arrives with the port's multi-GPU slice",
    "grad_compress": "gradient compression arrives with the port's multi-GPU slice",
    "data_model": "meshes arrive with the port's multi-GPU slice",
}


def _refuse_later_slices(ap, args) -> None:
    asked = {
        "executor": args.executor != "jit",
        "mesh_context": args.mesh_context > 1,
        "grad_compress": args.grad_compress != "none",
        "data_model": args.data_model is not None,
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
                    help="CompressionPlan spec, e.g. 'attn.qkv=pamm(r=1/512)' or, "
                         "for mamba2, 'ssm.in=pamm(r=1/512)'; overrides --policy/--ratio")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--data-model", type=int, nargs=2, default=None,
                    metavar=("DATA", "MODEL"))
    ap.add_argument("--mesh-context", type=int, default=1)
    ap.add_argument("--executor", default="jit", choices=["jit", "shard_map"])
    ap.add_argument("--grad-compress", default="none", choices=["none", "int8_ef"])
    ap.add_argument("--block-structure", default="residual",
                    choices=["residual", "reversible"],
                    help="reversible = two-stream blocks whose backward rebuilds "
                         "the residual stream instead of saving it (attn/swa/latt/"
                         "moe/rec kinds, not ssm; excludes remat, see models/blocks.py)")
    args = ap.parse_args(argv)
    _refuse_later_slices(ap, args)

    cfg = get_config(args.arch)
    rcfg = RunConfig(compression=args.compression, policy_name=args.policy,
                     pamm_ratio=1.0 / args.ratio, lr=args.lr,
                     block_structure=args.block_structure)
    stream = SyntheticStream.for_arch(cfg, args.seq_len, args.global_batch)
    step_fn = make_train_step(cfg, rcfg, total_steps=args.steps)
    holder = {"state": init_train_state(cfg, rcfg, device=args.device), "metrics": None}

    def one_step(step: int):
        holder["state"], m = step_fn(holder["state"], stream.get_batch(step), step)
        holder["metrics"] = m
        if step % args.log_every == 0 or step == args.steps - 1:
            f = {k: float(v) for k, v in m.items()}
            print(f"step {step:6d} loss {f['loss']:.4f} ppl {math.exp(min(f['nll'], 20)):.2f} "
                  f"gnorm {f['grad_norm']:.3f} lr {f['lr']:.2e}", flush=True)
        return {}

    t0 = time.monotonic()
    if args.ckpt_dir:
        report = run_supervised(
            total_steps=args.steps,
            step_fn=one_step,
            state_provider=lambda: bridge.train_state_tree(holder["state"]),
            state_restorer=lambda tree, s: holder.__setitem__(
                "state", bridge.install_train_state_tree(holder["state"], tree)),
            ckpt_root=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            watchdog=StragglerWatchdog(),
        )
        print(f"supervisor: {report}")
    else:
        for step in range(args.steps):
            one_step(step)
    dt = time.monotonic() - t0
    tokens = args.steps * args.global_batch * args.seq_len
    last = holder["metrics"]
    final = f"{float(last['loss']):.4f}" if last is not None else "n/a (resumed at the end)"
    print(f"done: {args.steps} steps, {tokens / dt:.0f} tok/s, final loss {final}, "
          f"device {holder['state'].params.device}")


if __name__ == "__main__":
    main()
