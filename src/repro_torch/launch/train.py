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

``--executor shard_map --data-model D 1 --mesh-context C`` trains on a
data x context mesh: the launcher starts ``D * C`` local ranks itself
(``launch.ranks``; gloo, every rank on the same card when there is one
card), each running the mesh executor (``train.distributed``: its batch
and zigzag sequence slice, the ring over K3-K5, gradients averaged or,
with ``--grad-compress int8_ef``, through the int8 error-feedback
all-reduce, AdamW under ZeRO-1)::

  python -m repro_torch.launch.train --arch llama-tiny --device cpu --steps 4 \
      --seq-len 128 --global-batch 8 --compression 'attn.qkv=pamm(r=1/8)' \
      --executor shard_map --data-model 2 1 --mesh-context 2 --grad-compress int8_ef

``--data-model D M`` with ``M > 1`` adds the model (tensor-parallel)
axis: ``D * M`` ranks, each holding its slice of the heads, the FFN width
and the vocabulary, the Q/K/V, gate / up and head products
column-parallel and the out and down products row-parallel over the
model group, K3-K5 at the rank's head counts. Every block kind runs
there: a compressed ``ffn.down`` (row-parallel) through K1's split
route; a MoE block with its share of the experts (expert parallelism),
the batched K1 / K2 over them; an ssm block with its Mamba-2 heads, a rec
block with its RG-LRU width; an xattn block with its cross-attention
heads over the whole image rows (llama-3.2-vision); musicgen with its
share of each codebook's head columns; and ``--block-structure
reversible``::

  python -m repro_torch.launch.train --arch internlm2-1.8b_smoke --device cpu \
      --steps 4 --seq-len 64 --global-batch 4 --compression 'ffn.*=pamm(r=1/8)' \
      --executor shard_map --data-model 1 2
  python -m repro_torch.launch.train --arch granite-moe-3b-a800m_smoke --device cpu \
      --steps 4 --seq-len 64 --global-batch 4 \
      --compression 'attn.qkv=pamm(r=1/8);moe.expert=pamm(r=1/8)' \
      --executor shard_map --data-model 1 2
  python -m repro_torch.launch.train --arch llama-3.2-vision-11b_smoke --device cpu \
      --steps 4 --seq-len 32 --global-batch 4 \
      --compression 'attn.qkv=pamm(r=1/8);attn.cross_kv=pamm(r=1/8)' \
      --executor shard_map --data-model 1 2

Without ``--data-model`` the data degree is the number of cards over the
context degree (1 on the CPU), as the JAX launcher puts every device on
the data axis. Still refused, with the later slice named: a model degree
above 1 together with ``--mesh-context`` above 1, adafactor or
``--grad-compress int8_ef`` (``runtime.sharding``), and ``--ckpt-dir``
under a mesh.
"""
from __future__ import annotations

import argparse
import math
import time

from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config
from repro_torch.data import SyntheticStream
from repro_torch.launch.mesh import Mesh, make_debug_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.blocks import resolve_block_structure
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.fault import StragglerWatchdog, run_supervised
from repro_torch.train import (init_distributed_state, init_train_state,
                               make_shard_map_train_step, make_train_step)

LATER_SLICE_CKPT = ("--ckpt-dir under a mesh: checkpoints of sharded state (the "
                    "ZeRO-1 moments, shardings=) arrive with the port's "
                    "checkpoint-shardings slice")
RANK_TIMEOUT = 1800.0       # seconds a collective may wait for the other ranks


def _check_flags(ap, args) -> None:
    """The JAX launcher's flag rules, plus what the port still refuses."""
    if args.mesh_context > 1 and args.executor != "shard_map":
        ap.error("--mesh-context > 1 needs --executor shard_map (the ring's "
                 "ppermute collectives require the manual context axis)")
    if args.executor == "shard_map":
        if args.data_model is not None and args.data_model[1] > 1 and args.mesh_context > 1:
            ap.error(f"--data-model with --mesh-context: {sh.LATER_SLICE_TP_CONTEXT}")
        if args.ckpt_dir:
            ap.error(LATER_SLICE_CKPT)
        return
    if args.data_model is not None:
        ap.error("--data-model needs --executor shard_map: the port's jit executor "
                 "is one process on one device")
    if args.grad_compress != "none":
        ap.error("--grad-compress is only honored by the shard_map executor "
                 "(--executor shard_map); the jit executor would silently train "
                 "uncompressed")


def _run_config(args) -> RunConfig:
    return RunConfig(compression=args.compression, policy_name=args.policy,
                     pamm_ratio=1.0 / args.ratio, lr=args.lr,
                     block_structure=args.block_structure,
                     grad_compress=args.grad_compress)


def _log(step: int, m: dict) -> None:
    f = {k: float(v) for k, v in m.items()}
    print(f"step {step:6d} loss {f['loss']:.4f} ppl {math.exp(min(f['nll'], 20)):.2f} "
          f"gnorm {f['grad_norm']:.3f} lr {f['lr']:.2e}", flush=True)


def _train_rank(rank: int, world: int, args, shape) -> dict:
    """One rank of the mesh run: trains, logs from rank 0, returns its last
    metrics, its device and its transport's counts."""
    import torch

    cfg = get_config(args.arch)
    rcfg = _run_config(args)
    mesh = make_debug_mesh(*shape, timeout=RANK_TIMEOUT)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
    state = init_distributed_state(cfg, rcfg, mesh, device=device)
    step_fn = make_shard_map_train_step(cfg, rcfg, total_steps=args.steps, mesh=mesh)
    stream = SyntheticStream.for_arch(cfg, args.seq_len, args.global_batch)
    m = None
    for step in range(args.steps):
        state, m = step_fn(state, stream.get_batch(step), step)
        if rank == 0 and (step % args.log_every == 0 or step == args.steps - 1):
            _log(step, m)
    return {"metrics": {k: float(v) for k, v in m.items()}, "device": str(device),
            "comm": mesh.comm.stats()}


def _main_mesh(ap, args) -> None:
    import torch

    cp = max(1, args.mesh_context)
    model = args.data_model[1] if args.data_model else 1
    n_dev = torch.cuda.device_count() if args.device.startswith("cuda") else 1
    data = args.data_model[0] if args.data_model else max(1, n_dev // cp)
    shape = (data, model, cp)
    cfg, rcfg = get_config(args.arch), _run_config(args)
    abstract = Mesh(("data", "model", "context"), shape)
    try:
        sh.validate_batch_divisible(args.global_batch, abstract,
                                    grad_accum=rcfg.grad_accum, where="launch")
        sh.validate_seq_divisible(args.seq_len, abstract, where="launch")
        resolve_block_structure(cfg, rcfg, cp=cp)
        sh.validate_tensor_parallel(cfg, rcfg, model)
    except (ValueError, NotImplementedError) as e:
        ap.error(str(e))
    t0 = time.monotonic()
    out = run_ranks(data * model * cp, _train_rank, args, shape, timeout=RANK_TIMEOUT,
                    deadline=math.inf)
    dt = time.monotonic() - t0
    tokens = args.steps * args.global_batch * args.seq_len
    axes = f"data {data} x model {model}" if model > 1 else f"data {data} x context {cp}"
    print(f"done: {args.steps} steps on {data * model * cp} ranks ({axes}), "
          f"{tokens / dt:.0f} tok/s, final loss {out[0]['metrics']['loss']:.4f}, "
          f"device {out[0]['device']}, bytes between card and host (rank 0) "
          f"{out[0]['comm']['host_bytes']}")


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
                    metavar=("DATA", "MODEL"),
                    help="mesh shape (shard_map executor): DATA x MODEL ranks; MODEL > 1 "
                         "is tensor parallelism over the model axis")
    ap.add_argument("--mesh-context", type=int, default=1,
                    help="context-parallel (ring attention) degree: the sequence "
                         "zigzag-shards over this many ranks (shard_map executor; "
                         "seq-len must divide by 2x this)")
    ap.add_argument("--executor", default="jit", choices=["jit", "shard_map"],
                    help="jit = one process on one device; shard_map = one local "
                         "rank per (data, context) coordinate (train/distributed.py): "
                         "per-rank fwd/bwd, gradient all-reduce (optionally int8-EF "
                         "compressed), ZeRO-1 AdamW")
    ap.add_argument("--grad-compress", default="none", choices=["none", "int8_ef"],
                    help="gradient all-reduce compression (shard_map executor only)")
    ap.add_argument("--block-structure", default="residual",
                    choices=["residual", "reversible"],
                    help="reversible = two-stream blocks whose backward rebuilds "
                         "the residual stream instead of saving it (attn/swa/latt/"
                         "moe/rec kinds, not ssm; excludes remat, see models/blocks.py)")
    args = ap.parse_args(argv)
    _check_flags(ap, args)
    if args.executor == "shard_map":
        _main_mesh(ap, args)
        return

    cfg = get_config(args.arch)
    rcfg = _run_config(args)
    stream = SyntheticStream.for_arch(cfg, args.seq_len, args.global_batch)
    step_fn = make_train_step(cfg, rcfg, total_steps=args.steps)
    holder = {"state": init_train_state(cfg, rcfg, device=args.device), "metrics": None}

    def one_step(step: int):
        holder["state"], m = step_fn(holder["state"], stream.get_batch(step), step)
        holder["metrics"] = m
        if step % args.log_every == 0 or step == args.steps - 1:
            _log(step, m)
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
