#!/usr/bin/env python3
"""How far a granite-moe training step under expert parallelism parts from
the single-process step when both see the same data, and why: the router
sends a few tokens to other experts when its input differs in the last
bits. Run from the repository root, on a card:

  python3 tools/ep_flips.py [--layers N] [--dtype float32|bfloat16]

Two gloo ranks share cuda:0 (``launch.ranks``). Rank 0 first takes the
single-process gradients of one step of ``granite-moe-3b-a800m`` at full
width cut to N layers (default 2), 4 x 2048 tokens, exact compression,
remat 'none', vocabulary padded to a multiple of 128; then both ranks take
the same step with the experts over the model axis. Every MoE call
records its input, its output and its routing. Printed, per MoE layer:
the input's and the output's relative difference, the tokens whose top-k
experts differ, and the smallest relative gap between the 8th and 9th
router probabilities; then each gradient's relative difference (the
ranks' slices gathered).
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src")))

import torch  # noqa: E402

CALLS: list = []


def _record():
    """Wrap ``models.moe``'s ``moe_ffn`` and ``route`` to record each call."""
    from repro_torch.models import blocks, moe

    ffn, route = moe.moe_ffn, moe.route

    def moe_ffn(params, x, cfg, **kw):
        out, aux = ffn(params, x, cfg, **kw)
        CALLS.append({"x": x.detach().float().cpu(), "out": out.detach().float().cpu()})
        return out, aux

    def routed(router, x2d, k):
        probs, gate_w, gate_i = route(router, x2d, k)
        CALLS.append({"gate_i": gate_i.cpu(), "probs": probs.detach().float().cpu()})
        return probs, gate_w, gate_i

    moe.moe_ffn = blocks.moe_lib.moe_ffn = moe_ffn
    moe.route = routed


def rank_main(rank, world, layers, dtype):
    import torch.distributed as dist

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.keys import Key
    from repro_torch.core.plan import resolve_for_run
    from repro_torch.data import SyntheticStream
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_model
    from repro_torch.models.model import _padded_vocab
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.collectives import gather_model_
    from repro_torch.train import init_distributed_state
    from repro_torch.train.distributed import make_shard_map_grads
    from repro_torch.train.train_step import batch_to_device, loss_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    _record()
    mesh = make_debug_mesh(1, 2, timeout=600)
    cfg = get_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg, stages=((("moe",), layers),), n_layers=layers)
    rcfg = RunConfig(compression="", policy_name="none", remat="none", compute_dtype=dtype,
                     pad_vocab_multiple=128)
    batch = SyntheticStream.for_arch(cfg, 2048, 4, seed=rcfg.seed).get_batch(1)
    single = None
    if rank == 0:
        model = init_model(cfg, rcfg, seed=rcfg.seed, device="cuda")
        loss, _, g = loss_and_grad(cfg, rcfg, resolve_for_run(cfg, rcfg), model,
                                   batch_to_device(batch, "cuda"), Key(rcfg.seed).fold_in(1))
        single = (float(loss), list(CALLS), {n: t.float().cpu() for n, t in g.items()})
        CALLS.clear()
        del model, g
        torch.cuda.empty_cache()
    dist.barrier()
    state = init_distributed_state(cfg, rcfg, mesh, device="cuda")
    grads_fn = make_shard_map_grads(cfg, rcfg, mesh=mesh)
    loss, _, g = grads_fn.rank_grads(state.params, batch, 1)
    g, _ = grads_fn.sync_grads(g, None)
    v_pad, e_pad = _padded_vocab(cfg, rcfg), sh.padded_experts(cfg, rcfg)
    layout = sh.model_layout(g, cfg, v_pad, e_pad)
    g = gather_model_(g, layout, sh.make_model_group(mesh, cfg, rcfg, v_pad))
    if rank != 0:
        return None
    rel = lambda a, b: float((a - b).norm() / b.norm())
    lines = [f"loss: single {single[0]}, expert parallel {float(loss)}"]
    calls = list(zip(single[1], CALLS))
    for i in range(0, len(calls), 2):           # route, then the layer's output
        (ra, rb), (oa, ob) = calls[i], calls[i + 1]
        moved = (ra["gate_i"] != rb["gate_i"]).any(1)
        p = ra["probs"].sort(1, descending=True).values
        gap = (p[:, 7] - p[:, 8]) / p[:, 7]
        lines.append(f"MoE layer {i // 2}: input rel {rel(ob['x'], oa['x']):.2e}, output rel "
                     f"{rel(ob['out'], oa['out']):.2e}, tokens routed elsewhere "
                     f"{int(moved.sum())} of {moved.numel()}, smallest 8th / 9th probability "
                     f"gap {float(gap.min()):.2e} (relative)")
    lines.append("gradients, relative difference: " + ", ".join(
        f"{n} {rel(g[n].float().cpu(), single[2][n]):.2e}" for n in single[2]))
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("this probe needs an NVIDIA card")
    from repro_torch.launch.ranks import run_ranks

    print(torch.cuda.get_device_name(0), flush=True)
    for line in run_ranks(2, rank_main, args.layers, args.dtype, timeout=600)[0]:
        print(line, flush=True)


if __name__ == "__main__":   # the ranks re-import this file: run nothing then
    main()
