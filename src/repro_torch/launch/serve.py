"""Continuous-batching serving entry point of the port (twin of
``repro/launch/serve.py``).

  python -m repro_torch.launch.serve --arch internlm2-1.8b --device cuda \
      --dtype bfloat16 --batch 8 --requests 16 --prompt-len 1024 --gen 64

Requests get staggered prompt lengths so admissions and evictions overlap
mid-stream. Weights are random-initialised from ``--seed`` on the chosen
device. ``--smoke`` runs the workload twice and asserts identical outputs
and tok/s > 0. ``--compression`` routes prefill through the plan's sites
(exact outputs). ``--cache-layout paged`` serves from page pools
(``--page-size``, ``--pool-tokens``), ``--cache-compress`` stores them as
int8 / int4 / svd, ``--prefix-share`` shares prompt pages copy-on-write and
``--speculative-k`` verifies k drafted tokens per call:

  python -m repro_torch.launch.serve --arch internlm2-1.8b_smoke --device cpu \
      --cache-layout paged --cache-compress int8 --smoke

``--replicas N`` serves through the serving front instead of one engine: a
``serve.Router`` over N decode replicas on the one device (each with
``--batch`` slots and its own page pools, all sharing the weights) with
page-aware least-loaded admission; ``--dedicated-prefill`` adds a 1-slot
prefill engine whose Prefixes cross to the decode replicas in host form
(refused without ``--replicas``). Its ``router:`` line gives decode tokens
over the run's wall as the rate, beside the reference's ``decode_tok_s``,
which counts the replicas' walls as overlapping though they step in turn:

  python -m repro_torch.launch.serve --arch internlm2-1.8b_smoke --device cpu \
      --cache-layout paged --replicas 2 --dedicated-prefill --smoke

``--mesh-data`` (one engine's pools sharded over cards) is refused, naming
the multi-GPU slice that brings it.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.configs import RunConfig, get_config
from repro_torch.data import SyntheticStream
from repro_torch.models import init_model
from repro_torch.serve import Request, Router, SamplingParams, ServeEngine


def _build_requests(cfg, args) -> list[Request]:
    stream = SyntheticStream.for_arch(cfg, args.prompt_len, args.requests)
    batch = stream.get_batch(0)
    requests = []
    for i in range(args.requests):
        # stagger prompt lengths so requests join/leave mid-stream
        lp = max(4, args.prompt_len - 3 * (i % 4))
        requests.append(Request(
            uid=i,
            tokens=np.asarray(batch["tokens"][i][:lp]).tolist(),
            max_new_tokens=args.gen,
            sampling=SamplingParams(temperature=args.temperature,
                                    top_k=args.top_k, seed=args.seed + i),
        ))
    return requests


def _make_engine(cfg, rcfg, model, args, *, slots=None) -> ServeEngine:
    return ServeEngine(cfg, rcfg, model, max_slots=slots or args.batch,
                       max_len=args.prompt_len + args.gen + 1,
                       decode_block=args.decode_block,
                       cache_layout=args.cache_layout, page_size=args.page_size,
                       pool_tokens=args.pool_tokens or None,
                       cache_compress=args.cache_compress,
                       prefix_share=args.prefix_share,
                       speculative_k=args.speculative_k)


def _serve_once(cfg, rcfg, model, args):
    if args.replicas > 1:
        replicas = [_make_engine(cfg, rcfg, model, args) for _ in range(args.replicas)]
        pf = (_make_engine(cfg, rcfg, model, args, slots=1)
              if args.dedicated_prefill else None)
        router = Router(replicas, prefill_engine=pf)
        t0 = time.perf_counter()
        results = router.run(_build_requests(cfg, args))
        # the replicas step one after another on this thread, so the rate
        # users get is decode tokens over the run's wall, not stats()'s
        # decode_tok_s (which takes the largest replica wall alone)
        return results, {**router.stats(), "run_s": time.perf_counter() - t0}
    engine = _make_engine(cfg, rcfg, model, args)
    results = engine.run(_build_requests(cfg, args))
    return results, engine.stats()


def _refuse_later_slices(ap, args) -> None:
    if args.mesh_data > 1:
        ap.error("--mesh-data: mesh data arrives with the port's multi-GPU slice")
    if args.dedicated_prefill and args.replicas <= 1:
        ap.error("--dedicated-prefill needs --replicas > 1")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises if there is no card) or cpu")
    ap.add_argument("--batch", type=int, default=4, help="engine slots")
    ap.add_argument("--requests", type=int, default=0,
                    help="total requests (default: 2x batch)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--decode-block", type=int, default=8,
                    help="decode tokens per generate() call (one host sync)")
    ap.add_argument("--cache-layout", default="dense", choices=["dense", "paged"])
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pool-tokens", type=int, default=0)
    ap.add_argument("--cache-compress", default="")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--compression", default="")
    ap.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0, help="0 = full vocab")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="decode replicas behind a serve.Router (each gets --batch "
                         "slots and its own page pools)")
    ap.add_argument("--dedicated-prefill", action="store_true",
                    help="with --replicas: prefill on a separate engine and hand "
                         "Prefixes to decode replicas in host form")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--prefix-share", action="store_true")
    ap.add_argument("--speculative-k", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="run twice, assert determinism and tok/s > 0")
    args = ap.parse_args(argv)
    _refuse_later_slices(ap, args)
    if not args.requests:
        args.requests = 2 * args.batch

    cfg = get_config(args.arch)
    rcfg = RunConfig(compute_dtype=args.dtype, param_dtype=args.dtype,
                     policy_name="none", compression=args.compression)
    model = init_model(cfg, rcfg, seed=args.seed, device=args.device)

    results, stats = _serve_once(cfg, rcfg, model, args)
    for uid in sorted(results):
        r = results[uid]
        print(f"req {uid}: prompt={r.prompt_len} new={len(r.tokens)} "
              f"finish={r.finish_reason} {r.decode_tok_s:.1f} tok/s "
              f"sample={r.tokens[:8]}")
    if args.replicas > 1:
        print(f"router: {stats['replicas']} replicas"
              + (" + dedicated prefill" if stats["dedicated_prefill"] else "")
              + f" | prefill {stats['prefill_tok_s']:.1f} tok/s | "
              f"decode {stats['decode_tokens'] / stats['run_s']:.1f} tok/s wall aggregate "
              f"({stats['decode_tokens']} tokens / {stats['run_s']:.3f} s of run) | "
              f"reference decode_tok_s {stats['decode_tok_s']:.1f} (summed tokens / "
              f"largest replica decode wall; the replicas do not overlap here) | "
              f"peak aggregate concurrency {stats['peak_active_aggregate']} | "
              f"peak reserved {stats['peak_kv_reserved_bytes'] / 2**20:.2f} MB | "
              f"device {model.device}")
    else:
        _print_engine_stats(args, stats, model.device)

    if args.smoke:
        again, _ = _serve_once(cfg, rcfg, model, args)
        if not all(again[u].tokens == results[u].tokens for u in results):
            print("SMOKE FAIL: outputs not deterministic", file=sys.stderr)
            sys.exit(1)
        if not (stats["decode_tok_s"] > 0 and stats["prefill_tok_s"] > 0):
            print("SMOKE FAIL: zero throughput", file=sys.stderr)
            sys.exit(1)
        print("SMOKE OK")


def _print_engine_stats(args, stats, device) -> None:
    print(f"prefill {stats['prefill_tok_s']:.1f} tok/s | "
          f"decode {stats['decode_tok_s']:.1f} tok/s | "
          f"p50 {stats['p50_token_latency_ms']:.2f} ms | "
          f"p95 {stats['p95_token_latency_ms']:.2f} ms | "
          f"cache {stats['cache_slot_bytes'] / 1e6:.2f} MB/slot")
    print(f"[{args.cache_layout}] kv capacity "
          f"{stats['cache/kv_capacity_mb']:.2f} MB | peak reserved "
          f"{stats['peak_kv_reserved_bytes'] / 2**20:.2f} MB | peak used "
          f"{stats['peak_kv_used_bytes'] / 2**20:.2f} MB | "
          f"peak concurrency {stats['peak_active']} | "
          f"replica shards {stats['replica_shards']} | "
          f"compression x{stats['cache/kv_compression_x']:.2f} | "
          f"{stats['prefill_buckets']} prefill buckets | "
          f"device {device}")
    if args.prefix_share:
        print(f"[prefix-share] hits {stats['prefix_hits']} | pages adopted "
              f"{stats['prefix_pages_adopted']} | cow splits {stats['cow_page_splits']} "
              f"| retired prefixes kept {stats['retired_prefixes']}")
    if args.speculative_k:
        print(f"[speculative k={args.speculative_k}] verify calls "
              f"{stats['spec_verify_calls']} | drafted {stats['spec_tokens_drafted']} | "
              f"accepted {stats['spec_tokens_accepted']} | accept rate "
              f"{stats['spec_accept_rate']:.2f}")


if __name__ == "__main__":
    main()
