#!/usr/bin/env python3
"""Dense serving of chip_smoke.py's phase 4 from one tree of the repo, for
comparing two commits on one card. Run from the repository root, one
process per tree, in turns (parent, change, change, parent), e.g. with
the parent unpacked into a gitignored directory:

  git archive <parent> | tar -x -C build/parent
  for t in build/parent . . build/parent; do python3 tools/serve_ab.py $t; done

Builds K3 and K6 only, serves internlm2-1.8b as phase 4 does (its checks,
launch counts and profiler split included) and prints one [ab] line with
decode tok/s, p50 / p95 per step, prefill tok/s and the peak memory.
"""
import os
import sys

root = os.path.abspath(sys.argv[1])
os.chdir(root)
sys.path.insert(0, root)
import chip_smoke as cs  # noqa: E402  (the tree's own chip_smoke and repro_torch)

sys.path.insert(0, os.path.join(root, "src"))
from repro_torch.kernels import build  # noqa: E402

build.build(["flash_attention_fwd", "flash_decode"])
_, stats, peak, _ = cs.phase_serving()
print(f"[ab] {sys.argv[1]}: decode {stats['decode_tok_s']:.1f} tok/s | p50 "
      f"{stats['p50_token_latency_ms']:.3f} ms | p95 {stats['p95_token_latency_ms']:.3f} ms | "
      f"prefill {stats['prefill_tok_s']:.1f} tok/s | peak {peak / 2**30:.3f} GiB")
