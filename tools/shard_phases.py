#!/usr/bin/env python3
"""chip_smoke.py's data-axis phases alone, after its phase 1: the sharded
wrappers against their plain versions (40), internlm2-1.8b served by one
engine whose page pools are split into per-replica shards of an
in-process data mesh (41; at full width cut to chip_smoke.SERVE_REPS,
as there), the wrappers' kernel rows, and granite-moe's
blocked MoE dispatch trained and decoded (42). For iterating on the data
axis without the earlier phases. Run from the repository root:

  python3 tools/shard_phases.py

Prints what those phases print, then the wrappers' kernel rows as JSON;
the first failure exits non-zero, as in chip_smoke.py.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
import chip_smoke  # noqa: E402  (it puts src/ on the path)

from repro_torch.configs import RunConfig  # noqa: E402

t0 = time.perf_counter()
smi, gen = chip_smoke.start()
rcfg = RunConfig(compute_dtype="bfloat16", param_dtype="bfloat16", policy_name="none")
dense = chip_smoke.cut_serving({"rcfg": rcfg})
errs = chip_smoke.phase_sharded_kernels(gen)
counts = chip_smoke.phase_sharded_serving(dense, smi)
rows = chip_smoke.sharded_rows(gen, counts, errs, smi)
del dense
chip_smoke.phase_moe_blocked(smi)
print(f"[done] {time.perf_counter() - t0:.1f} s")
print(json.dumps(rows))
