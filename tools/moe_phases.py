#!/usr/bin/env python3
"""chip_smoke.py's MoE phases alone (its ``run_moe_phases``: 14-17, the
batched K1 / K2 and granite's K3-K7 against their plain versions,
granite-moe-3b-a800m served and trained, granite smoke card against CPU,
the MoE kernel rows), after its phase 1, for iterating on the MoE path
without the earlier phases. Run from the repository root:

  python3 tools/moe_phases.py

Prints what those phases print, then the MoE kernel rows as JSON; the
first failure exits non-zero, as in chip_smoke.py.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
import chip_smoke  # noqa: E402  (it puts src/ on the path)

t0 = time.perf_counter()
smi, gen = chip_smoke.start()
_, rows = chip_smoke.run_moe_phases(gen, smi)
print(f"[done] {time.perf_counter() - t0:.1f} s")
print(json.dumps(rows))
